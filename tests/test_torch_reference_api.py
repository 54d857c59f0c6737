"""PyTorch port: the reference's per-stage API against the JAX package.

- ``viterbi_decoding`` (minimum durations by state duplication, forbidden
  and mandatory frames, ``initial``, ``reset``): states equal to the JAX
  package's, up to K = 12 states after the duplication.  On the CPU both
  run the same float32 operations in the same order, so equality is
  exact; on CUDA, K > 3 takes the general-K kernel (tests/test_torch_cuda.py).
- ``DnnSegmenter.__call__(mspec, lseg, difflen)`` of the smn and gender
  stages: lseg equal, on the same ``size="small"`` synthetic weights.
- ``dsp/vbx_host.py``: every function equal to the JAX package's (both
  numpy, so array-equal).
- ``Segmenter.timers`` and the JAX package's positional constructor
  order, with the port's own arguments keyword-only.
"""

import os

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu import segmenter as jseg
from inaspeechsegmenter_tpu import vfs as jvfs
from inaspeechsegmenter_tpu.decode import viterbi as jvit
from inaspeechsegmenter_tpu.dsp import vbx_host as jhost
from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxResNet
from inaspeechsegmenter_tpu_torch import Segmenter, VoiceFemininityScoring
from inaspeechsegmenter_tpu_torch import segmenter as tseg
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.decode import viterbi as tvit
from inaspeechsegmenter_tpu_torch.dsp import vbx_host as thost
from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import KernelSidekitFrontend
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from inaspeechsegmenter_tpu_torch.parallel import make_mesh
from inaspeechsegmenter_tpu_torch.utils.timing import StageTimers, torch_trace
from torch_parity_helpers import speechlike, to_int16

TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)


# -- viterbi_decoding ---------------------------------------------------------

def _decode_case(T, K, seed):
    rng = np.random.default_rng(seed)
    em = np.log(rng.dirichlet(np.ones(K) * 0.7, T))
    tr = np.log(rng.dirichlet(np.ones(K) * 3, K))
    return em, tr, rng


@pytest.mark.parametrize("K,consecutive", [
    (2, None), (3, 1), (2, 3), (3, [2, 1, 4]), (4, 3), (6, 2), (12, None),
    (3, [1, 5, 2])])
def test_viterbi_decoding_matches_jax(K, consecutive):
    em, tr, _ = _decode_case(400, K, seed=K * 10 + 1)
    want = np.asarray(jvit.viterbi_decoding(em, tr, consecutive=consecutive))
    got = tvit.viterbi_decoding(em, tr, consecutive=consecutive,
                                device="cpu")
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


@pytest.mark.parametrize("K", [2, 3, 5])
def test_viterbi_decoding_constraints_initial_reset(K):
    """Forbidden and mandatory frames, a peaked initial vector and resets,
    with and without the duplication."""
    T = 500
    em, tr, rng = _decode_case(T, K, seed=K)
    constraint = np.zeros((T, K), int)
    constraint[rng.random((T, K)) < 0.05] = tvit.VITERBI_CONSTRAINT_FORBIDDEN
    rows = rng.choice(T, 20, replace=False)
    constraint[rows, rng.integers(0, K, 20)] = \
        tvit.VITERBI_CONSTRAINT_MANDATORY
    initial = np.log(rng.dirichlet(np.ones(K)))
    reset = rng.random(T) < 0.02
    for consecutive in (None, 2, list(range(1, K + 1))):
        kw = dict(initial=initial, consecutive=consecutive,
                  constraint=constraint, reset=reset)
        want = np.asarray(jvit.viterbi_decoding(em, tr, **kw))
        got = tvit.viterbi_decoding(em, tr, device="cpu", **kw)
        np.testing.assert_array_equal(got, want)
        if consecutive is None:
            # no minimum duration: every mandatory frame is honoured
            t_m, k_m = np.nonzero(
                constraint == tvit.VITERBI_CONSTRAINT_MANDATORY)
            np.testing.assert_array_equal(got[t_m], k_m)


def test_expand_consecutive_matches_jax():
    em, tr, rng = _decode_case(50, 3, seed=5)
    ini = np.log([0.2, 0.3, 0.5])
    con = rng.integers(0, 3, (50, 3))
    got = tvit._expand_consecutive(em, tr, ini, con, np.array([2, 1, 3]))
    want = jvit._expand_consecutive(em, tr, ini, con, np.array([2, 1, 3]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tvit.LOG_ZERO == jvit.LOG_ZERO


@pytest.mark.parametrize("K", [4, 7, 30])
def test_viterbi_scan_past_three_states_matches_jax(K):
    """On the CPU both entries take the plain loop at any K; equal to the
    JAX scan, with resets and an all -inf frame."""
    em, tr, rng = _decode_case(300, K, seed=K)
    em = em.astype(np.float32)
    em[17] = -np.inf
    reset = rng.random(300) < 0.05
    reset[0] = True
    ini = np.full(K, np.log(1.0 / K), np.float32)
    want = np.asarray(jvit._viterbi_scan(em, tr.astype(np.float32), ini,
                                         reset))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        em, tr.astype(np.float32), ini, reset)]
    for fn in (tvit.viterbi_scan, tvit.viterbi_scan_general):
        np.testing.assert_array_equal(fn(*args).numpy(), want)


# -- DnnSegmenter.__call__ -----------------------------------------------------

@pytest.fixture(scope="module")
def mspec():
    sig = to_int16(speechlike(12.0, seed=31, silences=[(3.0, 3.6)]))
    m, _, t = KernelSidekitFrontend("cpu").mspec_loge(sig)
    return m.numpy(), t


def _stage_pair(name, model_dir):
    port = getattr(tseg, name)(32, False, device="cpu", model_dir=model_dir)
    jax = getattr(jseg, name)(32, False)
    return port, jax


@pytest.mark.parametrize("name,inlabel,other", [
    ("SpeechMusicNoise", "energy", "noEnergy"),
    ("SpeechMusic", "energy", "noEnergy"),
    ("Gender", "speech", "music")])
def test_dnn_segmenter_call_matches_jax(synthetic_model_dir, mspec, name,
                                        inlabel, other):
    m, t = mspec
    n20 = (t + 1) // 2
    # two adjacent in-label segments: each decodes on its own
    lseg = [(inlabel, 0, 100), (other, 100, 160), (inlabel, 160, 300),
            (inlabel, 300, n20)]
    port, jax = _stage_pair(name, synthetic_model_dir)
    assert port.device.type == "cpu"
    got = port(m, lseg)
    want = jax(m, lseg)
    assert got == want
    assert {lab for lab, _, _ in got} - {other} <= set(port.outlabels)
    assert got[0][1] == 0 and got[-1][2] == n20
    assert port(torch.from_numpy(m), lseg) == got


def test_dnn_segmenter_call_short_media(synthetic_model_dir):
    """A 0.5 s file: the mel rows padded to 68 with their min, difflen."""
    sig = to_int16(speechlike(0.5, seed=4))
    m, _, t = KernelSidekitFrontend("cpu").mspec_loge(sig)
    with pytest.warns(UserWarning):
        padded, difflen = tseg.short_media_pad(m, t, "<short>")
    assert difflen == 68 - t > 0
    n20 = (68 + 1) // 2 - int(difflen / 2)
    lseg = [("energy", 0, n20)]
    port, jax = _stage_pair("SpeechMusicNoise", synthetic_model_dir)
    got = port(padded.numpy(), lseg, difflen)
    assert got == jax(padded.numpy(), lseg, difflen)
    assert got[-1][2] == n20


# -- dsp/vbx_host.py ------------------------------------------------------------

def test_vbx_host_functions_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal(4000)
    np.testing.assert_array_equal(thost.framing(x, 400, 160),
                                  jhost.framing(x, 400, 160))
    x2 = rng.standard_normal((50, 3))
    np.testing.assert_array_equal(thost.framing(x2, 7, 2),
                                  jhost.framing(x2, 7, 2))
    fr = thost.framing(x, 400, 160)
    np.testing.assert_array_equal(thost.preemphasis(fr), jhost.preemphasis(fr))
    np.random.seed(3)
    a = thost.add_dither(x)
    np.random.seed(3)
    np.testing.assert_array_equal(a, jhost.add_dither(x))
    from inaspeechsegmenter_tpu_torch.dsp.mel import kaldi_mel_fbank

    fb = kaldi_mel_fbank(400, 16000, numchans=64, lofreq=20.0, hifreq=7600,
                         htk_bug=False)
    sig = rng.standard_normal(16000) * 1000
    for kw in (dict(USEPOWER=True, ZMEANSOURCE=True),
               dict(_E="first", RAWENERGY=False),
               dict(_E="last", ENORMALISE=False, USEHAMMING=False)):
        np.testing.assert_array_equal(
            thost.fbank_htk(sig, thost.povey_window(400), 240, fb, **kw),
            jhost.fbank_htk(sig, jhost.povey_window(400), 240, fb, **kw))
    fea = rng.standard_normal((700, 5))
    for norm_vars in (False, True):
        np.testing.assert_array_equal(
            thost.cmvn_floating_kaldi(fea, 150, 149, norm_vars),
            jhost.cmvn_floating_kaldi(fea, 150, 149, norm_vars))
    s = to_int16(speechlike(3.0, seed=9)).astype(np.float64) / 32768
    np.testing.assert_array_equal(thost.get_features(s),
                                  jhost.get_features(s))


# -- timers and constructors ----------------------------------------------------

def test_segmenter_timers_count_the_three_stages(synthetic_model_dir,
                                                 tmp_path):
    seg = Segmenter("smn", True, None, device="cpu",
                    model_dir=synthetic_model_dir)
    assert set(seg.timers.summary()) == {"decode", "features", "segment"}
    wav = str(tmp_path / "t.wav")
    write_wav(wav, to_int16(speechlike(4.0, seed=2)), 16000)
    seg(wav)
    seg.segment_signal(to_int16(speechlike(2.0, seed=3)))
    summ = seg.timers.summary()
    assert {k: v["calls"] for k, v in summ.items()} == {
        "decode": 1, "features": 2, "segment": 2}
    assert all(v["total_s"] > 0 for v in summ.values())
    seg.timers.reset()
    assert all(v["calls"] == 0 for v in seg.timers.summary().values())
    t = StageTimers("a")
    with t.time("a"):
        pass
    assert t.summary()["a"]["calls"] == 1
    with torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    assert prof.key_averages()


def test_reference_positional_constructor_order(synthetic_model_dir):
    """The JAX package's positional order; ``device`` and ``model_dir``
    keyword-only."""
    d = synthetic_model_dir
    seg = Segmenter("smn", False, None, 64, 0.05, False, device="cpu",
                    model_dir=d)
    assert (seg.ffmpeg, seg.batch_size, seg.energy_ratio) == (None, 64, 0.05)
    assert seg.vad.batch_size == 64 and seg.vad.device.type == "cpu"
    with pytest.raises(TypeError):
        Segmenter("smn", False, None, 64, 0.05, False, "cpu")
    stage = tseg.Gender(16, False, device="cpu", model_dir=d)
    assert stage.batch_size == 16
    with pytest.raises(TypeError):
        tseg.Gender(16, False, "cpu")
    params = JaxResNet(*TINY).init_params(seed=1)
    vfs = VoiceFemininityScoring("bgc", "onnx", False, params,
                                 ResNetXVector(*TINY), None, device="cpu",
                                 model_dir=d)
    assert vfs.ffmpeg is None and vfs.vad_thresh == 0.7
    for backend in ("jax", "pytorch"):
        VoiceFemininityScoring("vfp", backend, ffmpeg=None, device="cpu",
                               model_dir=d, xvector_net=ResNetXVector(*TINY),
                               xvector_params=params)
    with pytest.raises(ValueError, match="backend"):
        VoiceFemininityScoring("bgc", "tensorflow", ffmpeg=None,
                               device="cpu", model_dir=d)
    mesh = make_mesh(devices=["cpu"] * 2)
    vfs = VoiceFemininityScoring("bgc", "jax", False, params,
                                 ResNetXVector(*TINY), None, mesh,
                                 device="cpu", model_dir=d)
    assert vfs.xvector_model.mesh is mesh
    assert len(vfs.xvector_model.replicas) == 2
    with pytest.raises(TypeError):
        VoiceFemininityScoring("bgc", "jax", False, params,
                               ResNetXVector(*TINY), None, None, "cpu")
    # the JAX package takes the same positional call
    jvfs.VoiceFemininityScoring("bgc", "onnx", False, params,
                                JaxResNet(*TINY), None)
