"""PyTorch port: the overlapped speculative VFS scorer.

The overlapped scorer (``vfs.py::_score_signal_overlapped``) changes only
the schedule: ResNet sub-batches of provisionally selected windows are
queued behind each feature group, the exact decoded timeline makes the
final selection, misses are caught up and extras dropped.  So its tuple
equals the serial ``score_signal``'s exactly, on the int16 grid forced on
the CPU (``int16_grid_on_cpu``), whatever the provisional masks.  The
port takes it with ``ISS_VFS_OVERLAP=1`` (the JAX package with any value
but ``0``); its default ``auto`` takes the serial schedule.

Against the JAX package's overlapped scorer (``ISS_VBX_UPLOAD=int16``):
``speech_duration`` and ``nb_vectors`` equal, the score within 1e-5; the
provisional masks of ``_prov_step`` equal on the same emissions; the
speculative window counts (dispatched, needed, caught up) equal on the
tested seeds.  The tiny x-vector net of tests/test_vfs_overlap.py, weights
carried across; the small synthetic CNN/MLP weights.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu import vfs as jvfs
from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxResNet
from inaspeechsegmenter_tpu_torch import OnlineVFS, VoiceFemininityScoring
from inaspeechsegmenter_tpu_torch import vfs as tvfs
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK, HOP
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from torch_parity_helpers import int16_grid_on_cpu, to_int16, voiced

TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)

# seed -> samples: 150 s is 4 feature chunks in 2 upload groups; the other
# length fills its 4 chunks' frames but ends 30 samples past their
# samples, so the shared PCM grows by a fifth chunk
SIGNALS = {5: 150 * 16000, 9: (4 * CHUNK + 2) * HOP + 30}
DILATIONS = {"0": "0", "12": "12", "full": "100000"}


def signal(seed):
    n = SIGNALS[seed]
    sec = n / 16000
    return to_int16(voiced(sec, seed, silences=[(20.0, 23.0),
                                                (sec / 2, sec / 2 + 1.5),
                                                (sec - 9.0, sec - 8.2)]))


@pytest.fixture(autouse=True)
def grid(monkeypatch):
    monkeypatch.setenv("ISS_VFS_OVERLAP", "1")
    monkeypatch.delenv("ISS_VFS_PROV_DILATE", raising=False)
    int16_grid_on_cpu(monkeypatch)


@pytest.fixture(scope="module")
def xparams():
    return JaxResNet(*TINY).init_params(seed=7)


@pytest.fixture(scope="module")
def port_vfs(synthetic_model_dir, xparams):
    return VoiceFemininityScoring(
        "vfp", ffmpeg=None, device="cpu", model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY), xvector_params=xparams)


@pytest.fixture(scope="module")
def jax_vfs(synthetic_model_dir, xparams):
    return jvfs.VoiceFemininityScoring(
        "vfp", allow_download=False, ffmpeg=None,
        xvector_net=JaxResNet(*TINY), xvector_params=xparams)


@pytest.fixture(scope="module")
def serial():
    """seed -> the port's serial tuple, computed once."""
    return {}


def serial_result(port_vfs, serial, seed, monkeypatch):
    if seed not in serial:
        monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
        serial[seed] = port_vfs.score_signal(signal(seed), f"s{seed}")
        monkeypatch.setenv("ISS_VFS_OVERLAP", "1")
    return serial[seed]


def overlapped(vfs, sig, name):
    """score_signal through the overlapped path, asserted taken."""
    vfs.overlap_stats = None
    got = vfs.score_signal(sig, name)
    assert vfs.overlap_stats is not None, "the serial path was taken"
    return got


# -- exact against the serial path ---------------------------------------------

@pytest.mark.parametrize("dilate", sorted(DILATIONS))
@pytest.mark.parametrize("seed", sorted(SIGNALS))
def test_overlap_equals_serial(port_vfs, serial, monkeypatch, seed, dilate):
    want = serial_result(port_vfs, serial, seed, monkeypatch)
    assert want[0] is not None and want[2] > 0
    monkeypatch.setenv("ISS_VFS_PROV_DILATE", DILATIONS[dilate])
    sig = signal(seed)
    assert port_vfs._overlap_eligible()
    assert port_vfs._overlap_eligible_signal(sig)
    assert overlapped(port_vfs, sig, f"s{seed}") == want
    st = port_vfs.overlap_stats
    assert st["needed"] > 0 and st["dispatched"] > 0
    if dilate == "full":
        # every window is speculated on, but for those whose midpoint
        # lies in the last chunk: it has no right halo, so no provisional
        # mask
        n_chunks = sum(len(c) for c, _ in port_vfs.vad.frontend
                       .iter_group_feats(sig, keep_pcm=True))
        starts = np.arange(0, (len(sig) - 80) // 160 + 1 - 144, 24)
        in_last = int(((starts + 72) // 2 >= (n_chunks - 1) * CHUNK // 2)
                      .sum())
        assert st["caught_up"] <= in_last
        assert st["dispatched"] >= st["needed"] - st["caught_up"]


@pytest.mark.parametrize("seed", sorted(SIGNALS))
def test_overlap_equals_serial_catch_up_only(port_vfs, serial, monkeypatch,
                                             seed):
    """Every provisional mask false: nothing is speculated, every needed
    window is caught up, and the tuple is the serial one."""
    want = serial_result(port_vfs, serial, seed, monkeypatch)
    real = tvfs._prov_step

    def never(pipe, s, cnt, probs_v, loge_c):
        s, cnt, mask = real(pipe, s, cnt, probs_v, loge_c)
        return s, cnt, mask & False

    monkeypatch.setattr(tvfs, "_prov_step", never)
    monkeypatch.setenv("ISS_VFS_PROV_DILATE", "0")
    assert overlapped(port_vfs, signal(seed), f"s{seed}") == want
    st = port_vfs.overlap_stats
    assert st["dispatched"] == 0 and st["caught_up"] == st["needed"] > 0


# -- against the JAX package's overlapped scorer -------------------------------

def jax_overlapped(jax_vfs, sig, name, monkeypatch):
    """The JAX overlapped tuple and its session's window counts."""
    sessions = []

    class Spy(jvfs._EmbedSession):
        def __init__(self, xm):
            super().__init__(xm)
            sessions.append(self)

        def collect(self, fea, needed_starts):
            self.needed = list(needed_starts)
            done = {s for b, _ in self.batches for s in b}
            self.caught_up = sum(s not in done for s in self.needed)
            return super().collect(fea, needed_starts)

    monkeypatch.setattr(jvfs, "_EmbedSession", Spy)
    assert jax_vfs._overlap_eligible()
    got = jax_vfs.score_signal(sig, name)
    (sess,) = sessions
    return got, {"dispatched": sess.n_speculative,
                 "needed": len(getattr(sess, "needed", [])),
                 "caught_up": getattr(sess, "caught_up", 0)}


@pytest.mark.parametrize("seed", sorted(SIGNALS))
def test_overlap_matches_jax_overlap(port_vfs, jax_vfs, monkeypatch, seed):
    """Tuple and speculative counts.  The counts could differ only where a
    provisional decode meets a near-tie (CNN emissions agree to ~1e-6):
    none does on these seeds, so they are equal."""
    sig = signal(seed)
    got = overlapped(port_vfs, sig, f"s{seed}")
    want, counts = jax_overlapped(jax_vfs, sig, f"s{seed}", monkeypatch)
    assert got[1:] == want[1:]
    assert abs(got[0] - want[0]) <= 1e-5
    assert port_vfs.overlap_stats == counts
    assert counts["needed"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prov_step_matches_jax(port_vfs, jax_vfs, seed):
    """Three chunks in a row through both ``_prov_step``s (running sums
    carried): the masks and counts equal; the sums are float32 sums in
    another order, within 1e-6 of the sum of the magnitudes."""
    rng = np.random.default_rng(seed)
    pj, pt = jax_vfs.vad.pipeline, port_vfs.vad.pipeline
    sj = cj = np.float32(0)
    st = ct = torch.zeros((), dtype=torch.float32)
    n_speech, magnitude = 0, 0.0
    for c in range(3):
        level = rng.uniform(-4, 4, CHUNK // 64).repeat(64)
        loge = (level + 0.3 * rng.standard_normal(CHUNK)).astype(np.float32)
        loge[rng.random(CHUNK) < 0.02] = -np.inf      # digital silence
        probs = rng.dirichlet([0.6, 0.3, 0.3], CHUNK // 2).astype(np.float32)
        sj, cj, mj = jvfs._prov_step(pj, sj, cj, probs, loge,
                                     np.float32(0.03))
        st, ct, mt = tvfs._prov_step(pt, st, ct, torch.from_numpy(probs),
                                     torch.from_numpy(loge))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert float(ct) == float(cj)
        magnitude += float(np.abs(loge[np.isfinite(loge)]).sum())
        assert abs(float(st) - float(sj)) <= 1e-6 * magnitude
        n_speech += int(mt.sum())
    assert 0 < n_speech < 3 * CHUNK // 2


# -- the pieces ---------------------------------------------------------------

def test_group_pcm_tiles_the_signal(port_vfs):
    """``iter_group_feats(keep_pcm=True)``: each group's int16 PCM, its
    2*HOP lookahead stripped, tiles the signal (grown by a chunk when its
    last samples fall past the chunks), equal to the JAX groups'; the
    features are those of ``keep_pcm=False``; a float signal keeps none."""
    from inaspeechsegmenter_tpu.dsp.sidekit import SidekitFrontend

    fe = port_vfs.vad.frontend
    for seed in sorted(SIGNALS):
        sig = signal(seed)
        groups = list(fe.iter_group_feats(sig, keep_pcm=True))
        plain = list(fe.iter_group_feats(sig))
        jax_groups = list(SidekitFrontend().iter_group_feats(
            sig, keep_pcm=True))
        n_chunks = sum(len(c) for c, _ in groups)
        grown = n_chunks > sum(len(c) for c, _ in plain)
        assert grown == (seed == 9)
        assert n_chunks == sum(len(c) for c, _ in jax_groups)
        pcm = np.concatenate([p.numpy()[:len(p) - 2 * HOP]
                              for _, p in groups[:-1]]
                             + [groups[-1][1].numpy()])
        assert len(pcm) >= len(sig)
        np.testing.assert_array_equal(pcm[:len(sig)], sig)
        assert not pcm[len(sig):].any()
        for (_, p), (_, q) in zip(groups, jax_groups):
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))
        for (cg, _), (cp, none) in zip(groups, plain):
            assert none is None
            for (m, lg), (m2, lg2) in zip(cg, cp):
                assert torch.equal(m, m2) and torch.equal(lg, lg2)
    floats = sig.astype(np.float32) / 32768.0
    assert all(p is None for _, p in fe.iter_group_feats(floats,
                                                         keep_pcm=True))


def test_embed_session_dispatch_and_collect(port_vfs, monkeypatch):
    """Full sub-batches dispatch as they fill, the remainder pads to its
    bucket, ``collect`` drops the pads, reuses the speculative embeddings
    and catches up the misses; the embeddings are the extractor's own
    (1e-5: another batch size may take another convolution algorithm)."""
    monkeypatch.setenv("ISS_XVEC_BATCH", "4")
    xm = port_vfs.xvector_model
    fea = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (144 + 24 * 20, 64)).astype(np.float32))
    sizes = []
    hook = xm.net.register_forward_pre_hook(
        lambda mod, args: sizes.append(args[0].shape[0]))
    try:
        sess = tvfs._EmbedSession(xm)
        for s in range(0, 24 * 11, 24):
            sess.queue(s, fea)
        assert sizes == [4, 4] and sess.n_speculative == 11
        sess.flush(fea)
        assert sizes == [4, 4, 4] and sess.n_speculative == 11
        needed = [24 * i for i in (0, 3, 10, 12, 15)]
        got = sess.collect(fea, needed)
    finally:
        hook.remove()
    assert sizes == [4, 4, 4, 2]                  # one catch-up of 2
    assert (sess.n_needed, sess.n_caught_up) == (5, 2)
    want = xm.embeddings_from_features(fea, needed)
    np.testing.assert_allclose(np.stack(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        xm.dispatch_windows(fea, needed[:4]).numpy(), want[:4], rtol=1e-5,
        atol=1e-5)


# -- routing -------------------------------------------------------------------

def test_file_call_routes_overlapped(port_vfs, serial, monkeypatch,
                                     tmp_path):
    """``__call__`` on a WAV takes the overlapped path and equals
    ``score_signal`` and the serial file scoring."""
    sig = signal(5)
    path = str(tmp_path / "s5.wav")
    write_wav(path, sig, 16000)
    port_vfs.overlap_stats = None
    got = port_vfs(path)
    assert port_vfs.overlap_stats is not None
    assert got == serial_result(port_vfs, serial, 5, monkeypatch)
    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    assert port_vfs(path) == got


def test_silence(port_vfs):
    assert overlapped(port_vfs, np.zeros(16000 * 90, np.int16),
                      "z") == (None, 0.0, 0)
    assert port_vfs.overlap_stats == {"dispatched": 0, "needed": 0,
                                      "caught_up": 0}


def _mesh_vfs(synthetic_model_dir, xparams):
    from inaspeechsegmenter_tpu_torch.parallel import make_mesh

    return VoiceFemininityScoring(
        "vfp", ffmpeg=None, device="cpu", model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY), xvector_params=xparams,
        mesh=make_mesh(devices=["cpu"] * 2))


@pytest.mark.parametrize("case", ["short", "one_chunk", "float", "off",
                                  "auto", "mesh", "f32_grid"])
def test_fallbacks_take_the_serial_path(port_vfs, serial,
                                        synthetic_model_dir, xparams,
                                        monkeypatch, case):
    """Signals of one feature chunk or less, float signals,
    ``ISS_VFS_OVERLAP=0``, the default ``ISS_VFS_OVERLAP=auto``, a mesh
    extractor and the f32 VBx path (the CPU's own) take the serial path;
    with the overlap off or a mesh, the result is the serial one."""
    from inaspeechsegmenter_tpu_torch.dsp import vbx

    want = serial_result(port_vfs, serial, 5, monkeypatch)
    vfs, sig = port_vfs, signal(5)
    if case == "short":
        sig = sig[:16000 * 10]
    elif case == "one_chunk":
        # CHUNK frames exactly: not more than one chunk
        sig = sig[:(CHUNK - 1) * HOP + 400]
    elif case == "float":
        sig = sig.astype(np.float32) / 32768.0
    elif case == "off":
        monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    elif case == "auto":
        monkeypatch.delenv("ISS_VFS_OVERLAP")
    elif case == "mesh":
        vfs = _mesh_vfs(synthetic_model_dir, xparams)
    else:
        monkeypatch.setattr(vbx, "vbx_i16_enabled", lambda device: False)

    def refuse(*args):
        raise AssertionError("the overlapped path was taken")

    monkeypatch.setattr(vfs, "_score_signal_overlapped", refuse)
    got = vfs.score_signal(sig, "s5")
    if case in ("off", "auto", "mesh"):
        assert got == want
    assert got[1] > 0


def test_overlap_failure_raises(port_vfs, monkeypatch):
    """No quiet fallback: a failure inside the overlapped path raises."""
    def broken(*args):
        raise RuntimeError("provisional step failed")

    monkeypatch.setattr(tvfs, "_prov_step", broken)
    with pytest.raises(RuntimeError, match="provisional step failed"):
        port_vfs.score_signal(signal(5), "x")


def test_online_vfs_finalize_equals_overlapped(port_vfs, monkeypatch):
    """``OnlineVFS`` on the int16 stream: ``finalize()`` equals
    ``score_signal`` on the overlapped path."""
    sig = signal(9)
    online = OnlineVFS(port_vfs, basename="live")
    for pos in range(0, len(sig), 16000 * 20):
        online.feed(sig[pos:pos + 16000 * 20])
        online.current()
    assert online._use_stream
    got = online.finalize()
    assert got == overlapped(port_vfs, sig, "live")
    assert got[0] is not None and got[2] > 0
