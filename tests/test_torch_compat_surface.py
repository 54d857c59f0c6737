"""PyTorch port: the reference's import paths.

User code written against ``inaSpeechSegmenter`` finds every symbol of
``tests/test_compat_surface.py::REFERENCE_SURFACE`` under
``inaspeechsegmenter_tpu_torch.<mod>`` too.  The numpy modules
(``sidekit_mfcc``, ``features_vbx``) are copies of the JAX package's and
equal them exactly on seeded float64 inputs; the rest re-export the
port's own objects.
"""

import importlib

import numpy as np
import pytest

from test_compat_surface import REFERENCE_SURFACE


@pytest.mark.parametrize("mod,names", sorted(REFERENCE_SURFACE.items()))
def test_symbols_present(mod, names):
    m = importlib.import_module(f"inaspeechsegmenter_tpu_torch.{mod}")
    missing = [n for n in names if not hasattr(m, n)]
    assert not missing, f"{mod} missing {missing}"


def _pair(mod):
    return (importlib.import_module(f"inaspeechsegmenter_tpu_torch.{mod}"),
            importlib.import_module(f"inaspeechsegmenter_tpu.{mod}"))


# -- sidekit_mfcc: exact against the JAX package's numpy module ---------------

def test_sidekit_mfcc_mfcc_matches_jax():
    t, j = _pair("sidekit_mfcc")
    sig = np.random.default_rng(0).standard_normal(16000)
    for kw in ({}, dict(get_spec=True, get_mspec=True),
               dict(nlogfilt=40, maxfreq=7600, nceps=20, get_mspec=True),
               dict(nlinfilt=10, nlogfilt=14, lowfreq=50, prefac=0.9)):
        for a, b in zip(t.mfcc(sig, **kw), j.mfcc(sig, **kw)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("htk", [True, False])
def test_sidekit_mfcc_mel_scales_match_jax(htk):
    t, j = _pair("sidekit_mfcc")
    f = np.random.default_rng(1).uniform(0, 8000, 50)
    for x in (f, np.array([440.0]), np.array([0.0, 999.0, 1000.0])):
        np.testing.assert_array_equal(t.hz2mel(x, htk=htk),
                                      j.hz2mel(x, htk=htk))
        z = j.hz2mel(x, htk=htk)
        np.testing.assert_array_equal(t.mel2hz(z, htk=htk),
                                      j.mel2hz(z, htk=htk))
    assert np.ndim(t.hz2mel(np.array([440.0]), htk=htk)) == np.ndim(
        j.hz2mel(np.array([440.0]), htk=htk))


@pytest.mark.parametrize("args", [(16000, 512, 100, 8000, 0, 24),
                                  (16000, 512, 0, 8000, 10, 14),
                                  (8000, 256, 0, 4000, 20, 0)])
def test_sidekit_mfcc_trfbank_matches_jax(args):
    t, j = _pair("sidekit_mfcc")
    for a, b in zip(t.trfbank(*args), j.trfbank(*args)):
        np.testing.assert_array_equal(a, b)


def test_sidekit_mfcc_framing_pre_emphasis_power_spectrum_match_jax():
    t, j = _pair("sidekit_mfcc")
    rng = np.random.default_rng(2)
    sig = rng.standard_normal(4000)
    for kw in ({}, dict(win_shift=160), dict(win_shift=160,
                                             context=(80, 80)),
               dict(win_shift=160, context=(80, 0), pad="edge")):
        np.testing.assert_array_equal(t.framing(sig, 400, **kw),
                                      j.framing(sig, 400, **kw))
    np.testing.assert_array_equal(t.framing(sig[:400], 400),
                                  j.framing(sig[:400], 400))
    frames = j.framing(sig, 400, win_shift=160)
    for x in (sig, frames):
        np.testing.assert_array_equal(t.pre_emphasis(x, 0.97),
                                      j.pre_emphasis(x, 0.97))
    for fs in (8000, 16000):
        for a, b in zip(t.power_spectrum(sig, fs=fs),
                        j.power_spectrum(sig, fs=fs)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# -- features_vbx: exact against the JAX package's ---------------------------

def test_features_vbx_matches_jax():
    t, j = _pair("features_vbx")
    rng = np.random.default_rng(3)
    sig = rng.standard_normal(16000) * 1000
    np.testing.assert_array_equal(t.framing(sig, 400, 160),
                                  j.framing(sig, 400, 160))
    np.testing.assert_array_equal(t.preemphasis(sig), j.preemphasis(sig))
    np.testing.assert_array_equal(t.povey_window(400), j.povey_window(400))
    f = rng.uniform(0, 8000, 20)
    np.testing.assert_array_equal(t.mel(f), j.mel(f))
    np.testing.assert_array_equal(t.mel_inv(t.mel(f)), j.mel_inv(j.mel(f)))
    for kw in (dict(NUMCHANS=64, LOFREQ=20.0, HIFREQ=7600, htk_bug=False),
               dict(NUMCHANS=24, LOFREQ=100.0), dict()):
        np.testing.assert_array_equal(t.mel_fbank_mx(400, 16000, **kw),
                                      j.mel_fbank_mx(400, 16000, **kw))
    with pytest.raises(NotImplementedError):
        t.mel_fbank_mx(400, 16000, warp_fn=np.log)
    fb = t.mel_fbank_mx(400, 16000, NUMCHANS=64, LOFREQ=20.0, HIFREQ=7600,
                        htk_bug=False)
    win = t.povey_window(400)
    for kw in (dict(USEPOWER=True, ZMEANSOURCE=True), dict(_E="first"),
               dict(_E="last", ENORMALISE=False)):
        np.testing.assert_array_equal(t.fbank_htk(sig, win, 240, fb, **kw),
                                      j.fbank_htk(sig, win, 240, fb, **kw))
    x = rng.standard_normal((500, 64))
    for nv in (True, False):
        np.testing.assert_array_equal(
            t.cmvn_floating_kaldi(x.copy(), 150, 149, norm_vars=nv),
            j.cmvn_floating_kaldi(x.copy(), 150, 149, norm_vars=nv))
    ints = (rng.standard_normal(1000) * 3000).astype(int)
    np.random.seed(3)
    a = t.add_dither(ints)
    np.random.seed(3)
    np.testing.assert_array_equal(a, j.add_dither(ints))


# -- the other modules ----------------------------------------------------------

def test_thread_returning_join_returns_value():
    from inaspeechsegmenter_tpu_torch.thread_returning import ThreadReturning

    t = ThreadReturning(target=lambda a, b: a + b, args=(2, 3))
    t.start()
    assert t.join() == 5
    idle = ThreadReturning()
    idle.start()
    assert idle.join() is None


def test_resnet101_shapes_match_resnet101_xvector():
    """``ResNet101()`` is the x-vector architecture: its parameters have
    ``ResNet101XVector``'s shapes, and a JAX ResNet101 checkpoint loads
    into it (shape-checked)."""
    from inaspeechsegmenter_tpu.models.resnet import \
        ResNet101XVector as JaxResNet101
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNet101XVector
    from inaspeechsegmenter_tpu_torch.resnet import ResNet101

    net = ResNet101(feat_dim=64, embed_dim=256)
    assert net.num_blocks == (3, 4, 23, 3)
    assert ({k: v.shape for k, v in net.state_dict().items()}
            == {k: v.shape for k, v in ResNet101XVector().state_dict()
                .items()})
    net.load_jax_params(JaxResNet101().init_params(seed=0))
    with pytest.raises(NotImplementedError):
        ResNet101(squeeze_excitation=True)


def test_vbx_segmenter_helpers_match_jax():
    t, j = _pair("vbx_segmenter")
    from inaspeechsegmenter_tpu_torch.vfs import TorchResnetExtractor

    assert t.VBxExtractor is TorchResnetExtractor
    vad = [("noEnergy", 0.0, 1.0), ("speech", 1.0, 3.0), ("music", 3.0, 5.0),
           ("speech", 5.0, 6.0)]
    a, b = t.get_annot_VAD(vad), j.get_annot_VAD(vad)
    assert a.intervals == b.intervals and a.total_duration() == 3.0
    for seg in [(1.0, 3.0), (3.0, 5.0), (4.5, 6.5), (0.0, 2.0), (5.9, 6.1)]:
        assert t.is_mid_speech(*seg, a) == j.is_mid_speech(*seg, b)
    assert t.is_mid_speech(1.0, 3.0, a) and not t.is_mid_speech(3.0, 5.0, a)
    sig = np.clip(np.random.default_rng(4).standard_normal(16000) * 0.1,
                  -1, 1)
    np.testing.assert_array_equal(t.get_features(sig), j.get_features(sig))


def test_viterbi_paths_match_jax():
    t, j = _pair("pyannote_viterbi")
    tu, ju = _pair("viterbi_utils")
    rng = np.random.default_rng(5)
    binary = rng.random(300) < 0.4
    np.testing.assert_array_equal(tu.pred2logemission(binary),
                                  ju.pred2logemission(binary))
    em = np.log(rng.dirichlet(np.ones(3), 300))
    trans = tu.diag_trans_exp(10, 3)
    np.testing.assert_array_equal(trans, ju.diag_trans_exp(10, 3))
    np.testing.assert_array_equal(tu.log_trans_exp(150, cost0=-5),
                                  ju.log_trans_exp(150, cost0=-5))
    constraint = np.zeros((300, 3), int)
    constraint[40:60, 1] = t.VITERBI_CONSTRAINT_FORBIDDEN
    constraint[100:110, 2] = t.VITERBI_CONSTRAINT_MANDATORY
    got = t.viterbi_decoding(em, trans, consecutive=4,
                             constraint=constraint, device="cpu")
    want = j.viterbi_decoding(em, trans, consecutive=4,
                              constraint=constraint)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (t.VITERBI_CONSTRAINT_NONE, t.VITERBI_CONSTRAINT_FORBIDDEN,
            t.VITERBI_CONSTRAINT_MANDATORY) == (
        j.VITERBI_CONSTRAINT_NONE, j.VITERBI_CONSTRAINT_FORBIDDEN,
        j.VITERBI_CONSTRAINT_MANDATORY)


def test_io_remote_and_export_paths(tmp_path, synthetic_model_dir):
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav

    t_io, j_io = _pair("io")
    sig = (np.random.default_rng(6).standard_normal(8000) * 3000).astype(
        np.int16)
    path = str(tmp_path / "x.wav")
    write_wav(path, sig, 16000)
    np.testing.assert_array_equal(t_io.media2sig16kmono(path, ffmpeg=None),
                                  j_io.media2sig16kmono(path, ffmpeg=None))
    t_r, _ = _pair("remote_utils")
    got = t_r.get_remote("keras_speech_music_noise_cnn.hdf5",
                         allow_download=False, allow_synthetic=True,
                         model_dir=synthetic_model_dir)
    assert got.startswith(synthetic_model_dir)
    t_e, j_e = _pair("export_funcs")
    lseg = [("speech", 0.0, 1.5), ("noEnergy", 1.5, 2.02)]
    t_e.seg2csv(lseg, str(tmp_path / "t.csv"))
    j_e.seg2csv(lseg, str(tmp_path / "j.csv"))
    assert ((tmp_path / "t.csv").read_bytes()
            == (tmp_path / "j.csv").read_bytes())
