"""PyTorch port: Voice Femininity Scoring against the JAX package.

Both packages run on the same ``size="small"`` synthetic CNN/MLP weights
and the same tiny x-vector net (bottleneck (1, 1, 1, 1), m_channels 8), on
the same seeded signals.  The JAX package is pinned to its serial
reference path (``ISS_VFS_OVERLAP=0``, ``ISS_VBX_UPLOAD=f32``).

Equal: the timeline helpers, the window layout and keys, the retained
windows, ``nb_vectors``, ``speech_duration``, the score and the
``batch_score`` csv bytes.  Embeddings agree within a relative L2 error of
1e-3, and so do the MLP probabilities (the features differ by float32
rounding: <= 5e-4 on noise, see tests/test_torch_vbx.py, and <= 5e-3 on
the tone sections of the test mix); the score is equal
because no probability lies within 1e-3 of 0.5, which the test asserts.
"""

import functools

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu import annotations as jann
from inaspeechsegmenter_tpu import vfs as jvfs
from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxResNet
from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
from inaspeechsegmenter_tpu_torch import annotations as tann
from inaspeechsegmenter_tpu_torch import vfs as tvfs
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.models import registry
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from torch_parity_helpers import int16_grid_on_cpu, to_int16, voiced

TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)


@pytest.fixture(autouse=True)
def jax_reference_path(monkeypatch):
    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    monkeypatch.setenv("ISS_VBX_UPLOAD", "f32")


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
def mix_wav(tmp_path_factory):
    # speech and music sections under the small synthetic VAD
    sig = to_int16(voiced(20.0, seed=2, silences=[(4.0, 4.7),
                                                  (13.2, 13.5)]))
    path = str(tmp_path_factory.mktemp("vfs") / "mix20.wav")
    write_wav(path, sig, 16000)
    return path, sig


@pytest.fixture(scope="module")
def silence_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vfs") / "silence2sec.wav")
    write_wav(path, np.zeros(32000, np.int16), 16000)
    return path


# -- helpers ------------------------------------------------------------------

INTERVALS = [
    [(1.0, 2.0), (3.0, 5.0)],
    [(3.0, 5.0), (1.0, 2.0), (4.0, 6.0)],         # strictly overlapping
    [(1.0, 2.0), (2.0, 3.0)],                     # touching: kept apart
    [(0.0, 0.5), (0.25, 0.26), (7.5, 9.0)],
    [],
]


@pytest.mark.parametrize("intervals", INTERVALS)
def test_speech_timeline_matches_jax(intervals):
    a, b = tann.SpeechTimeline(intervals), jann.SpeechTimeline(intervals)
    assert a.intervals == b.intervals and len(a) == len(b)
    assert a.total_duration() == b.total_duration()
    for m in np.linspace(-0.5, 10, 43).tolist() + [1.0, 2.0, 3.0, 0.25]:
        assert a.contains_point(m) == b.contains_point(m)
    for lo, hi in [(0, 10), (1.5, 3.5), (2.0, 2.0), (2.1, 2.9), (4.5, 8)]:
        assert a.overlap_duration(lo, hi) == b.overlap_duration(lo, hi)
    vad = [("speech", s, e) for s, e in intervals] + [("music", 20, 21)]
    assert (tann.SpeechTimeline.from_vad(vad).intervals
            == jann.SpeechTimeline.from_vad(vad).intervals)


@pytest.mark.parametrize("n_kept,n_mid", [(2, 10), (0, 5), (5, 6), (0, 0),
                                          (3, 3)])
def test_add_needed_vectors_matches_jax(n_kept, n_mid):
    rng = np.random.default_rng(n_kept * 10 + n_mid)
    over = rng.uniform(0, 1, n_mid)
    kept = [(f"k{i}", (i, i + 1), i) for i in range(n_kept)]
    t_mid = [(over[i], f"k{i}", (i, i + 1), i) for i in range(n_mid)]
    assert (tvfs.add_needed_vectors(list(kept), list(t_mid))
            == jvfs.add_needed_vectors(list(kept), list(t_mid)))


@pytest.mark.parametrize("probs", [[0.9, 0.4, 0.5, 0.1], [0.5], [0.49999],
                                   [0.0, 1.0, 0.7]])
def test_femininity_score_matches_jax(probs):
    preds = [(i, i + 1, p) for i, p in enumerate(probs)]
    assert (tvfs.get_femininity_score(preds)
            == jvfs.get_femininity_score(preds))


@pytest.mark.parametrize("n_frames", [100, 144, 145, 168, 169])
def test_window_layout_matches_jax(xparams, n_frames):
    """Starts range(0, n - 144, 24); the tail when n - start - 24 >= 10;
    with no full window the tail starts at frame 24 (reference quirk)."""
    fea = np.random.default_rng(n_frames).standard_normal(
        (n_frames, 64)).astype(np.float32)
    duration = ((n_frames - 1) * 160 + 80) / 16000
    want = jvfs.JaxResnetExtractor(params=xparams, net=JaxResNet(*TINY))(
        "f", fea, duration)
    got = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu")(
        "f", torch.from_numpy(fea), duration)
    assert [(k, s) for k, s, _ in got] == [(k, s) for k, s, _ in want]
    assert got, "every tested length has at least one window"
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)


def test_sub_batches_equal_one_batch(xparams, monkeypatch):
    """BatchNorm uses running statistics and pooling is per window, so the
    ``ISS_XVEC_BATCH`` split does not change an embedding (1e-5: another
    batch size may take another convolution algorithm)."""
    fea = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (600, 64)).astype(np.float32))
    xm = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu")
    starts = list(range(0, 600 - 144, 24))
    want = xm.embeddings_from_features(fea, starts)
    monkeypatch.setenv("ISS_XVEC_BATCH", "4")
    got = xm.embeddings_from_features(fea, starts)
    assert got.shape == (len(starts), 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- end to end ---------------------------------------------------------------

def test_end_to_end_matches_jax(port_vfs, jax_vfs, mix_wav):
    path, _ = mix_wav
    got = port_vfs(path)
    want = jax_vfs(path)
    assert got == want
    assert got[0] is not None and got[1] > 0 and got[2] > 0

    # stage by stage: features, embeddings, MLP probabilities
    bt, fea_t, tl_t, dur_t, sd_t = port_vfs._prepare(path)
    bj, fea_j, tl_j, dur_j, sd_j = jax_vfs._prepare(path)
    assert (bt, tl_t.intervals, dur_t, sd_t) == (bj, tl_j.intervals, dur_j,
                                                 sd_j)
    # tones: bands far from the tone hold only the dither, and the float32
    # DFT rounding of the tone's energy reaches them (cf. 5e-4 on noise)
    np.testing.assert_allclose(fea_t.numpy(), np.asarray(fea_j), rtol=0,
                               atol=5e-3)
    xt = port_vfs.apply_vad(port_vfs.xvector_model(bt, fea_t, dur_t,
                                                   timeline=tl_t), tl_t)
    xj = jax_vfs.apply_vad(jax_vfs.xvector_model(bj, fea_j, dur_j,
                                                 timeline=tl_j), tl_j)
    assert [(k, s) for k, s, _ in xt] == [(k, s) for k, s, _ in xj]
    et = np.stack([x for _, _, x in xt])
    ej = np.stack([x for _, _, x in xj])
    rel = np.linalg.norm(et - ej, axis=1) / np.linalg.norm(ej, axis=1)
    assert rel.max() <= 1e-3
    # the MLPs agree on the same input (1e-5: float32 dot products of the
    # x10 embeddings in another order); each package's own embeddings carry
    # their 1e-3 relative difference into the probabilities
    pt = port_vfs.mlp_probabilities(et)
    np.testing.assert_allclose(
        pt, np.asarray(jax_vfs.gender_detection_mlp_model(et)), rtol=0,
        atol=1e-5)
    pj = np.asarray(jax_vfs.gender_detection_mlp_model(ej))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-3)
    assert not (np.abs(pt - 0.5) < 1e-3).any()


def test_batch_score_csv_byte_equal(port_vfs, jax_vfs, mix_wav, silence_wav,
                                    tmp_path):
    srcs = [silence_wav, mix_wav[0]]
    t_out = [str(tmp_path / "t" / "s.csv"), str(tmp_path / "t" / "m.csv")]
    j_out = [str(tmp_path / "j" / "s.csv"), str(tmp_path / "j" / "m.csv")]
    _, n_ok, _, lmsg = port_vfs.batch_score(srcs, t_out)
    assert n_ok == 2 and [m[1] for m in lmsg] == [0, 0]
    jax_vfs.batch_score(srcs, j_out)
    for a, b in zip(t_out, j_out):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert open(t_out[0]).read() == ("score\tspeech_duration\tnb_vectors\n"
                                     "\t0.0\t0\n")


def test_batch_score_statuses(port_vfs, silence_wav, tmp_path):
    out = tmp_path / "out"
    missing = str(tmp_path / "missing.wav")
    _, n_ok, _, lmsg = port_vfs.batch_score(
        [silence_wav, missing], [str(out / "s.csv"), str(out / "m.csv")],
        nbtry=2, trydelay=0.01)
    assert n_ok == 1 and [m[1] for m in lmsg] == [0, 2]
    assert lmsg[1][2].startswith("error: ")
    again = port_vfs.batch_process([silence_wav], [str(out / "s.csv")],
                                   skipifexist=True)
    assert again[3] == [(str(out / "s.csv"), 1, "already exists")]
    with pytest.raises(ValueError, match="csv"):
        port_vfs.batch_process([silence_wav], [str(out / "s.csv")],
                               output_format="textgrid")


def test_silence_golden(port_vfs, silence_wav):
    assert port_vfs(silence_wav) == (None, 0.0, 0)


def test_score_signal_equals_call(port_vfs, mix_wav):
    path, sig = mix_wav
    assert port_vfs.score_signal(sig, "mix20") == port_vfs(path)


def test_injected_vad_callable(port_vfs, jax_vfs, mix_wav):
    """Reference duck-type contract (vbx_segmenter.py:164): ``vad`` is
    called with the path, so a plain callable can replace the Segmenter."""
    calls = []

    def fake_vad(p):
        calls.append(p)
        return [("speech", 0.0, 8.0), ("noEnergy", 8.0, 20.0)]

    results = []
    for scorer in (port_vfs, jax_vfs):
        old = scorer.vad
        scorer.vad = fake_vad
        try:
            results.append(scorer(mix_wav[0]))
        finally:
            scorer.vad = old
    assert calls == [mix_wav[0]] * 2
    assert results[0] == results[1]
    assert results[0][1] == 8.0 and results[0][2] > 0
    with pytest.raises(TypeError, match="Segmenter"):
        old = port_vfs.vad
        port_vfs.vad = fake_vad
        try:
            port_vfs.score_signal(mix_wav[1])
        finally:
            port_vfs.vad = old


def test_injected_extractor_without_timeline(port_vfs, mix_wav):
    """Reference duck-type contract (vbx_segmenter.py:182): an extractor is
    called with exactly (basename, features, duration)."""
    seen = []

    def fake_extractor(basename, fea, duration):
        seen.append((basename, tuple(fea.shape), duration))
        x = np.ones(256, np.float32)
        return [(f"{basename}_w0", (0.0, 1.44), x),
                (f"{basename}_w1", (0.24, 1.68), -x)]

    old = port_vfs.xvector_model
    port_vfs.xvector_model = fake_extractor
    try:
        score, dur, n = port_vfs.score_signal(mix_wav[1], "mix20")
    finally:
        port_vfs.xvector_model = old
    assert seen == [("mix20", (2000, 64), 20.0)]
    assert n == 2 and score in (0.0, 0.5, 1.0) and dur > 0


def test_cli_writes_csv(port_vfs, synthetic_model_dir, xparams, mix_wav,
                        silence_wav, tmp_path, monkeypatch):
    """The synthetic model dir has no x-vector weights: inject the tiny net
    through the class the CLI resolves at call time."""
    from inaspeechsegmenter_tpu_torch.cli import vfs as cli

    monkeypatch.setattr(tvfs, "VoiceFemininityScoring", functools.partial(
        tvfs.VoiceFemininityScoring, model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY), xvector_params=xparams))
    out = tmp_path / "out"
    out.mkdir()
    assert cli.main(["-i", silence_wav, mix_wav[0], "-o", str(out),
                     "-c", "vfp", "-b", "none", "--device", "cpu"]) == 0
    assert (out / "silence2sec.csv").read_text().splitlines()[1] == "\t0.0\t0"
    score, dur, n = port_vfs(mix_wav[0])
    assert (out / "mix20.csv").read_text().splitlines()[1] == (
        f"{score!r}\t{dur!r}\t{n}")
    with pytest.raises(Exception, match="ffmpeg program not found"):
        cli.main(["-i", silence_wav, "-o", str(out), "-b",
                  "/nonexistent/ffmpeg", "--device", "cpu"])


def test_xvector_weights_from_model_dir(tmp_path, xparams):
    """raw_81.npz, then raw_81.pth, then final.onnx; none raises."""
    with pytest.raises(registry.ModelNotFoundError, match="raw_81"):
        registry.resolve_xvector_weights(str(tmp_path))
    net = ResNetXVector(*TINY).load_jax_params(xparams)
    torch.save(net.state_dict(), str(tmp_path / "raw_81.pth"))
    assert registry.resolve_xvector_weights(str(tmp_path)).endswith(".pth")
    tvfs.save_resnet_npz(str(tmp_path / "raw_81.npz"), xparams)
    assert registry.resolve_xvector_weights(str(tmp_path)).endswith(".npz")
    fea = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (300, 64)).astype(np.float32))
    want = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu")(
        "f", fea, 3.0)
    for name in ("raw_81.npz", "raw_81.pth"):
        got = tvfs.TorchResnetExtractor(
            net=ResNetXVector(*TINY), device="cpu", model_dir=str(tmp_path))("f", fea, 3.0)
        for (_, _, a), (_, _, b) in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        (tmp_path / name).unlink()


def test_cuda_device_without_card_raises(synthetic_model_dir, xparams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VoiceFemininityScoring("bgc", device="cuda",
                               model_dir=synthetic_model_dir,
                               xvector_net=ResNetXVector(*TINY),
                               xvector_params=xparams)


# -- the int16 VBx grid, the tail bucket, the extractor's embed= -------------

def test_int16_grid_end_to_end_matches_jax(port_vfs, jax_vfs, mix_wav,
                                           monkeypatch):
    """Both packages on their int16 VBx path (the JAX package's serial
    path, ``ISS_VFS_OVERLAP=0``): the port's features come from the VAD's
    own upload, and the result tuple is equal."""
    from inaspeechsegmenter_tpu_torch.dsp.vbx import device_atol

    int16_grid_on_cpu(monkeypatch)
    path, sig = mix_wav
    calls = []
    real = port_vfs.features.features_from_pcm
    monkeypatch.setattr(port_vfs.features, "features_from_pcm",
                        lambda parts, n: calls.append(
                            (len(parts), parts[0].dtype, n)) or real(parts, n))
    got = port_vfs(path)
    assert calls == [(1, torch.int16, len(sig))]
    assert got == jax_vfs(path)
    assert got[0] is not None and got[2] > 0
    assert port_vfs.score_signal(sig, "mix20") == got
    fea_t = port_vfs._prepare(path)[1]
    fea_j = jax_vfs._prepare(path)[1]
    # tones: see test_end_to_end_matches_jax (5e-3 there on the f32 path)
    np.testing.assert_allclose(fea_t.numpy(), np.asarray(fea_j), rtol=0,
                               atol=5e-3 + device_atol(len(fea_t), True))
    # a float signal takes the int16 grid through features()
    assert port_vfs.score_signal(sig.astype(np.float32) / 32768.0) == got


@pytest.mark.parametrize("nw_of", [lambda s: 1, lambda s: s - 1,
                                   lambda s: s, lambda s: s + 1,
                                   lambda s: 2 * s + 3])
def test_tail_bucket_forward_sizes_and_embeddings(xparams, monkeypatch,
                                                  nw_of):
    """Every forward runs at a ladder size (the powers of two capped at
    ``ISS_XVEC_BATCH``), and the padding changes no embedding (1e-5, as
    for the sub-batch split)."""
    monkeypatch.setenv("ISS_XVEC_BATCH", "8")
    xm = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu")
    sub, buckets = xm._xvec_layout()
    assert (sub, buckets) == (8, [1, 2, 4, 8])
    nw = nw_of(sub)
    fea = torch.from_numpy(np.random.default_rng(nw).standard_normal(
        (144 + 24 * nw, 64)).astype(np.float32))
    starts = [24 * i for i in range(nw)][::-1]
    with torch.no_grad():
        idx = torch.tensor(starts)[:, None] + torch.arange(144)[None, :]
        want = xm.net(fea[idx].transpose(1, 2)).numpy()
    sizes = []
    hook = xm.net.register_forward_pre_hook(
        lambda mod, args: sizes.append(args[0].shape[0]))
    try:
        got = xm.embeddings_from_features(fea, starts)
    finally:
        hook.remove()
    assert got.shape == (nw, 256)
    assert set(sizes) <= set(buckets) and sum(sizes) >= nw
    full, tail = divmod(nw, sub)
    assert sizes == [sub] * full + ([next(b for b in buckets if b >= tail)]
                                    if tail else [])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the (B, 64, T) batch entry takes the same ladder
    np.testing.assert_allclose(xm.get_embeddings_batch(
        fea[idx].transpose(1, 2)), want, rtol=1e-5, atol=1e-5)
    assert xm.get_embeddings_batch(np.zeros((0, 64, 144))).shape == (0, 256)


def test_extractor_embed_callable(port_vfs, mix_wav):
    """``embed=`` supplies the full windows' raw embeddings (as
    ``OnlineVFS.finalize`` does from its cache): it is asked for the speech
    windows only, and the same embeddings give the same x-vectors."""
    path, _ = mix_wav
    _, fea, timeline, duration, _ = port_vfs._prepare(path)
    xm = port_vfs.xvector_model
    want = xm("mix20", fea, duration, timeline=timeline)
    asked = []

    def embed(f, starts):
        asked.extend(starts)
        return list(xm.embeddings_from_features(f, starts))

    got = xm("mix20", fea, duration, timeline=timeline, embed=embed)
    assert [(k, seg) for k, seg, _ in got] == [(k, seg) for k, seg, _ in want]
    for (_, _, x), (_, _, y) in zip(got, want):
        np.testing.assert_array_equal(x, y)
    n_frames = fea.shape[0]
    every = range(0, n_frames - 144, 24)
    assert 0 < len(asked) < len(every) and set(asked) <= set(every)
    assert all(timeline.contains_point((s + 72) / 100.0) for s in asked)


# -- the mesh: window sub-batches split over slots ------------------------------

def _cpu_mesh(n):
    from inaspeechsegmenter_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("batch", ["1", "7", "16", "100", "256"])
def test_xvec_layout_matches_jax_mesh_ladder(xparams, monkeypatch, batch):
    """``_xvec_layout`` rounds ``sub`` and every bucket up to a slot
    multiple exactly as the JAX extractor does on 1, 5, 6 and 8 devices;
    no mesh and a 1-slot mesh give the plain ladder."""
    from inaspeechsegmenter_tpu.parallel.mesh import make_mesh as jax_mesh

    monkeypatch.setenv("ISS_XVEC_BATCH", batch)
    plain = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu")
    want = jvfs.JaxResnetExtractor(params=xparams, net=JaxResNet(*TINY))
    assert plain._xvec_layout() == want._xvec_layout()
    for n in (1, 5, 6, 8):
        got = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu",
                                        mesh=_cpu_mesh(n))._xvec_layout()
        want = jvfs.JaxResnetExtractor(params=xparams, net=JaxResNet(*TINY),
                                       mesh=jax_mesh(n))._xvec_layout()
        assert got == want, n
        sub, buckets = got
        assert sub % n == 0 and all(b % n == 0 and b <= sub
                                    for b in buckets)
        assert all(next(x for x in buckets if x >= b) == b for b in buckets)
    assert tvfs.TorchResnetExtractor(
        xparams, ResNetXVector(*TINY), "cpu",
        mesh=_cpu_mesh(1))._xvec_layout() == plain._xvec_layout()


@pytest.mark.parametrize("n_slots", [8, 6])
def test_mesh_extractor_matches_one_device_and_jax(xparams, monkeypatch,
                                                   n_slots):
    """The extractor on 8 (and a non-divisor 6) CPU slots with
    ``ISS_XVEC_BATCH=16``: the same keys and starts as without a mesh and
    as the JAX extractor sharded over as many devices, embeddings within
    rtol 1e-4 / atol 1e-3 (the JAX test's tolerance); every forward runs
    at a ladder size, split evenly over the slots' replicas."""
    from inaspeechsegmenter_tpu.parallel.mesh import make_mesh as jax_mesh

    monkeypatch.setenv("ISS_XVEC_BATCH", "16")
    fea = np.random.default_rng(5).standard_normal((700, 64)).astype(
        np.float32)
    mesh = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu",
                                     mesh=_cpu_mesh(n_slots))
    one = tvfs.TorchResnetExtractor(xparams, ResNetXVector(*TINY), "cpu")
    sizes = []
    hooks = [r.register_forward_pre_hook(
        lambda mod, args: sizes.append(args[0].shape[0]))
        for r in mesh.replicas]
    try:
        got = mesh("b", torch.from_numpy(fea), 7.0)
    finally:
        for h in hooks:
            h.remove()
    sub, buckets = mesh._xvec_layout()
    assert sizes and all(s * n_slots in buckets + [sub] for s in sizes)
    base = one("b", torch.from_numpy(fea), 7.0)
    want = jvfs.JaxResnetExtractor(params=xparams, net=JaxResNet(*TINY),
                                   mesh=jax_mesh(n_slots))("b", fea, 7.0)
    assert len(got) == len(base) == len(want) > 20
    for (ka, sa, xa), (kb, sb, xb), (kc, sc, xc) in zip(got, base, want):
        assert ka == kb == kc and sa == sb == sc
        np.testing.assert_allclose(xa, xb, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(xa, xc, rtol=1e-4, atol=1e-3)


def test_vfs_mesh_gives_the_same_result(port_vfs, synthetic_model_dir,
                                        xparams, mix_wav, monkeypatch):
    monkeypatch.setenv("ISS_XVEC_BATCH", "16")
    vfs = VoiceFemininityScoring(
        "vfp", ffmpeg=None, mesh=_cpu_mesh(4), device="cpu",
        model_dir=synthetic_model_dir, xvector_net=ResNetXVector(*TINY),
        xvector_params=xparams)
    path, _ = mix_wav
    got = vfs(path)
    assert got == port_vfs(path)
    assert got[2] > 0
