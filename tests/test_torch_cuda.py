"""PyTorch port on the GPU: each CUDA kernel against its plain version.

Marked ``cuda``: every test needs an NVIDIA GPU and nvcc, and skips where
there is none.  On the GPU host (which has no jax, so the suite's
conftest cannot load there):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Features: finite masks equal, mspec within rtol/atol 1e-4, loge within
1e-5 (an FFT against the plain dense DFT: float32 sums in another order).
Viterbi: states bit-equal, including exact ties, -inf and NaN scores and
emissions that never coalesce (which the kernel's serial walk finishes);
the general-K kernel (K > 3, and K <= 3 through its own wrapper) bit-equal
to the plain loop at K from 4 to 8,192, with resets, ties and NaN rows, on
the never-converging uniform ``consecutive=10`` expansion at T = 180,000,
and with the pass and walk counts of its numpy model
(``tests/viterbi_general_model.py``) at the kernel's own chunking.

The VFS path has no hand kernel; its cases hold the CUDA run of the plain
PyTorch code (cuDNN / cuBLAS, TF32 off) against the CPU run: VBx features
within ``dsp.vbx.device_atol(n_frames)`` on the f32 path and
``device_atol(n_frames, blocked=True)`` on the int16 grid (whose streams
are bit-equal to the whole-signal features on the card too), tiny-ResNet
embeddings within a relative L2 error of 1e-4, the bucketed last
sub-batch within 1e-4 of the ragged one, and the end-to-end score equal,
also when ``batch_score``'s producer threads take the features from the
VAD's upload.

Real inputs: a Segmenter built from ``.hdf5`` files against the npz route
(bit-equal weights, equal labels), and each CNN and x-vector precision
tier against ``highest`` (CNN outputs within 2e-2, embeddings within a
relative L2 error of 1e-2 for ``high`` and 5e-2 for ``bf16``, never
bit-equal).  ``batch_score`` with the ResNet at ``high`` on the consumer
thread: the producer threads' VAD and VBx features bit-equal to a serial
run's, the process's TF32 flags as they were.

Streaming and online: a group launch of the features kernel within the
features tolerance of the plain version and bit-equal to the rows of a
whole-signal launch; the Viterbi with the online suffix decode's
near-one-hot initial vector bit-equal; ``run_streaming`` against ``run``
and the online ``finalize()`` against ``segment_signal`` with at most 0.1%
of the frames differing (the CNN runs in batches of other sizes, which
cuDNN may take another algorithm for); the prefetched ``batch_process``
csvs equal to one call of the Segmenter per file.

Training: the trainer's gradients at ``highest`` on the card against the
CPU's with the process's TF32 flags left on (PyTorch's cuDNN default), so
a backward outside the step's precision scope would show as TF32 error:
each array within 1e-4 of its largest magnitude; the first ``fit`` losses
within rtol 1e-3 of the CPU's and the exported model serving on the card
without the synthetic warning; at ``bf16`` the trainer's forward after a
step equal to an inference model's built from the updated parameters; and
``patch_dataset`` on the card against the CPU (patches within atol 1e-4,
the features tolerance; labels and times equal; one features launch a
file).
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
from inaspeechsegmenter_tpu_torch.decode.transitions import diag_trans_exp
from inaspeechsegmenter_tpu_torch.dsp import fe_kernel, sidekit
from torch_parity_helpers import (int16_grid_on_cpu, kernel_constant,
                                  speechlike, to_int16, voiced)
from viterbi_general_model import (chunk_parallel_viterbi_general,
                                   constant_case, consecutive_case,
                                   constrained_case, dense_case)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# 8 frames per kernel tile: a full tile and one frame more
@pytest.mark.parametrize("n_samples", [400, 400 + 160 * 7, 400 + 160 * 8,
                                       400 + 160 * 16, 16000 * 7 + 123])
@pytest.mark.parametrize("kind", ["f32", "int16"])
def test_features_kernel_matches_plain(dev, kind, n_samples):
    sig = speechlike(n_samples / 16000, seed=n_samples,
                     silences=[(0.2, 0.9)])[:n_samples]
    arr = to_int16(sig) if kind == "int16" else sig
    x = torch.from_numpy(arr).to(dev)
    consts = sidekit.frontend_consts(dev)
    before = fe_kernel.sidekit_features.launches
    mk, lk = fe_kernel.sidekit_features(x, consts)
    torch.cuda.synchronize()
    assert fe_kernel.sidekit_features.launches == before + 1
    mp, lp = fe_kernel.sidekit_features_plain(x, consts)
    mk, lk, mp, lp = (a.cpu().numpy() for a in (mk, lk, mp, lp))
    assert mk.shape == mp.shape == (sidekit.frame_count(n_samples), 24)
    fin = np.isfinite(mp)
    np.testing.assert_array_equal(np.isfinite(mk), fin)
    np.testing.assert_allclose(mk[fin], mp[fin], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.isfinite(lk), np.isfinite(lp))
    finl = np.isfinite(lp)
    np.testing.assert_allclose(lk[finl], lp[finl], rtol=1e-5, atol=1e-5)


def test_features_kernel_takes_a_misaligned_view(dev):
    """The kernel copies 16-byte pieces; the wrapper copies a signal whose
    start is not 16-byte aligned."""
    sig = torch.from_numpy(to_int16(speechlike(1.0, seed=3))).to(dev)[3:]
    assert sig.is_contiguous() and sig.data_ptr() % 16
    consts = sidekit.frontend_consts(dev)
    mk, lk = fe_kernel.sidekit_features(sig, consts)
    mp, lp = fe_kernel.sidekit_features_plain(sig, consts)
    np.testing.assert_allclose(mk.cpu().numpy(), mp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


_PLAIN = {}


def _viterbi_case(K, kind, T, dev):
    rng = np.random.default_rng(T + 7 * K)
    if kind == "constant":
        # score gaps grow by 1e-5 a frame and never reach the transition
        # cost: no chunk forgets its entry, the kernel's worst case
        em = np.tile(np.log(1.0 / K) - 1e-5 * np.arange(K), (T, 1))
    elif kind in ("ties", "nan"):
        with np.errstate(divide="ignore"):
            em = np.log(rng.integers(0, 3, size=(T, K)) / 2.0)
        if kind == "nan":
            em[rng.random(T) < 0.02] = -np.inf     # all -inf: NaN scores
            em[rng.random(T) < 0.01, 0] = np.nan
    else:
        em = np.log(rng.dirichlet(np.ones(K), T))
    p_reset = {"resets": 0.3, "constant": 0.0}.get(kind, 0.01)
    reset = rng.random(T) < p_reset
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        em.astype(np.float32), diag_trans_exp(0.7, K).astype(np.float32),
        np.full(K, np.log(1.0 / K), np.float32), reset)]
    key = (K, kind, T)
    if key not in _PLAIN:
        _PLAIN[key] = tv.viterbi_scan_plain(*args).cpu().numpy()
    return args, _PLAIN[key]


CHUNK_MIN = kernel_constant("viterbi.cu", "CHUNK_MIN")
PASS_CAP = kernel_constant("viterbi.cu", "PASS_CAP")


# chunks of 16 frames: T on both sides of a chunk edge, of a block's 256
# chunks and of 1024 chunks
@pytest.mark.parametrize("T", [1, 15, 16, 17, 2047, 2048, 4096, 4097,
                               2 * 2048 + 5, 1023 * 16 + 1, 180_000])
@pytest.mark.parametrize("kind", ["random", "resets", "ties", "nan",
                                  "constant"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_viterbi_kernel_bit_equal(dev, K, kind, T):
    args, want = _viterbi_case(K, kind, T, dev)
    before = tv.viterbi_scan.launches
    got = tv.viterbi_scan(*args)
    torch.cuda.synchronize()
    assert tv.viterbi_scan.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    n_chunks = -(-T // CHUNK_MIN)
    passes, walked = tv.pass_count(), tv.walked_chunks()
    assert 1 <= passes <= min(n_chunks, PASS_CAP + 1)
    assert 0 <= walked < n_chunks
    if kind == "constant" and K > 1 and n_chunks > PASS_CAP + 1:
        # never coalesces: the passes stop at the cap and the walk finishes
        assert passes == PASS_CAP + 1 and walked > 0


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_viterbi_kernel_long_chunks(dev, kind):
    """T beyond 16 frames for every thread of the grid: longer chunks,
    rounded up to whole groups of 8 frames (18 -> 24 on 132 SMs)."""
    T = 600_001
    args, want = _viterbi_case(3, kind, T, dev)
    got = tv.viterbi_scan(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert tv.pass_count() <= PASS_CAP + 1


def test_viterbi_kernel_takes_misaligned_views(dev):
    """The kernel reads 16-byte pieces; the wrapper copies inputs whose
    start is not aligned for them."""
    (em, trans, init, reset), _ = _viterbi_case(3, "random", 5003, dev)
    em, reset = em[3:], reset[3:]
    assert em.data_ptr() % 16 and reset.data_ptr() % 8
    assert em.is_contiguous() and reset.is_contiguous()
    got = tv.viterbi_scan(em, trans, init, reset)
    want = tv.viterbi_scan_plain(em, trans, init, reset)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    consts = sidekit.frontend_consts(dev)
    with pytest.raises(ValueError, match="float32 or int16"):
        fe_kernel.sidekit_features(torch.zeros(1000, dtype=torch.float64,
                                               device=dev), consts)
    with pytest.raises(ValueError, match="contiguous"):
        fe_kernel.sidekit_features(torch.zeros(2000, device=dev)[::2],
                                   consts)
    # more than 3 states go to the general-K kernel, which checks its own
    em = torch.zeros((10, 4), device=dev)
    with pytest.raises(ValueError, match="transition"):
        tv.viterbi_scan(em, em, em, em)
    em = torch.zeros((10, tv.K_GENERAL_MAX + 1), device=dev)
    with pytest.raises(ValueError, match=f"1..{tv.K_GENERAL_MAX} states"):
        tv.viterbi_scan(em, em, em, em)
    em = torch.zeros((10, 2), device=dev)
    with pytest.raises(ValueError, match="reset"):
        tv.viterbi_scan(em, torch.zeros((2, 2), device=dev),
                        torch.zeros(2, device=dev),
                        torch.zeros(10, device=dev))


def test_segmenter_cuda_matches_cpu(dev, tmp_path):
    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)

    models = install_synthetic_models(str(tmp_path), size="small")
    sig = to_int16(speechlike(20.0, seed=23, silences=[(4.0, 4.7),
                                                       (13.2, 13.5)]))
    fe0, vt0 = fe_kernel.sidekit_features.launches, tv.viterbi_scan.launches
    got = Segmenter("smn", True, ffmpeg=None, device=dev,
                    model_dir=models).segment_signal(sig)
    assert fe_kernel.sidekit_features.launches == fe0 + 1
    assert tv.viterbi_scan.launches == vt0 + 3
    want = Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=models).segment_signal(sig)
    assert got == want


@pytest.mark.parametrize("seconds", [2.0, 20.0, 130.0])
def test_vbx_features_cuda_matches_cpu(dev, seconds, monkeypatch):
    """The f32 path (the card's own is the int16 grid)."""
    from inaspeechsegmenter_tpu_torch.dsp import vbx
    from inaspeechsegmenter_tpu_torch.dsp.vbx import VbxFrontend, device_atol

    monkeypatch.setattr(vbx, "vbx_i16_enabled", lambda device: False)
    sig = to_int16(speechlike(seconds, seed=int(seconds),
                              silences=[(0.5, 1.2)])).astype(np.float64)
    sig /= 32768.0
    got = VbxFrontend(dev).features(sig)
    assert got.device.type == "cuda"
    want = VbxFrontend("cpu").features(sig).numpy()
    got = got.cpu().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=device_atol(len(want)))


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_resnet_cuda_matches_cpu(dev, block):
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    net = ResNetXVector(block, (2, 2, 2, 2), 8, 64, 256)
    net.load_jax_params(net.init_params(seed=1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 64, 144)).astype(np.float32))
    n_valid = torch.tensor([144, 143, 100, 37, 10])
    with torch.no_grad():
        want = net(x).numpy()
        want_m = net(x, n_valid).numpy()
        net = net.to(dev)
        got = net(x.to(dev)).cpu().numpy()
        got_m = net(x.to(dev), n_valid.to(dev)).cpu().numpy()
    for a, b in ((got, want), (got_m, want_m)):
        rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
        assert rel.max() <= 1e-4


def test_vfs_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    """Like with like: both devices on the int16 grid."""
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring

    int16_grid_on_cpu(monkeypatch)
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)

    models = install_synthetic_models(str(tmp_path), size="small")
    net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
    params = net.init_params(seed=7)
    sig = to_int16(voiced(20.0, seed=2, silences=[(4.0, 4.7), (13.2, 13.5)]))
    fe0, vt0 = fe_kernel.sidekit_features.launches, tv.viterbi_scan.launches
    got = VoiceFemininityScoring(
        "vfp", ffmpeg=None, device=dev, model_dir=models,
        xvector_net=ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256),
        xvector_params=params).score_signal(sig)
    assert fe_kernel.sidekit_features.launches == fe0 + 1
    assert tv.viterbi_scan.launches == vt0 + 2
    want = VoiceFemininityScoring(
        "vfp", ffmpeg=None, device="cpu", model_dir=models, xvector_net=net,
        xvector_params=params).score_signal(sig)
    assert got == want and got[2] > 0


# -- streaming, online and prefetch on the card --------------------------------

@pytest.fixture(scope="module")
def small_models(tmp_path_factory):
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)

    return install_synthetic_models(str(tmp_path_factory.mktemp("models")),
                                    size="small")


@pytest.mark.parametrize("kind", ["int16", "f32"])
def test_group_features_match_plain_and_whole_signal_rows(dev, kind):
    """One launch per group of 3 chunks: within the features tolerance of
    the plain version, and its rows bit-equal to the same rows of one
    launch over the whole signal (every frame reads only its own 400
    samples)."""
    from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import (
        GROUP_CHUNKS, KernelSidekitFrontend)

    CHUNK, HOP = sidekit.CHUNK, sidekit.HOP
    sig = speechlike(4.4 * CHUNK * HOP / 16000, seed=9,
                     silences=[(3.0, 5.0), (130.0, 131.0)])
    arr = to_int16(sig) if kind == "int16" else sig
    fe = KernelSidekitFrontend(dev)
    raw = arr[:(GROUP_CHUNKS * CHUNK + 2) * HOP]
    before = fe_kernel.sidekit_features.launches
    chunks, _ = fe.group_feats(raw, GROUP_CHUNKS)
    assert fe_kernel.sidekit_features.launches == before + 1
    mk = torch.cat([m for m, _ in chunks]).cpu().numpy()
    lk = torch.cat([lg for _, lg in chunks]).cpu().numpy()
    mp, lp = fe_kernel.sidekit_features_plain(torch.from_numpy(raw).to(dev),
                                              fe.consts)
    mp, lp = mp.cpu().numpy(), lp.cpu().numpy()
    fin = np.isfinite(mp)
    np.testing.assert_array_equal(np.isfinite(mk), fin)
    np.testing.assert_allclose(mk[fin], mp[fin], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lk[np.isfinite(lp)], lp[np.isfinite(lp)],
                               rtol=1e-5, atol=1e-5)
    feats, t = fe.mspec_loge_chunks(arr)
    whole_m, whole_l, _ = fe.mspec_loge(arr)
    m = torch.cat([c[0] for c in feats])[:t]
    lg = torch.cat([c[1] for c in feats])[:t]
    assert torch.equal(m, whole_m) and torch.equal(lg, whole_l)


def test_viterbi_kernel_near_one_hot_initial(dev):
    """The online suffix decode's energy initial vector: log(1e-200) off
    the committed state, 0 on it."""
    from inaspeechsegmenter_tpu_torch.decode.transitions import (
        log_trans_exp)

    rng = np.random.default_rng(5)
    T = 3 * 4096 + 17
    act = rng.random(T) < 0.6
    em = np.where(act[:, None], np.log([1e-10, 1 - 1e-10]),
                  np.log([1 - 1e-10, 1e-10])).astype(np.float32)
    reset = np.zeros(T, bool)
    reset[0] = True
    for state in (0, 1):
        init = np.full(2, np.log(1e-200), np.float32)
        init[state] = 0.0
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            em, log_trans_exp(150, cost0=-5).astype(np.float32), init,
            reset)]
        got = tv.viterbi_scan(*args).cpu().numpy()
        want = tv.viterbi_scan_plain(*args).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0] == state


@pytest.fixture(scope="module")
def cuda_seg(dev, small_models):
    from inaspeechsegmenter_tpu_torch import Segmenter

    return Segmenter("smn", True, ffmpeg=None, device=dev,
                     model_dir=small_models)


def _frame_labels(lseg):
    return np.concatenate([np.full(int(round((b - a) / .02)), lab, object)
                           for lab, a, b in lseg])


def test_run_streaming_matches_run(cuda_seg):
    CHUNK, HOP = sidekit.CHUNK, sidekit.HOP
    sig = to_int16(speechlike(3.4 * CHUNK * HOP / 16000, seed=11,
                              silences=[(20.0, 21.0), (95.0, 97.0)]))
    feats, t = cuda_seg.frontend.mspec_loge_chunks(sig)
    n20 = (t + 1) // 2
    got = cuda_seg.pipeline.run_streaming(feats, t, t, n20).cpu().numpy()
    mspec, loge, _ = cuda_seg.frontend.mspec_loge(sig)
    want = cuda_seg.pipeline.run(mspec, loge, t, t, n20).cpu().numpy()
    # the CNN runs in batches of other sizes: at most 0.1% of the frames
    assert (got != want).sum() <= 0.001 * n20


def test_online_finalize_matches_segment_signal(cuda_seg):
    from inaspeechsegmenter_tpu_torch import OnlineSegmenter

    CHUNK, HOP = sidekit.CHUNK, sidekit.HOP
    sig = to_int16(speechlike(4.3 * CHUNK * HOP / 16000, seed=12,
                              silences=[(30.0, 31.0)]))
    online = OnlineSegmenter(cuda_seg)
    fe0, vt0 = fe_kernel.sidekit_features.launches, tv.viterbi_scan.launches
    for pos in range(0, len(sig), 16000 * 5):
        online.feed(sig[pos:pos + 16000 * 5])
        if online.chunks_ready >= 2:
            # (before that, a poll segments the buffered prefix whole)
            online.current()
    got = _frame_labels(online.finalize())
    assert fe_kernel.sidekit_features.launches == fe0 + 2   # two groups
    assert tv.viterbi_scan.launches > vt0 + 3
    want = _frame_labels(cuda_seg.segment_signal(sig))
    assert got.shape == want.shape
    assert (got != want).sum() <= 0.001 * len(want)


def test_prefetched_batch_process_matches_one_by_one(cuda_seg, tmp_path,
                                                     monkeypatch):
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.export import seg2csv

    monkeypatch.setenv("ISS_PREFETCH", "3")
    wavs = []
    for i, seconds in enumerate((2.0, 20.0, 65.0, 7.0)):
        wavs.append(str(tmp_path / f"f{i}.wav"))
        write_wav(wavs[-1], to_int16(speechlike(seconds, seed=30 + i,
                                                silences=[(0.5, 1.2)])),
                  16000)
    wavs.append(str(tmp_path / "missing.wav"))
    outs = [str(tmp_path / "out" / f"f{i}.csv") for i in range(len(wavs))]
    _, n_ok, _, lmsg = cuda_seg.batch_process(wavs, outs)
    assert n_ok == 4 and [m[1] for m in lmsg] == [0, 0, 0, 0, 2]
    for wav, out in zip(wavs[:-1], outs[:-1]):
        assert open(out).read() == seg2csv(cuda_seg(wav))


# -- real inputs: hdf5 weights and the precision tiers on the card --------------

def test_hdf5_route_matches_npz_route(dev, small_models, tmp_path):
    """A Segmenter built from the ``.hdf5`` files of the small synthetic
    set holds bit-equal weights and gives the npz route's labels."""
    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
    from torch_parity_helpers import write_spec_h5

    for stem, args in (("keras_speech_music_noise_cnn", (21, 3, 1)),
                       ("keras_male_female_cnn", (24, 2, 2))):
        write_spec_h5(str(tmp_path / f"{stem}.hdf5"),
                      *build_patch_cnn(*args, "small"))
    got = Segmenter("smn", True, ffmpeg=None, device=dev,
                    model_dir=str(tmp_path), allow_download=False)
    want = Segmenter("smn", True, ffmpeg=None, device=dev,
                     model_dir=small_models, allow_download=False)
    assert got.vad.model.path.endswith(".hdf5")
    for a, b in ((got.vad.model, want.vad.model),
                 (got.gender.model, want.gender.model)):
        for u, v in zip(a.state_dict().values(), b.state_dict().values(),
                        strict=True):
            assert torch.equal(u, v)
    sig = to_int16(voiced(20.0, seed=2, silences=[(4.0, 4.7)]))
    assert got.segment_signal(sig) == want.segment_signal(sig)


@pytest.mark.parametrize("tier", ["high", "bf16"])
def test_cnn_tier_against_highest(dev, tier, monkeypatch):
    """Within 2e-2 of ``highest`` and not bit-equal to it; the TF32 flags
    are restored after the forward."""
    from inaspeechsegmenter_tpu_torch.models.native import ImportedModel
    from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn

    spec, params = build_patch_cnn(21, 3, 1, "full")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (512, 68, 21, 1)).astype(np.float32)).to(dev)
    models = {}
    for t in ("highest", tier):
        monkeypatch.setenv("ISS_CNN_PRECISION", t)
        models[t] = ImportedModel(spec, params).to(dev)
    with torch.no_grad():
        want = models["highest"](x)
        got = models[tier](x)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    err = float((got - want).abs().max())
    assert 0 < err <= 2e-2


@pytest.mark.parametrize("tier,bound", [("high", 1e-2), ("bf16", 5e-2)])
def test_xvec_tier_against_highest(dev, tier, bound):
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    net = ResNetXVector("bottleneck", (2, 2, 2, 2), 32, 64, 256)
    params = net.init_params(seed=1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 64, 144)).astype(np.float32)).to(dev)
    with torch.no_grad():
        want = net.load_jax_params(params).to(dev)(x).cpu().numpy()
        other = ResNetXVector("bottleneck", (2, 2, 2, 2), 32, 64, 256)
        got = other.load_jax_params(params).set_precision(tier).to(dev)(x) \
            .cpu().numpy()
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert 0 < rel.max() <= bound


def test_batch_score_at_another_tier_keeps_vad_and_features_exact(
        dev, small_models, tmp_path, monkeypatch):
    """The consumer runs the ResNet at ``high`` (TF32) while the producer
    threads run the VAD CNN and the VBx features at ``highest``: what the
    producers prepared equals a serial run's bit for bit, the scores equal
    one call per file, and the process's TF32 flags end as they began."""
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    monkeypatch.setenv("ISS_XVEC_PRECISION", "high")
    monkeypatch.setenv("ISS_PREFETCH", "3")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    net = ResNetXVector("bottleneck", (2, 2, 2, 2), 32, 64, 256)
    vfs = VoiceFemininityScoring("bgc", ffmpeg=None, device=dev,
                                 model_dir=small_models, xvector_net=net,
                                 xvector_params=net.init_params(seed=3),
                                 allow_download=False)
    assert vfs.xvector_model.net.precision == "high"
    wavs = []
    for i, seconds in enumerate((30.0, 45.0, 20.0, 60.0, 35.0, 25.0)):
        wavs.append(str(tmp_path / f"v{i}.wav"))
        write_wav(wavs[-1], to_int16(voiced(seconds, seed=40 + i,
                                            silences=[(2.0, 2.6)])), 16000)
    serial, prepared = vfs._prepare, {}

    def recording(path):
        prepared[path] = serial(path)
        return prepared[path]

    vfs._prepare = recording
    outs = [str(tmp_path / "out" / f"v{i}.csv") for i in range(len(wavs))]
    _, n_ok, _, _ = vfs.batch_score(wavs, outs)
    assert n_ok == len(wavs)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (False, True)
    for wav, out in zip(wavs, outs):
        name, fea, timeline, duration, speech = serial(wav)
        got = prepared[wav]
        assert (got[0], got[3], got[4]) == (name, duration, speech)
        assert got[2].intervals == timeline.intervals
        assert torch.equal(got[1], fea)
        want = vfs(wav)
        assert open(out).read().splitlines()[1] == "%s\t%s\t%d" % (
            "" if want[0] is None else repr(float(want[0])),
            repr(float(want[1])), want[2])


# -- the general-K Viterbi, the int16 VBx grid and the tail bucket ------------

@pytest.mark.parametrize("K", [4, 5, 7, 8, 13, 30, 31, 32, 33, 64])
@pytest.mark.parametrize("kind", ["random", "resets", "ties", "nan"])
def test_viterbi_general_kernel_bit_equal(dev, K, kind):
    args, want = _viterbi_case(K, kind, 2500, dev)
    g0, k0 = tv.viterbi_scan_general.launches, tv.viterbi_scan.launches
    got = tv.viterbi_scan(*args)
    torch.cuda.synchronize()
    assert tv.viterbi_scan_general.launches == g0 + 1
    assert tv.viterbi_scan.launches == k0
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("K,T", [(1, 50), (2, 4000), (3, 4000), (205, 300),
                                 (300, 200), (1100, 40), (30, 180_000),
                                 (32, 180_000)])
def test_viterbi_general_kernel_other_shapes(dev, K, T):
    """K <= 3 through the general wrapper; the transition matrix outside
    shared memory (K > 200); two-byte maps (K > 256); several states a
    thread (K > 1024); the main path's length, and at K = 32 summaries that
    outgrow block 0's staging area (chained a tile at a time)."""
    args, want = _viterbi_case(K, "resets" if K > 1 else "random", T, dev)
    got = tv.viterbi_scan_general(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _general_inputs(kind, T):
    return {"consecutive=10": lambda: consecutive_case((10, 10, 10), T),
            "constant": lambda: constant_case(30, T),
            "dense": lambda: dense_case(30, T),
            "constrained": lambda: constrained_case(8, T)}[kind]()


def _on(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("kind", ["consecutive=10", "constant", "dense",
                                  "constrained"])
def test_viterbi_general_counts_match_the_model(dev, kind):
    """States, passes and walked chunks equal the numpy model's at the
    kernel's own chunking; the two never-converging inputs run the passes
    to the cap and walk every chunk that they did not reach."""
    T = 20_000
    arrays = _general_inputs(kind, T)
    got = tv.viterbi_scan_general(*_on(dev, arrays))
    torch.cuda.synchronize()
    counts = (tv.pass_count(), tv.walked_chunks())
    K = arrays[0].shape[1]
    asked, L, P = tv.general_plan(T, K, tv._max_blocks(dev))
    ctl = tv.viterbi_scan_general.last_ctl.cpu().numpy()
    assert (ctl[5], ctl[6]) == (P, L)
    want, passes, walked = chunk_parallel_viterbi_general(*arrays, asked)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert counts == (passes, walked)
    if kind in ("consecutive=10", "constant"):
        assert counts == (PASS_CAP + 1, P - PASS_CAP - 1)
    else:
        assert walked == 0 and passes <= 8


def test_viterbi_general_consecutive_at_the_main_path_length(dev):
    """The smoke's decode, consecutive=10 on 3 states (K = 30), T = 180,000:
    it never converges, so the walk takes all but the cap's chunks."""
    args = _on(dev, consecutive_case((10, 10, 10), 180_000))
    got = tv.viterbi_scan_general(*args)
    want = tv.viterbi_scan_plain(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    P = int(tv.viterbi_scan_general.last_ctl[5])
    assert (tv.pass_count(), tv.walked_chunks()) == (PASS_CAP + 1,
                                                     P - PASS_CAP - 1)


@pytest.mark.parametrize("K", [4, 30, 33])
def test_viterbi_general_never_converging_constant(dev, K):
    args, want = _viterbi_case(K, "constant", 30_000, dev)
    got = tv.viterbi_scan(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert tv.pass_count() == PASS_CAP + 1 and tv.walked_chunks() > 0


def test_viterbi_general_kernel_largest_k(dev):
    """K = K_GENERAL_MAX (8 states a thread of a 1,024-thread block, the
    transitions read from device memory, two-byte maps) at a small T."""
    args, want = _viterbi_case(tv.K_GENERAL_MAX, "resets", 12, dev)
    got = tv.viterbi_scan_general(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_viterbi_decoding_on_the_card(dev):
    """The reference API: K = 30 after the duplication, and K = 8 with
    forbidden and mandatory frames and resets, equal to the CPU run."""
    rng = np.random.default_rng(3)
    for K, consecutive in ((3, 10), (8, None)):
        T = 6000
        em = np.log(rng.dirichlet(np.ones(K), T))
        tr = np.log(rng.dirichlet(np.ones(K) * 3, K))
        constraint = np.zeros((T, K), int)
        constraint[rng.random((T, K)) < 0.05] = tv.VITERBI_CONSTRAINT_FORBIDDEN
        constraint[rng.choice(T, 40, replace=False),
                   rng.integers(0, K, 40)] = tv.VITERBI_CONSTRAINT_MANDATORY
        kw = dict(consecutive=consecutive, constraint=constraint,
                  reset=rng.random(T) < 0.01)
        g0 = tv.viterbi_scan_general.launches
        got = tv.viterbi_decoding(em, tr, device=dev, **kw)
        assert tv.viterbi_scan_general.launches == g0 + 1
        np.testing.assert_array_equal(
            got, tv.viterbi_decoding(em, tr, device="cpu", **kw))


@pytest.mark.parametrize("seconds", [2.0, 20.0, 130.0])
def test_vbx_int16_grid_cuda_matches_cpu(dev, seconds):
    """The card's int16 grid against the CPU's, within the blocked bound;
    on the card, a stream in pieces and the online stream equal the whole
    signal's features bit for bit."""
    from inaspeechsegmenter_tpu_torch.dsp.vbx import (
        VBX_BLK, VbxFrontend, VbxPcmStream, VbxPcmStreamOnline, device_atol)

    sig = to_int16(speechlike(seconds, seed=int(seconds) + 1,
                              silences=[(0.5, 1.2)]))
    fe = VbxFrontend(dev)
    got = fe._features_i16(sig, len(sig))
    want = VbxFrontend("cpu")._features_i16(sig, len(sig)).numpy()
    assert got.device.type == "cuda" and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=device_atol(len(want), blocked=True))
    stream = VbxPcmStream(fe, len(sig))
    online = VbxPcmStreamOnline(fe)
    for pos in range(0, len(sig), 123_457):
        stream.append(sig[pos:pos + 123_457])
        online.append(torch.from_numpy(sig[pos:pos + 123_457]).to(dev))
        fr = online.frames_ready
        assert torch.equal(online.fea_buffer[:fr], got[:fr])
    assert torch.equal(stream.finish(), got)
    assert torch.equal(online.finalize(), got)
    if len(want) > VBX_BLK + 400:
        assert fr >= VBX_BLK


def test_tail_bucket_matches_ragged_forward(dev):
    """All windows of a file with 256 + 190 windows: the last sub-batch
    runs padded to 256, within 1e-4 relative L2 of the ragged forward."""
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
    from inaspeechsegmenter_tpu_torch.vfs import TorchResnetExtractor

    net = ResNetXVector("bottleneck", (2, 2, 2, 2), 32, 64, 256)
    xm = TorchResnetExtractor(net.init_params(seed=2), net, dev)
    nw = 256 + 190
    fea = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (144 + 24 * nw, 64)).astype(np.float32)).to(dev)
    starts = [24 * i for i in range(nw)]
    sizes = []
    hook = xm.net.register_forward_pre_hook(
        lambda mod, a: sizes.append(a[0].shape[0]))
    try:
        got = xm.embeddings_from_features(fea, starts)
    finally:
        hook.remove()
    assert sizes == [256, 256]
    idx = torch.tensor(starts[256:], device=dev)[:, None] + torch.arange(
        144, device=dev)[None, :]
    with torch.no_grad():
        ragged = xm.net(fea[idx].transpose(1, 2)).cpu().numpy()
    rel = (np.linalg.norm(got[256:] - ragged, axis=1)
           / np.linalg.norm(ragged, axis=1))
    assert rel.max() <= 1e-4


def test_batch_score_shared_pcm_in_producer_threads(dev, small_models,
                                                    tmp_path, monkeypatch):
    """On the card the VBx features take the int16 grid: the producers of
    ``batch_score`` compute each file's features from the VAD's own upload,
    equal bit for bit to ``_features_i16`` of the same samples, and the
    scores equal one call per file."""
    import threading

    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    monkeypatch.setenv("ISS_PREFETCH", "3")
    net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
    vfs = VoiceFemininityScoring("bgc", ffmpeg=None, device=dev,
                                 model_dir=small_models, xvector_net=net,
                                 xvector_params=net.init_params(seed=3),
                                 allow_download=False)
    calls = []
    real = vfs.features.features_from_pcm

    def spy(parts, n):
        calls.append((threading.current_thread().name, parts[0].device.type,
                      n))
        return real(parts, n)

    vfs.features.features_from_pcm = spy
    sigs, wavs = [], []
    for i, seconds in enumerate((30.0, 95.0, 20.0, 60.0, 35.0)):
        sigs.append(to_int16(voiced(seconds, seed=50 + i,
                                    silences=[(2.0, 2.6)])))
        wavs.append(str(tmp_path / f"p{i}.wav"))
        write_wav(wavs[-1], sigs[-1], 16000)
    prepared, serial = {}, vfs._prepare

    def recording(path):
        prepared[path] = serial(path)
        return prepared[path]

    vfs._prepare = recording
    outs = [str(tmp_path / "out" / f"p{i}.csv") for i in range(len(wavs))]
    _, n_ok, _, _ = vfs.batch_score(wavs, outs)
    assert n_ok == len(wavs)
    assert sorted(n for _, _, n in calls) == sorted(len(s) for s in sigs)
    assert {d for _, d, _ in calls} == {"cuda"}
    assert any(name != threading.main_thread().name for name, _, _ in calls)
    for sig, wav, out in zip(sigs, wavs, outs):
        fea = prepared[wav][1]
        assert torch.equal(fea, vfs.features._features_i16(sig, len(sig)))
        want = vfs(wav)
        assert open(out).read().splitlines()[1] == "%s\t%s\t%d" % (
            "" if want[0] is None else repr(float(want[0])),
            repr(float(want[1])), want[2])


# -- training ----------------------------------------------------------------

def _train_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 68, 21, 1)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _grads(trainer):
    from inaspeechsegmenter_tpu_torch.models.native import params_to_jax

    return params_to_jax(trainer.model.spec, {
        k: [None if t is None else t.grad for t in ts]
        for k, ts in trainer.model.tensors().items()})


def test_trainer_gradients_at_highest_match_cpu(dev, monkeypatch):
    from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
    from inaspeechsegmenter_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    spec, params = build_patch_cnn(21, 3, seed=0, size="full")
    x, y = _train_batch()
    runs = {}
    for d in (dev, "cpu"):
        t = Trainer(spec, params, learning_rate=0.0, device=d)
        assert t.precision == "highest"
        runs[d] = (t.train_step(x, y), _grads(t))
    assert runs[dev][0] == pytest.approx(runs["cpu"][0], rel=1e-5)
    for k, want in runs["cpu"][1].items():
        for g, w in zip(runs[dev][1][k], want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
    assert torch.backends.cudnn.allow_tf32


def test_trainer_fit_matches_cpu_and_serves(dev, tmp_path):
    import warnings

    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
    from inaspeechsegmenter_tpu_torch.train import Trainer

    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = _train_batch(n=96)
    t = Trainer(spec, params, device=dev)
    got = t.fit(x, y, epochs=1, batch_size=32)
    want = Trainer(spec, params, device="cpu").fit(x, y, epochs=1,
                                                   batch_size=32)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    t.export_model(str(tmp_path / "keras_speech_music_noise_cnn.npz"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        seg = Segmenter("smn", False, ffmpeg=None, device=dev,
                        model_dir=str(tmp_path), allow_download=False)
    sig = to_int16(speechlike(12.0, seed=43, silences=[(3.0, 3.5)]))
    lseg = seg.segment_signal(sig)
    assert lseg[0][1] == 0.0 and lseg[-1][2] == pytest.approx(11.98)


def test_trainer_bf16_step_uses_the_updated_weight(dev, monkeypatch):
    from inaspeechsegmenter_tpu_torch.models.keras_h5 import (
        strip_final_softmax)
    from inaspeechsegmenter_tpu_torch.models.native import ImportedModel
    from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
    from inaspeechsegmenter_tpu_torch.train import Trainer

    monkeypatch.setenv("ISS_CNN_PRECISION", "bf16")
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = _train_batch()
    t = Trainer(spec, params, learning_rate=1e-2, device=dev)
    t.train_step(x, y)
    fresh = ImportedModel(strip_final_softmax(spec), t.params).to(dev)
    stale = ImportedModel(strip_final_softmax(spec), params).to(dev)
    with torch.no_grad():
        xt = torch.from_numpy(x).to(dev)
        got, want, old = t.model(xt), fresh(xt), stale(xt)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert (got - old).abs().max() > 1e-2


def test_patch_dataset_cuda_matches_cpu(dev):
    from inaspeechsegmenter_tpu_torch.train import patch_dataset

    sig = speechlike(30.0, seed=41, silences=[(5.0, 5.8), (20.0, 20.2)])
    annot = [("speech", 0.0, 9.0), ("music", 9.0, 17.5), ("male", 17.5, 24.0),
             ("noise", 24.0, 30.0)]
    pairs = [(sig, annot), (sig[:16000 * 7], annot)]
    for engine in ("smn", "gender"):
        fe0 = fe_kernel.sidekit_features.launches
        got = patch_dataset(pairs, engine, return_times=True, device=dev)
        assert fe_kernel.sidekit_features.launches == fe0 + 2
        want = patch_dataset(pairs, engine, return_times=True, device="cpu")
        assert got[0].shape == want[0].shape and len(got[0]) > 0
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


# -- the multi-GPU engine on a mesh of two slots on one card ----------------------

def _card_mesh(dev, n=2):
    from inaspeechsegmenter_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[dev] * n)


def test_engine_on_two_slots_matches_segmenter(cuda_seg, tmp_path):
    """``ParallelEngine`` on ``[cuda:0, cuda:0]``: a group of files runs
    file k on slot k (its replica and its stream), a lone file spreads
    its timeline; csvs byte-equal the Segmenter's, labels equal its own
    per file."""
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.parallel import ParallelEngine

    engine = ParallelEngine(cuda_seg, _card_mesh(cuda_seg.device))
    wavs = []
    for i, seconds in enumerate((20.0, 25.0, 2.0, 65.0)):
        wavs.append(str(tmp_path / f"f{i}.wav"))
        write_wav(wavs[-1], to_int16(speechlike(seconds, seed=50 + i,
                                                silences=[(0.5, 1.2)])),
                  16000)
    outs = [str(tmp_path / "e" / f"f{i}.csv") for i in range(4)]
    ref = [str(tmp_path / "s" / f"f{i}.csv") for i in range(4)]
    fe0, vt0 = fe_kernel.sidekit_features.launches, tv.viterbi_scan.launches
    _, n_ok, _, _ = engine.batch_process(wavs, outs)
    assert n_ok == 4
    # one features launch and three decodes a file, whatever the slot
    assert fe_kernel.sidekit_features.launches == fe0 + 4
    assert tv.viterbi_scan.launches == vt0 + 12
    cuda_seg.batch_process(wavs, ref)
    for a, b in zip(outs, ref):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert engine(wavs[3]) == cuda_seg(wavs[3])


def test_run_sharded_matches_run_on_the_card(cuda_seg):
    from inaspeechsegmenter_tpu_torch.segmenter import patch_counts

    t = 40_000
    rng = np.random.default_rng(40)
    mspec = rng.standard_normal((t, 24)).astype(np.float32)
    loge = rng.standard_normal(t).astype(np.float32)
    loge[: t // 5] = -20.0
    loge[t // 2: t // 2 + t // 10] = -20.0
    m = torch.from_numpy(mspec).to(cuda_seg.device)
    lg = torch.from_numpy(loge).to(cuda_seg.device)
    nfp, n20 = patch_counts(t, 0)
    vt0 = tv.viterbi_scan.launches
    got = cuda_seg.pipeline.run_sharded(m, lg, t, nfp, n20,
                                        _card_mesh(cuda_seg.device))
    assert tv.viterbi_scan.launches == vt0 + 3     # the tail's decodes
    want = cuda_seg.pipeline.run(m, lg, t, nfp, n20)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_mesh_extractor_matches_one_slot(dev, monkeypatch):
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
    from inaspeechsegmenter_tpu_torch.vfs import TorchResnetExtractor

    monkeypatch.setenv("ISS_XVEC_BATCH", "16")
    net = ResNetXVector("bottleneck", (2, 2, 2, 2), 32, 64, 256)
    params = net.init_params(seed=3)
    one = TorchResnetExtractor(params, net, dev)
    two = TorchResnetExtractor(params, ResNetXVector(
        "bottleneck", (2, 2, 2, 2), 32, 64, 256), dev, mesh=_card_mesh(dev))
    fea = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1000, 64)).astype(np.float32)).to(dev)
    got, want = two("b", fea, 10.0), one("b", fea, 10.0)
    assert [(k, s) for k, s, _ in got] == [(k, s) for k, s, _ in want]
    a = np.stack([x for _, _, x in got])
    b = np.stack([x for _, _, x in want])
    rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    assert rel.max() <= 1e-4


def test_trainer_2x2_step_matches_one_slot(dev, tmp_path):
    """From one state (the one-slot trainer's checkpoint restored on the
    2 x 2 mesh before each step), every step's loss within 1e-5 relative
    and its summed gradients within 1e-4 of each array's largest
    magnitude (the card's gradient bound above): the same step up to
    float reassociation (free-running trajectories part faster: Adam
    amplifies it, see PERF.md)."""
    from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
    from inaspeechsegmenter_tpu_torch.parallel import make_2d_mesh
    from inaspeechsegmenter_tpu_torch.train import Trainer

    spec, params = build_patch_cnn(21, 3, seed=0, size="full")
    one = Trainer(spec, params, device=dev)
    mesh = Trainer(spec, params, make_2d_mesh(2, 2, devices=[dev] * 4))
    assert mesh.precision == "highest" and mesh._split
    ckpt = str(tmp_path / "one.npz")
    for seed in range(3):
        x, y = _train_batch(n=256, seed=seed)
        one.save_checkpoint(ckpt)
        mesh.restore_checkpoint(ckpt)
        got, want = mesh.train_step(x, y), one.train_step(x, y)
        assert got == pytest.approx(want, rel=1e-5)
        g_mesh = mesh._gathered(lambda p: p.grad)
        for k, arrays in one._gathered(lambda p: p.grad).items():
            for g, h in zip(arrays, g_mesh[k]):
                if g is not None:
                    torch.testing.assert_close(
                        h, g, rtol=0,
                        atol=1e-4 * float(g.abs().max()) + 1e-12)


def test_same_tier_scopes_overlap_on_two_streams(dev):
    """Two slot threads at one tier are inside their scopes at once, each
    launching on its own stream; the two cooperative Viterbi grids and the
    features kernel launched that way equal their plain versions."""
    import threading

    from inaspeechsegmenter_tpu_torch.models import layers as L
    from inaspeechsegmenter_tpu_torch.parallel.mesh import (run_on_slots,
                                                            slot_streams)

    devices = [dev, dev]
    streams = slot_streams(devices)
    assert streams[0] != streams[1]
    both = threading.Barrier(2, timeout=30)
    consts = sidekit.frontend_consts(dev)
    rng = np.random.default_rng(7)
    sig = torch.from_numpy(to_int16(speechlike(60.0, seed=8))).to(dev)
    T = 180_000
    em = torch.from_numpy(np.log(rng.dirichlet(np.ones(3), T)).astype(
        np.float32)).to(dev)
    trans = torch.from_numpy(diag_trans_exp(80, 3).astype(
        np.float32)).to(dev)
    init = torch.full((3,), float(np.log(1 / 3)), device=dev)
    reset = torch.zeros(T, dtype=torch.bool, device=dev)
    reset[::5000] = True

    def slot(k, _):
        with L.precision_scope("highest"):
            both.wait()
            assert torch.cuda.current_stream(dev) == streams[k]
            feats = fe_kernel.sidekit_features(sig, consts)
            states = tv.viterbi_scan(em, trans, init, reset)
            both.wait()
        return feats, states

    fe0, vt0 = fe_kernel.sidekit_features.launches, tv.viterbi_scan.launches
    out = run_on_slots(slot, [None, None], devices, streams)
    assert fe_kernel.sidekit_features.launches == fe0 + 2
    assert tv.viterbi_scan.launches == vt0 + 2
    want = tv.viterbi_scan_plain(em, trans, init, reset).cpu().numpy()
    m_plain, l_plain = fe_kernel.sidekit_features_plain(sig, consts)
    for (m, lg), states in out:
        np.testing.assert_array_equal(states.cpu().numpy(), want)
        torch.testing.assert_close(m, m_plain, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lg, l_plain, rtol=1e-5, atol=1e-5)


# -- the overlapped speculative VFS scorer -----------------------------------

def _overlap_vfs(dev, models, seed=7):
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
    return VoiceFemininityScoring("vfp", ffmpeg=None, device=dev,
                                  model_dir=models, xvector_net=net,
                                  xvector_params=net.init_params(seed=seed),
                                  allow_download=False)


def _overlap_signal(n):
    sec = n / 16000
    return to_int16(voiced(sec, seed=n % 97, silences=[
        (20.0, 23.0), (sec / 2, sec / 2 + 1.5), (sec - 9.0, sec - 8.2)]))


# 150 s: 4 chunks in 2 groups; 4 chunks' samples and 30 more: a 5th chunk
@pytest.mark.parametrize("n", [150 * 16000, (4 * 4096 + 2) * 160 + 30])
def test_overlapped_vfs_equals_serial_and_cpu(dev, small_models,
                                              monkeypatch, n):
    """On the card ``score_signal`` takes the serial schedule by default
    (``ISS_VFS_OVERLAP=auto``) and the overlapped scorer with
    ``ISS_VFS_OVERLAP=1``: its tuple equals the serial path's and the
    CPU's overlapped run's (both on the int16 grid), and it launches one
    features kernel a group and two Viterbi decodes for each chunk with a
    right neighbour, plus the final decode's two."""
    from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import GROUP_CHUNKS

    CHUNK, HOP = sidekit.CHUNK, sidekit.HOP
    sig = _overlap_signal(n)
    vfs = _overlap_vfs(dev, small_models)
    monkeypatch.delenv("ISS_VFS_OVERLAP", raising=False)
    vfs.overlap_stats = None
    serial = vfs.score_signal(sig)
    assert vfs.overlap_stats is None
    monkeypatch.setenv("ISS_VFS_OVERLAP", "1")
    chunks = -(-sidekit.frame_count(n) // CHUNK)
    chunks += n > (chunks * CHUNK + 2) * HOP
    vfs.score_signal(sig)                                    # warm
    fe0, vt0 = fe_kernel.sidekit_features.launches, tv.viterbi_scan.launches
    vfs.overlap_stats = None
    got = vfs.score_signal(sig)
    assert vfs.overlap_stats is not None
    assert fe_kernel.sidekit_features.launches - fe0 == -(-chunks
                                                          // GROUP_CHUNKS)
    assert tv.viterbi_scan.launches - vt0 == 2 * (chunks - 1) + 2
    assert serial == got and got[2] > 0
    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    assert vfs.score_signal(sig) == got
    monkeypatch.setenv("ISS_VFS_OVERLAP", "1")
    int16_grid_on_cpu(monkeypatch)
    cpu = _overlap_vfs("cpu", small_models)
    assert cpu.score_signal(sig) == got
    assert cpu.overlap_stats["needed"] == vfs.overlap_stats["needed"]


def test_overlapped_vfs_makes_no_host_sync(dev, small_models, monkeypatch):
    """From the first upload to the exact decode the scorer queues work
    and waits only on its own copies' events: no synchronizing call."""
    monkeypatch.setenv("ISS_VFS_OVERLAP", "1")
    vfs = _overlap_vfs(dev, small_models)
    sig = _overlap_signal(150 * 16000)
    want = vfs.score_signal(sig)             # warm: dither, cuDNN, pinned
    pipe = vfs.vad.pipeline
    real = pipe.stream_decode

    def decode(*args, **kwargs):
        torch.cuda.set_sync_debug_mode(0)
        return real(*args, **kwargs)

    pipe.stream_decode = decode
    torch.cuda.set_sync_debug_mode("error")
    try:
        vfs.overlap_stats = None
        got = vfs.score_signal(sig)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del pipe.stream_decode
    assert got == want and vfs.overlap_stats is not None


def test_embed_session_pinned_copies_equal_the_extractor(dev, small_models,
                                                         monkeypatch):
    """Speculative sub-batches read back from pinned memory after their
    events equal the extractor's own embeddings (1e-4 relative L2: batch
    sizes differ), pads dropped, misses caught up."""
    from inaspeechsegmenter_tpu_torch.vfs import _EmbedSession

    monkeypatch.setenv("ISS_XVEC_BATCH", "8")
    xm = _overlap_vfs(dev, small_models).xvector_model
    fea = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (144 + 24 * 40, 64)).astype(np.float32)).to(dev)
    sess = _EmbedSession(xm)
    for s in range(0, 24 * 21, 24):
        sess.queue(s, fea)
    sess.flush(fea)
    needed = list(range(0, 24 * 30, 48))
    got = np.stack(sess.collect(fea, needed))
    assert (sess.n_speculative, sess.n_needed, sess.n_caught_up) == (21, 15,
                                                                    4)
    want = xm.embeddings_from_features(fea, needed)
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert rel.max() <= 1e-4
