"""PyTorch port: the host SIDEKIT frontend and the frontend choice.

- ``dsp/host_fe.py::HostSidekitFrontend`` against the JAX package's (both
  numpy, the same code: equal within 1e-6) and against the kernel
  frontend's plain version (float32 DFTs summed in different orders:
  mspec rtol/atol 1e-4, loge 1e-5, on noise-based signals; finite masks
  equal), its ``-inf`` padding and the port's call shape.
- ``segmenter._default_frontend``: every ``ISS_FRONTEND`` value, ``auto``
  with a patched link probe and core count, the probe's TTL, and
  ``refresh_frontend`` flipping at ``batch_process``.
- Under ``ISS_FRONTEND=host`` the port's labels equal the JAX package's
  under its host frontend; the online segmenter becomes a passthrough and
  the VFS scorer takes its serial route.
"""

import contextlib

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.dsp.host_fe import (
    HostSidekitFrontend as JaxHostFrontend)
from inaspeechsegmenter_tpu_torch import segmenter as S
from inaspeechsegmenter_tpu_torch.dsp import fe_kernel, sidekit
from inaspeechsegmenter_tpu_torch.dsp.host_fe import HostSidekitFrontend
from torch_parity_helpers import speechlike, to_int16

SIGNALS = {
    "f32": lambda: speechlike(3.0, seed=41),
    "int16_silence": lambda: to_int16(speechlike(3.0, seed=42,
                                                 silences=[(1.0, 1.6)])),
    "f32_silence": lambda: speechlike(3.0, seed=43, silences=[(0.0, 0.5),
                                                             (2.2, 2.3)]),
    "f64": lambda: speechlike(2.0, seed=44).astype(np.float64),
}


@pytest.fixture(scope="module")
def host():
    return HostSidekitFrontend("cpu")


@pytest.mark.parametrize("kind", sorted(SIGNALS))
def test_matches_jax_host_frontend(host, kind):
    sig = SIGNALS[kind]()
    m, lg = host.mspec_loge_np(sig)
    m_j, l_j = JaxHostFrontend().mspec_loge_np(sig)
    fin = np.isfinite(m_j)
    np.testing.assert_array_equal(np.isfinite(m), fin)
    np.testing.assert_allclose(m[fin], m_j[fin], rtol=0, atol=1e-6)
    finl = np.isfinite(l_j)
    np.testing.assert_array_equal(np.isfinite(lg), finl)
    np.testing.assert_allclose(lg[finl], l_j[finl], rtol=0, atol=1e-6)
    mt, lt, t = host.mspec_loge(sig)
    assert mt.dtype == lt.dtype == torch.float32 and mt.device.type == "cpu"
    assert t == len(m) == sidekit.frame_count(len(sig))
    np.testing.assert_array_equal(mt.numpy(), m)
    np.testing.assert_array_equal(lt.numpy(), lg)


@pytest.mark.parametrize("kind", sorted(SIGNALS))
def test_matches_kernel_frontend_plain(host, kind):
    sig = SIGNALS[kind]()
    m, lg = host.mspec_loge_np(sig)
    mk, lk, t = fe_kernel.KernelSidekitFrontend("cpu").mspec_loge(sig)
    mk, lk = mk.numpy(), lk.numpy()
    assert mk.shape == m.shape and t == len(lg)
    fin = np.isfinite(mk)
    np.testing.assert_array_equal(np.isfinite(m), fin)
    np.testing.assert_allclose(m[fin], mk[fin], rtol=1e-4, atol=1e-4)
    finl = np.isfinite(lk)
    np.testing.assert_array_equal(np.isfinite(lg), finl)
    np.testing.assert_allclose(lg[finl], lk[finl], rtol=1e-5, atol=1e-5)


def test_padding_and_call_shape(host):
    sig = speechlike(1.0, seed=45)
    t_want = (16000 - 400) // 160 + 1
    m, lg, t = host.mspec_loge(sig, pad_frames_to=256)
    assert m.shape == (256, 24) and lg.shape == (256,) and t == t_want
    assert torch.isfinite(m[:t]).all()
    assert (m[t:] == -np.inf).all() and (lg[t:] == -np.inf).all()
    m2, lg2, t2, pcm = host.mspec_loge(to_int16(sig), keep_pcm=True,
                                       pinned=True)
    assert pcm is None and t2 == t_want and m2.shape == (t_want, 24)
    m3, _, t3 = host.mspec_loge(np.zeros(300, np.int16))
    assert t3 == 0 and m3.shape == (0, 24)
    assert not hasattr(host, "group_feats")
    assert not hasattr(host, "iter_group_feats")


# -- the choice ---------------------------------------------------------------

class _StubKernelFrontend:
    """Stands in for KernelSidekitFrontend on a CUDA device, whose
    constants cannot be built without a card."""

    def __init__(self, device):
        self.device = torch.device(device)


@pytest.fixture()
def probe(monkeypatch):
    """A patched link probe and core count; records the devices probed."""
    state = {"mbps": 100.0, "cores": 8, "probed": []}

    def fake(device, max_age_s=None):
        state["probed"].append(torch.device(device).type)
        return state["mbps"]

    monkeypatch.setattr(S, "_link_bandwidth_mbps", fake)
    monkeypatch.setattr(S.os, "cpu_count", lambda: state["cores"])
    monkeypatch.setattr(S, "KernelSidekitFrontend", _StubKernelFrontend)
    return state


@pytest.mark.parametrize("value,cls", [
    ("host", HostSidekitFrontend), ("jnp", _StubKernelFrontend),
    ("pallas", _StubKernelFrontend), ("kernel", _StubKernelFrontend)])
def test_explicit_choices(probe, monkeypatch, value, cls):
    monkeypatch.setenv("ISS_FRONTEND", value)
    for device in ("cpu", "cuda"):
        fe = S._default_frontend(device)
        assert type(fe) is cls and fe.device.type == device
    assert probe["probed"] == []


@pytest.mark.parametrize("mbps,cores,want", [
    (100.0, 8, HostSidekitFrontend),     # slow link, enough cores
    (100.0, 4, HostSidekitFrontend),
    (249.9, 8, HostSidekitFrontend),
    (250.0, 8, _StubKernelFrontend),     # fast enough link
    (25_000.0, 8, _StubKernelFrontend),
    (100.0, 3, _StubKernelFrontend),     # too few cores to hide the FFTs
])
def test_auto_on_cuda(probe, monkeypatch, mbps, cores, want):
    monkeypatch.delenv("ISS_FRONTEND", raising=False)
    probe.update(mbps=mbps, cores=cores)
    assert type(S._default_frontend("cuda")) is want
    assert probe["probed"] == (["cuda"] if cores >= 4 else [])


def test_auto_on_cpu_never_probes(probe, monkeypatch):
    monkeypatch.setenv("ISS_FRONTEND", "auto")
    assert type(S._default_frontend("cpu")) is _StubKernelFrontend
    assert probe["probed"] == []


def test_link_probe_ttl(monkeypatch):
    """Cached for ISS_LINK_PROBE_TTL seconds, probed again after."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(S.time, "monotonic", lambda: clock["t"])
    monkeypatch.setattr(S, "_LINK_MBPS", {})
    monkeypatch.setenv("ISS_LINK_PROBE_TTL", "600")
    v1 = S._link_bandwidth_mbps("cpu")
    assert v1 > 0 and S._LINK_MBPS["cpu"] == (v1, 1000.0)
    clock["t"] = 1599.0
    assert S._link_bandwidth_mbps("cpu") == v1
    assert S._LINK_MBPS["cpu"][1] == 1000.0            # not probed again
    clock["t"] = 1601.0
    S._link_bandwidth_mbps("cpu")
    assert S._LINK_MBPS["cpu"][1] == 1601.0            # expired: probed
    clock["t"] = 1700.0
    S._link_bandwidth_mbps("cpu", max_age_s=50.0)
    assert S._LINK_MBPS["cpu"][1] == 1700.0
    clock["t"] = 9e9
    S._link_bandwidth_mbps("cpu", max_age_s=float("inf"))
    assert S._LINK_MBPS["cpu"][1] == 1700.0


@pytest.fixture(scope="module")
def port_seg(synthetic_model_dir):
    return S.Segmenter("smn", True, ffmpeg=None, device="cpu",
                       model_dir=synthetic_model_dir)


def test_refresh_frontend_flips_at_batch_process(port_seg, monkeypatch,
                                                 tmp_path):
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav

    monkeypatch.delenv("ISS_FRONTEND", raising=False)
    fe = port_seg.frontend
    assert isinstance(fe, fe_kernel.KernelSidekitFrontend)
    assert port_seg.refresh_frontend() is fe         # same choice: no swap
    monkeypatch.setattr(S, "_default_frontend",
                        lambda device: HostSidekitFrontend(device))
    monkeypatch.setenv("ISS_FRONTEND", "host")
    assert port_seg.refresh_frontend() is fe         # explicit: a no-op
    monkeypatch.setenv("ISS_FRONTEND", "auto")
    wav = str(tmp_path / "x.wav")
    write_wav(wav, to_int16(speechlike(3.0, seed=46)), 16000)
    try:
        res = port_seg.batch_process([wav], [str(tmp_path / "x.csv")])
        assert res[1] == 1
        assert isinstance(port_seg.frontend, HostSidekitFrontend)
        assert port_seg.frontend.device == port_seg.device
    finally:
        port_seg.frontend = fe


# -- end to end ---------------------------------------------------------------

@pytest.fixture(scope="module")
def host_segs(synthetic_model_dir):
    """The port's and the JAX package's Segmenter, both built under
    ISS_FRONTEND=host."""
    import os

    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    old = os.environ.get("ISS_FRONTEND")
    os.environ["ISS_FRONTEND"] = "host"
    try:
        port = S.Segmenter("smn", True, ffmpeg=None, device="cpu",
                           model_dir=synthetic_model_dir)
        jx = JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                          allow_download=False)
    finally:
        if old is None:
            os.environ.pop("ISS_FRONTEND", None)
        else:
            os.environ["ISS_FRONTEND"] = old
    assert isinstance(port.frontend, HostSidekitFrontend)
    assert type(jx.frontend).__name__ == "HostSidekitFrontend"
    return port, jx


@pytest.mark.parametrize("seconds", [0.6, 20.0, 45.0])
def test_labels_match_jax_host_frontend(host_segs, seconds, tmp_path):
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav

    port, jx = host_segs
    sig = to_int16(speechlike(seconds, seed=47, quiet=0.0 if seconds < 1
                              else 0.25, silences=[(3.0, 3.5)]))
    path = str(tmp_path / "h.wav")
    write_wav(path, sig, 16000)
    with pytest.warns(UserWarning, match="short") if seconds < 1 else \
            contextlib.nullcontext():
        assert port(path) == jx(path)


def test_online_is_a_passthrough(host_segs):
    from inaspeechsegmenter_tpu_torch import OnlineSegmenter

    port, _ = host_segs
    sig = to_int16(speechlike(50.0, seed=48, silences=[(10.0, 12.0)]))
    online = OnlineSegmenter(port)
    for pos in range(0, len(sig), 16000 * 9):
        online.feed(sig[pos:pos + 16000 * 9])
        assert online.chunks_ready == 0
    assert online.buffered_samples == len(sig)
    assert online.current() == online.finalize() == port.segment_signal(sig)


def test_vfs_takes_the_serial_route(host_segs, monkeypatch):
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring

    port, _ = host_segs
    monkeypatch.setenv("ISS_VFS_OVERLAP", "1")
    vfs = VoiceFemininityScoring.__new__(VoiceFemininityScoring)
    vfs.vad = port
    assert not vfs._overlap_eligible()
