"""PyTorch port: ``tools.prewarm``, the counterpart of ``tools/prewarm.py``.

It builds and loads the CUDA kernel library, then the native audio
library, then runs one short seeded signal through a ``Segmenter`` of
each engine, printing the seconds of each step.  Without ``nvcc`` or
without a card (the default device is ``cuda``) it raises; it never
falls back to the CPU.  The engine step is held to the JAX package's
``Segmenter`` on the same signal.
"""

import os

import pytest

import inaspeechsegmenter_tpu_torch as port
from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter
from inaspeechsegmenter_tpu_torch.audio import native as tnative
from inaspeechsegmenter_tpu_torch.tools import prewarm
from inaspeechsegmenter_tpu_torch.utils import cuda_build


def test_raises_without_nvcc(tmp_path, monkeypatch):
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this host has nvcc at its default place")
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(empty))
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        prewarm.main(["--device", "cpu"])


def test_default_device_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prewarm.main([])


def test_steps_with_stand_in_kernels(synthetic_model_dir, tmp_path,
                                     monkeypatch, capsys):
    """The CUDA library replaced by stand-ins (no nvcc here), the native
    library built for real into the build directory, both engines warmed
    on the CPU."""
    calls = []
    monkeypatch.setattr(cuda_build, "build",
                        lambda: calls.append("build") or "libstandin.so")
    monkeypatch.setattr(cuda_build, "library",
                        lambda: calls.append("library"))
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("ISS_AUDIO_LIB", raising=False)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    assert prewarm.main(["--device", "cpu", "--engines",
                         "smn+gender,sm"]) == 0
    assert calls == ["build", "library"]
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[prewarm]")]
    assert lines[0] == f"[prewarm] package {port.__file__}"
    assert "CUDA kernels built and loaded in" in lines[1]
    assert "native audio library built and loaded in" in lines[2]
    assert tnative.library_path() in lines[2]
    assert lines[3].startswith("[prewarm] smn+gender on cpu: ")
    assert lines[4].startswith("[prewarm] sm on cpu: ")
    assert lines[-1] == f"[prewarm] build directory {tmp_path / 'build'}"


@pytest.mark.parametrize("spec", ["smn+gender", "sm", "smn"])
def test_warm_engine_matches_jax(synthetic_model_dir, spec):
    engine, _, gender = spec.partition("+")
    want = JaxSegmenter(vad_engine=engine, detect_gender=bool(gender),
                        ffmpeg=None).segment_signal(prewarm.warm_signal())
    assert prewarm.warm_engine(spec, "cpu") == want


@pytest.mark.parametrize("spec", ["smn+age", "noise", "sm+gender+x"])
def test_warm_engine_rejects_unknown_engines(spec):
    with pytest.raises(ValueError, match="unknown engine"):
        prewarm.warm_engine(spec, "cpu")
