"""PyTorch port: what a deployment reads from its environment.

- ``$ISS_TRACE_DIR`` on the segmentation CLI writes a ``torch.profiler``
  trace of the run (the JAX CLI's ``jax_trace``); unset, nothing;
- ``$ISS_AUDIO_LIB`` names a prebuilt ``libissaudio`` that
  ``audio/native.py`` loads before building its own (the JAX package's
  order); a path that is missing or does not load passes to the port's
  own build;
- the package's own ``native/issaudio.cc`` is the repository's, byte for
  byte, so a wheel builds the same resampler;
- the build directories: the checkout's ``build/`` in a checkout, the user
  cache in an install, ``$ISS_TORCH_BUILD_DIR`` over both;
- the CLI's exit status: 0, or 1 when a file failed.
"""

import filecmp
import json
import os
import subprocess

import numpy as np
import pytest

from inaspeechsegmenter_tpu.audio import native as jnative
from inaspeechsegmenter_tpu_torch.audio import native as tnative
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.cli import segment
from inaspeechsegmenter_tpu_torch.utils import cuda_build
from torch_parity_helpers import speechlike, to_int16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = (8000, 22050, 44100)      # tests/test_torch_native.py's


def _fresh(monkeypatch, build_dir, audio_lib=None):
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(build_dir))
    if audio_lib is None:
        monkeypatch.delenv("ISS_AUDIO_LIB", raising=False)
    else:
        monkeypatch.setenv("ISS_AUDIO_LIB", str(audio_lib))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)


@pytest.fixture(scope="module")
def prebuilt(tmp_path_factory):
    """A ``libissaudio`` built here with ``g++`` from the repository's
    ``native/issaudio.cc``, as a host would prebuild it."""
    path = tmp_path_factory.mktemp("prebuilt") / "libissaudio.so"
    subprocess.run(["g++", *tnative.CXX_FLAGS, "-o", str(path),
                    os.path.join(REPO, "native", "issaudio.cc")], check=True)
    return path


@pytest.fixture(scope="module")
def own_build(tmp_path_factory):
    """The port's own build, made once into a scratch build directory."""
    d = tmp_path_factory.mktemp("own_build")
    mp = pytest.MonkeyPatch()
    _fresh(mp, d)
    assert tnative.available()
    yield d
    mp.undo()


# -- ISS_TRACE_DIR ----------------------------------------------------------

@pytest.fixture
def cli_wav(synthetic_model_dir, tmp_path):
    wav = str(tmp_path / "in.wav")
    write_wav(wav, to_int16(speechlike(3.0, seed=5, silences=[(1.0, 1.5)])),
              16000)
    return wav


def _run_cli(wav, out):
    os.makedirs(out)
    assert segment.main(["-i", wav, "-o", out, "-b", "none",
                         "--device", "cpu"]) == 0
    with open(os.path.join(out, "in.csv")) as fh:
        return fh.read()


def test_trace_dir_set_writes_a_trace(cli_wav, tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("ISS_TRACE_DIR", str(trace_dir))
    traced = _run_cli(cli_wav, str(tmp_path / "traced"))
    with open(trace_dir / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    monkeypatch.delenv("ISS_TRACE_DIR")
    assert _run_cli(cli_wav, str(tmp_path / "plain")) == traced


def test_trace_dir_unset_writes_nothing(cli_wav, tmp_path, monkeypatch):
    monkeypatch.delenv("ISS_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    before = set(os.listdir(tmp_path))
    _run_cli(cli_wav, str(tmp_path / "out"))
    assert set(os.listdir(tmp_path)) - before == {"out"}
    assert os.listdir(tmp_path / "out") == ["in.csv"]


def test_cli_exit_status_names_a_failed_file(cli_wav, tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    out = str(tmp_path / "out")
    os.makedirs(out)
    assert segment.main(["-i", cli_wav, str(bad), "-o", out, "-b", "none",
                         "--device", "cpu"]) == 1
    assert os.listdir(out) == ["in.csv"]


# -- ISS_AUDIO_LIB ----------------------------------------------------------

@pytest.mark.parametrize("sr", RATES)
def test_audio_lib_env_is_loaded_without_an_own_build(prebuilt, tmp_path,
                                                      monkeypatch, sr):
    _fresh(monkeypatch, tmp_path / "build", audio_lib=prebuilt)

    def no_build():
        raise AssertionError("built its own library despite ISS_AUDIO_LIB")

    monkeypatch.setattr(tnative, "build", no_build)
    lib = tnative.load_library()
    assert lib._name == str(prebuilt)
    assert not os.path.exists(tmp_path / "build")
    sig = speechlike(1.7 * sr / 16000, seed=sr)
    got = tnative.resample(sig, sr, 16000)
    assert jnative.available()
    np.testing.assert_array_equal(got, jnative.resample(sig, sr, 16000))


@pytest.mark.parametrize("kind", ["missing", "not a library"])
def test_audio_lib_env_that_does_not_load_passes_to_the_own_build(
        own_build, tmp_path, monkeypatch, kind):
    bad = tmp_path / "libissaudio.so"
    if kind == "not a library":
        bad.write_text("not an ELF file")
    _fresh(monkeypatch, own_build, audio_lib=bad)
    lib = tnative.load_library()
    assert lib._name == tnative.library_path()
    assert os.path.dirname(lib._name) == str(own_build)
    assert abs(len(tnative.resample(np.zeros(22050, np.float32), 22050))
               - 16000) <= 2


def test_package_source_is_the_repository_source():
    assert tnative.SOURCE == os.path.join(
        REPO, "inaspeechsegmenter_tpu_torch", "native", "issaudio.cc")
    assert filecmp.cmp(tnative.SOURCE,
                       os.path.join(REPO, "native", "issaudio.cc"),
                       shallow=False)


# -- build directories ------------------------------------------------------

BUILD_DIRS = [("torch_kernels", cuda_build.build_dir),
              ("native", tnative.build_dir)]


@pytest.mark.parametrize("name,build_dir", BUILD_DIRS)
def test_build_dir_in_a_checkout(monkeypatch, name, build_dir):
    monkeypatch.delenv("ISS_TORCH_BUILD_DIR", raising=False)
    assert build_dir() == os.path.join(REPO, "build", name)


@pytest.mark.parametrize("name,build_dir", BUILD_DIRS)
def test_build_dir_in_an_install(tmp_path, monkeypatch, name, build_dir):
    """An installed package's parent (site-packages) holds no
    ``pyproject.toml``: the build goes to the user cache."""
    site = tmp_path / "site"
    monkeypatch.setattr(cuda_build, "PKG_DIR",
                        str(site / "inaspeechsegmenter_tpu_torch"))
    monkeypatch.delenv("ISS_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert build_dir() == str(tmp_path / "xdg" /
                              "inaspeechsegmenter_tpu_torch" / name)
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build_dir() == str(tmp_path / "home" / ".cache" /
                              "inaspeechsegmenter_tpu_torch" / name)
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "mine"))
    assert build_dir() == str(tmp_path / "mine")


@pytest.mark.parametrize("name,build_dir", BUILD_DIRS)
def test_build_dir_env_overrides_the_checkout(tmp_path, monkeypatch, name,
                                              build_dir):
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "mine"))
    assert build_dir() == str(tmp_path / "mine")
