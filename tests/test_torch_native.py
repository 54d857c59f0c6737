"""PyTorch port: the native resampler (``audio/native.py``) against the JAX
package's bindings.

The port builds ``native/issaudio.cc`` itself, here with the host ``g++``,
into a build directory of its own (never the JAX package's library), so
both sides run the same C++ source: resampled signals are array-equal,
and so are the signals ``media2sig16kmono(ffmpeg=None)`` decodes from 8,
22.05 and 44.1 kHz WAVs.  A failed build raises with the compiler's
output; with no compiler, a WAV at another rate than 16 kHz raises the
reference's 16 kHz-only error.
"""

import os
import stat

import numpy as np
import pytest

from inaspeechsegmenter_tpu.audio import io as jio
from inaspeechsegmenter_tpu.audio import native as jnative
from inaspeechsegmenter_tpu_torch.audio import io as tio
from inaspeechsegmenter_tpu_torch.audio import native as tnative
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from torch_parity_helpers import speechlike, to_int16

RATES = (8000, 22050, 44100)


def _fresh(monkeypatch, build_dir):
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(build_dir))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library, built once into a scratch build directory."""
    d = tmp_path_factory.mktemp("native_build")
    mp = pytest.MonkeyPatch()
    _fresh(mp, d)
    assert tnative.available()
    yield d
    mp.undo()


@pytest.fixture
def port_lib(built, monkeypatch):
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(built))
    return tnative.load_library()


def test_library_built_under_the_port_build_dir(built, port_lib):
    path = tnative.library_path()
    assert os.path.dirname(path) == str(built)
    assert os.path.basename(path).startswith("libissaudio_")
    assert port_lib._name == path
    jax_lib = os.path.join(os.path.dirname(jnative.__file__),
                           "libissaudio.so")
    assert os.path.realpath(port_lib._name) != os.path.realpath(jax_lib)
    assert tnative.build() == path        # present: no second compile


@pytest.mark.parametrize("sr", RATES)
def test_resample_matches_jax(port_lib, sr):
    assert jnative.available()
    # 1.7 s at rate sr
    sig = speechlike(1.7 * sr / 16000, seed=sr)
    got = tnative.resample(sig, sr, 16000)
    want = jnative.resample(sig, sr, 16000)
    assert got.dtype == np.float32 and abs(len(got) - 1.7 * 16000) <= 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("channels", [1, 2])
def test_media2sig_without_ffmpeg_resamples_like_jax(port_lib, tmp_path, sr,
                                                     channels):
    n = int(2.3 * sr)
    mono = to_int16(speechlike(2.3, seed=sr + channels))
    mono = np.interp(np.arange(n) * (len(mono) / n), np.arange(len(mono)),
                     mono).astype(np.int16)
    data = mono if channels == 1 else np.stack([mono, mono // 2], axis=1)
    wav = str(tmp_path / f"x{sr}.wav")
    write_wav(wav, data, sr)
    for dtype in ("float32", "float64", "int16", "auto"):
        got = tio.media2sig16kmono(wav, ffmpeg=None, dtype=dtype)
        want = jio.media2sig16kmono(wav, ffmpeg=None, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert abs(len(got) - 2.3 * 16000) <= 2


def test_decode_to_16k_mono_matches_jax(port_lib, tmp_path):
    wav = str(tmp_path / "x.wav")
    write_wav(wav, to_int16(speechlike(1.0, seed=4)), 22050)
    with open(wav, "rb") as fh:
        blob = fh.read()
    assert tnative.wav_info(blob) == jnative.wav_info(blob)
    np.testing.assert_array_equal(tnative.decode_to_16k_mono(wav),
                                  jnative.decode_to_16k_mono(wav))
    np.testing.assert_array_equal(tnative.decode_to_16k_mono(blob),
                                  jnative.decode_to_16k_mono(blob))
    assert tnative.wav_info(b"not a wav") is None


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    cxx = tmp_path / "bad-cxx"
    cxx.write_text("#!/bin/sh\necho 'issaudio.cc:1: error: no way' >&2\n"
                   "exit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    _fresh(monkeypatch, tmp_path / "b")
    with pytest.raises(RuntimeError, match="no way"):
        tnative.load_library()
    assert not os.path.exists(tnative.library_path())


def test_no_compiler_keeps_the_16k_only_contract(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "find_cxx", lambda: None)
    _fresh(monkeypatch, tmp_path / "b")
    assert not tnative.available()
    wav = str(tmp_path / "x.wav")
    write_wav(wav, np.zeros(22050, np.int16), 22050)
    with pytest.raises(ValueError, match="22050 Hz"):
        tio.media2sig16kmono(wav, ffmpeg=None)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.resample(np.zeros(10, np.float32), 22050)
    write_wav(wav, np.ones(1600, np.int16), 16000)
    assert tio.media2sig16kmono(wav, ffmpeg=None, dtype="auto").dtype == \
        np.int16
