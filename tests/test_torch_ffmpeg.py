"""PyTorch port: media decode through ffmpeg, and a Segmenter loaded from
Keras ``.hdf5`` files, against the JAX package.

No ffmpeg exists here, so a stand-in script built on the port's WAV reader
and numpy takes its place (as in ``tests/test_ffmpeg_path.py``): it checks
the flags the reference builds, applies ``-ss`` / ``-to``, resamples (FFT)
and streams a WAV with bogus RIFF sizes like ``ffmpeg ... pipe:1``.  Both
packages decode through the same stand-in to the same signal, and a
``Segmenter`` of each package built from the same ``.hdf5`` files gives an
identical lseg and a byte-equal csv, with and without the stand-in.
"""

import os
import shutil
import struct

import numpy as np
import pytest

from inaspeechsegmenter_tpu.audio import io as jio
from inaspeechsegmenter_tpu.export import seg2csv as jax_seg2csv
from inaspeechsegmenter_tpu_torch import Segmenter
from inaspeechsegmenter_tpu_torch.audio import io as tio
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.models.synthetic import (build_gender_mlp,
                                                           build_patch_cnn)
from torch_parity_helpers import (to_int16, voiced, write_fake_ffmpeg,
                                  write_spec_h5)

@pytest.fixture(scope="module")
def fake_ffmpeg(tmp_path_factory):
    return write_fake_ffmpeg(tmp_path_factory.mktemp("bin"))


@pytest.fixture(scope="module")
def wav_44k_stereo(tmp_path_factory):
    left = voiced(8.0, seed=31, silences=[(2.0, 2.6)])
    sig = np.stack([left, 0.5 * left], axis=1)
    from scipy.signal import resample_poly
    sig = resample_poly(sig, 441, 160, axis=0).astype(np.float32)
    path = str(tmp_path_factory.mktemp("media") / "mix44.wav")
    write_wav(path, np.clip(sig, -1, 1), 44100, subtype="FLOAT")
    return path


@pytest.mark.parametrize("window", [(None, None), (1.25, 6.5)])
def test_decode_matches_jax(fake_ffmpeg, wav_44k_stereo, window):
    start, stop = window
    got = tio.media2sig16kmono(wav_44k_stereo, start, stop,
                               ffmpeg=fake_ffmpeg, dtype="auto")
    want = jio.media2sig16kmono(wav_44k_stereo, start, stop,
                                ffmpeg=fake_ffmpeg, dtype="auto")
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    n = int((stop or 8.0) * 16000) - int((start or 0) * 16000)
    assert abs(len(got) - n) <= 2
    as_float = tio.media2sig16kmono(wav_44k_stereo, start, stop,
                                    ffmpeg=fake_ffmpeg, dtype="float32")
    np.testing.assert_array_equal(as_float, got / np.float32(32768))


def test_decode_errors(fake_ffmpeg, tmp_path, monkeypatch):
    with pytest.raises(RuntimeError):
        tio.media2sig16kmono(str(tmp_path / "missing.mp3"),
                             ffmpeg=fake_ffmpeg)
    assert tio.check_ffmpeg(None) is None
    assert tio.check_ffmpeg(fake_ffmpeg) == fake_ffmpeg
    with pytest.raises(Exception, match="ffmpeg program not found"):
        tio.check_ffmpeg(str(tmp_path / "no-such-binary"))
    wav = str(tmp_path / "s.wav")
    write_wav(wav, np.zeros(16000, np.int16), 16000)
    with pytest.raises(NotImplementedError, match="ffmpeg"):
        tio.media2sig16kmono(wav, start_sec=0.5, ffmpeg=None)
    write_wav(wav, np.zeros(8000, np.int16), 8000)
    # another rate than 16 kHz needs the native resampler; without a
    # compiler to build it, the reference's 16 kHz-only error
    from inaspeechsegmenter_tpu_torch.audio import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError, match="8000 Hz"):
        tio.media2sig16kmono(wav, ffmpeg=None)


def _riff(chunks, data=b"\x01\x00" * 40, data_size=0xFFFFFFFF):
    body = b"".join(cid + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                    for cid, p in chunks)
    return (b"RIFF" + b"\xff" * 4 + b"WAVE" + body + b"data"
            + struct.pack("<I", data_size) + data)


FMT = (b"fmt ", struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16))
BLOBS = {
    "short": b"RIFF\xff\xff\xff\xffWAVE",
    "streamed": _riff([FMT]),
    "list-with-data-text": _riff([FMT, (b"LIST", b"INFOISFT\x09\0\0\0data x")]),
    "odd-chunk": _riff([(b"JUNK", b"abc"), FMT]),
    "no-data": _riff([FMT])[:-88],
    "sized": _riff([FMT], data_size=80),
}


@pytest.mark.parametrize("name", list(BLOBS))
def test_fix_streamed_riff_matches_jax(name):
    blob = BLOBS[name]
    assert tio._fix_streamed_riff(blob) == jio._fix_streamed_riff(blob)


@pytest.fixture(scope="module")
def hdf5_models(tmp_path_factory):
    """The small synthetic set written as Keras ``.hdf5`` files, twice:
    one directory for each package (each writes its npz cache there)."""
    sets = {
        "keras_speech_music_cnn": build_patch_cnn(21, 2, 0, "small"),
        "keras_speech_music_noise_cnn": build_patch_cnn(21, 3, 1, "small"),
        "keras_male_female_cnn": build_patch_cnn(24, 2, 2, "small"),
        "interspeech2023_all": build_gender_mlp(seed=3),
        "interspeech2023_cvfr": build_gender_mlp(seed=4),
    }
    port = tmp_path_factory.mktemp("hdf5_port")
    for stem, (spec, params) in sets.items():
        write_spec_h5(str(port / f"{stem}.hdf5"), spec, params)
    jax_dir = tmp_path_factory.mktemp("hdf5_jax")
    for name in os.listdir(port):
        shutil.copy(port / name, jax_dir)
    return str(port), str(jax_dir)


def test_segmenter_from_hdf5_matches_jax(hdf5_models, fake_ffmpeg,
                                         wav_44k_stereo, tmp_path,
                                         monkeypatch):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    port_dir, jax_dir = hdf5_models
    port = Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=port_dir, allow_download=False)
    assert port.vad.model.path.endswith(".hdf5")
    assert port.gender.model.path.endswith(".hdf5")
    assert os.path.exists(os.path.join(port_dir,
                                       "keras_male_female_cnn.npz"))
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", jax_dir)
    jax = JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                       allow_download=False)

    wav = str(tmp_path / "mix8.wav")
    write_wav(wav, to_int16(voiced(8.0, seed=33, silences=[(3.0, 3.8)])),
              16000)
    cases = [(wav, None, None, None), (wav_44k_stereo, fake_ffmpeg, None, None),
             (wav_44k_stereo, fake_ffmpeg, 1.0, 7.0)]
    labels = set()
    for path, ffmpeg, start, stop in cases:
        port.ffmpeg = jax.ffmpeg = ffmpeg
        got = port(path, start_sec=start, stop_sec=stop)
        want = jax(path, start_sec=start, stop_sec=stop)
        assert got == want
        assert got[0][1] == (start or 0.0)
        labels |= {lab for lab, _, _ in got}
        if start is None:                   # batch_process takes no window
            csv = str(tmp_path / "port.csv")
            _, n_ok, _, _ = port.batch_process([path], [csv])
            assert n_ok == 1
            jax_seg2csv(want, str(tmp_path / "jax.csv"))
            assert (open(csv, "rb").read()
                    == open(tmp_path / "jax.csv", "rb").read())
    # the energy, VAD and gender decodes all shaped the results
    assert "noEnergy" in labels and labels & {"female", "male"}
