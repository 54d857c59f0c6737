"""PyTorch port: Segmenter end to end against the JAX Segmenter.

Both packages run on the same ``size="small"`` synthetic weights and the
same seeded signals.  Segment lists must be identical, csv and TextGrid
exports byte-equal.  The JAX side runs three end-to-end segmentations: a
short (<68-frame) signal and a ~20 s mix through its fused program, and a
45 s (two-chunk) signal through its streaming path, whose labels that
package documents as equal to its fused program's.
"""

import numpy as np
import pytest

from inaspeechsegmenter_tpu.export import seg2csv as jax_seg2csv
from inaspeechsegmenter_tpu.export import seg2textgrid as jax_seg2textgrid
from inaspeechsegmenter_tpu_torch import Segmenter, seg2csv, seg2textgrid
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from torch_parity_helpers import speechlike, to_int16


@pytest.fixture(scope="module")
def port_seg(synthetic_model_dir):
    return Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def jax_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    return JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                        allow_download=False)


def test_silence_is_noenergy(port_seg, tmp_path):
    path = str(tmp_path / "silence2sec.wav")
    write_wav(path, np.zeros(32000, np.int16), 16000)
    assert port_seg(path) == [("noEnergy", 0.0, 1.98)]


def test_short_signal_matches_jax(port_seg, jax_seg):
    sig = to_int16(speechlike(0.6, seed=21, quiet=0.0))
    with pytest.warns(UserWarning, match="short"):
        got = port_seg.segment_signal(sig)
    with pytest.warns(UserWarning, match="short"):
        want = jax_seg.segment_signal(sig)
    assert got == want
    assert got[-1][2] == pytest.approx(0.58)


def test_no_complete_frame_raises(port_seg):
    with pytest.raises(ValueError, match="too short"), \
            pytest.warns(UserWarning, match="short"):
        port_seg.segment_signal(np.zeros(300, np.int16))


def test_mix_matches_jax_with_byte_equal_exports(port_seg, jax_seg,
                                                 tmp_path):
    sig = to_int16(speechlike(20.0, seed=23, silences=[(4.0, 4.7),
                                                       (13.2, 13.5)]))
    wav = str(tmp_path / "mix20.wav")
    write_wav(wav, sig, 16000)
    want = jax_seg(wav)
    got = port_seg(wav)
    assert got == want
    labels = {lab for lab, _, _ in got}
    # the energy, VAD and gender decodes all shaped the result
    assert "noEnergy" in labels and labels & {"female", "male"}
    assert labels & {"music", "noise"}

    csv = str(tmp_path / "port.csv")
    dur, n_ok, avg, lmsg = port_seg.batch_process([wav], [csv])
    assert n_ok == 1 and lmsg[0][1] == 0 and lmsg[0][2].startswith("ok ")
    jax_seg2csv(want, str(tmp_path / "jax.csv"))
    assert (open(csv, "rb").read()
            == open(tmp_path / "jax.csv", "rb").read())
    assert seg2textgrid(got) == jax_seg2textgrid(want)


def test_two_chunk_signal_matches_jax_streaming(port_seg, jax_seg):
    # a 0.3 s island between silences: its patches all hold -inf rows, so
    # p = 0.5 there, which the VAD and gender decodes turn into speech and
    # then female (first index wins ties)
    sig = to_int16(speechlike(45.0, seed=23, silences=[(30.0, 31.0),
                                                       (31.3, 32.0)]))
    want = jax_seg.segment_signal(sig)
    got = port_seg.segment_signal(sig)
    assert got == want
    assert {"noEnergy", "female"} <= {lab for lab, _, _ in got}


def test_segment_feats_equals_segment_signal(port_seg):
    sig = to_int16(speechlike(20.0, seed=23, silences=[(4.0, 4.7),
                                                       (13.2, 13.5)]))
    mspec, loge, t = port_seg.frontend.mspec_loge(sig)
    want = [(lab, a + 12.5, b + 12.5)
            for lab, a, b in port_seg.segment_signal(sig)]
    assert port_seg.segment_feats(mspec.numpy(), loge.numpy(), 0,
                                  12.5) == want


def test_cli_writes_csv(synthetic_model_dir, tmp_path):
    from inaspeechsegmenter_tpu_torch.cli import segment

    wav = str(tmp_path / "in.wav")
    write_wav(wav, np.zeros(32000, np.int16), 16000)
    out = tmp_path / "out"
    out.mkdir()
    dur, n_ok, avg, lmsg = segment.main(
        ["-i", wav, "-o", str(out), "-b", "none", "--device", "cpu"])
    assert n_ok == 1
    assert (out / "in.csv").read_text() == (
        "labels\tstart\tstop\nnoEnergy\t0.0\t1.98\n")


def test_media_contract_without_ffmpeg(port_seg, synthetic_model_dir,
                                       tmp_path):
    from inaspeechsegmenter_tpu_torch.audio.wav import WavFormatError

    mp3 = tmp_path / "x.mp3"
    mp3.write_bytes(b"ID3\x03\x00" + bytes(2000))
    with pytest.raises(WavFormatError):
        port_seg(str(mp3))
    wav = str(tmp_path / "s.wav")
    write_wav(wav, np.zeros(16000, np.int16), 16000)
    with pytest.raises(NotImplementedError):
        port_seg(wav, start_sec=0.5)
    with pytest.raises(Exception, match="ffmpeg program not found"):
        Segmenter("smn", True, ffmpeg="/nonexistent/ffmpeg", device="cpu",
                  model_dir=synthetic_model_dir)


def test_seg2csv_byte_equal_to_pandas():
    import pandas as pd

    lseg = [("noEnergy", 0.0, 0.48), ("speech", 0.48, 22.480000000000002),
            ("music", 22.480000000000002, 1e-05 + 30), ("male", 31, 40.5)]
    want = pd.DataFrame.from_records(
        lseg, columns=["labels", "start", "stop"]).to_csv(sep="\t",
                                                         index=False)
    assert seg2csv(lseg) == want
    assert seg2csv([]) == pd.DataFrame.from_records(
        [], columns=["labels", "start", "stop"]).to_csv(sep="\t", index=False)


def test_batch_process_statuses(port_seg, tmp_path):
    wav = str(tmp_path / "a.wav")
    write_wav(wav, to_int16(speechlike(2.0, seed=24)), 16000)
    out = tmp_path / "out"
    missing = str(tmp_path / "missing.wav")
    dur, n_ok, avg, lmsg = port_seg.batch_process(
        [wav, missing], [str(out / "a.csv"), str(out / "m.csv")])
    assert n_ok == 1
    assert lmsg[0][1] == 0 and lmsg[1][1] == 2
    assert lmsg[1][2].startswith("error: ")
    assert open(out / "a.csv").readline() == "labels\tstart\tstop\n"
    again = port_seg.batch_process([wav], [str(out / "a.csv")],
                                   skipifexist=True)
    assert again[3] == [(str(out / "a.csv"), 1, "already exists")]


def test_cuda_device_without_card_raises(synthetic_model_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Segmenter("smn", True, ffmpeg=None, device="cuda",
                  model_dir=synthetic_model_dir)


@pytest.mark.parametrize("stage", ["SpeechMusic", "SpeechMusicNoise",
                                   "Gender", "TorchResnetExtractor"])
def test_stage_class_without_device_needs_a_card(synthetic_model_dir, stage):
    """Public stage classes default to ``cuda``: built without a device on a
    host with no card they raise instead of running on the CPU."""
    import torch

    from inaspeechsegmenter_tpu_torch import segmenter, vfs

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cls = getattr(segmenter, stage, None) or getattr(vfs, stage)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(model_dir=synthetic_model_dir)


@pytest.mark.parametrize("stage", ["VbxFrontend", "FusedPipeline"])
def test_frontend_and_pipeline_without_device_need_a_card(port_seg, stage):
    """``VbxFrontend`` and ``FusedPipeline`` default to ``cuda`` too."""
    import torch

    from inaspeechsegmenter_tpu_torch.dsp.vbx import VbxFrontend
    from inaspeechsegmenter_tpu_torch.pipeline import FusedPipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if stage == "VbxFrontend":
            VbxFrontend()
        else:
            FusedPipeline(port_seg.vad.as_pipeline_stage(),
                          port_seg.gender.as_pipeline_stage())
