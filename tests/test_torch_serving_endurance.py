"""PyTorch port: a long corpus through one ``Segmenter`` keeps no
per-file state.

Counterpart of ``tests/test_serving_endurance.py``: after a first batch
has warmed the ``Segmenter``, eight more same-shaped files must not grow
the Python heap (``tracemalloc``: the status tuples and csv paths are the
only per-file state, and the caller owns them) nor the live
``torch.Tensor`` objects (a leaked per-file feature or emission tensor
would pile up on the device over a corpus).  The JAX test's jit-cache
half does not apply: the port compiles no program per shape.  Exact
counters, not timings.  ``chip_smoke.py`` phase 10 holds the card's
``torch.cuda.memory_allocated`` flat across the same corpus.
"""

import gc
import tracemalloc

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch import Segmenter
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav


def live_tensors():
    gc.collect()
    return sum(1 for o in gc.get_objects()
               if issubclass(type(o), torch.Tensor))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 two-second PCM16 files (noise, tones, silence), the JAX test's."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    files = []
    for i in range(16):
        n = 2 * 16000
        sig = np.zeros(n, np.float32)
        kind = i % 3
        if kind == 0:
            sig = rng.standard_normal(n).astype(np.float32) * 0.1
        elif kind == 1:
            t = np.arange(n, dtype=np.float32) / 16000.0
            sig = (np.sin(2 * np.pi * 220.0 * (i + 1) * t) * 0.2
                   ).astype(np.float32)
        pcm = np.clip(np.rint(sig * 32768.0), -32768, 32767).astype(np.int16)
        p = str(d / f"f{i:02d}.wav")
        write_wav(p, pcm, 16000)
        files.append(p)
    return files


def test_long_corpus_steady_state(synthetic_model_dir, corpus, tmp_path):
    seg = Segmenter("smn", True, ffmpeg=None, device="cpu",
                    allow_download=False)

    def run(tag, files):
        outs = [str(tmp_path / f"{tag}_{i}.csv") for i in range(len(files))]
        _, n_ok, _, lmsg = seg.batch_process(files, outs)
        assert n_ok == len(files), lmsg
        return outs

    run("warm", corpus[:8])
    base_live = live_tensors()
    tracemalloc.start()
    snap0 = tracemalloc.take_snapshot()
    run("steady", corpus[8:])
    gc.collect()
    snap1 = tracemalloc.take_snapshot()
    tracemalloc.stop()

    # no tensor accumulation: every per-file tensor is released
    grow = live_tensors() - base_live
    assert grow <= 0, (f"{grow} tensors accumulated over 8 steady-state "
                       f"files (base {base_live})")
    # bounded Python-heap growth (8 MiB would be ~1 MiB per 2 s file)
    heap = sum(st.size_diff for st in snap1.compare_to(snap0, "filename"))
    assert heap < (8 << 20), (
        f"python heap grew {heap / 1e6:.1f} MB over 8 steady-state files")


def test_repeat_calls_keep_no_tensors(synthetic_model_dir, corpus):
    """Single-file serving (``seg(path)`` in a loop, the farm client's
    inner shape) is leak-free too."""
    seg = Segmenter("smn", True, ffmpeg=None, device="cpu",
                    allow_download=False)
    first = seg(corpus[0])
    assert first
    base_live = live_tensors()
    for p in corpus[1:6]:
        assert seg(p)
    assert live_tensors() <= base_live
    assert seg(corpus[0]) == first
