"""PyTorch port: runs without jax, optax, pandas or h5py, and without the
JAX package.

The machine with the GPU has none of them, so the port must neither import
them (at module level, on the segmentation, VFS, online, scoring, training,
job-farm or multi-GPU engine path) nor name jax, optax, pandas, h5py or the
JAX package ``inaspeechsegmenter_tpu`` in an import anywhere in its sources
or in ``chip_smoke.py``: neither on those paths nor on the reference's
import paths (``io``, ``remote_utils``, ``viterbi_utils``,
``pyannote_viterbi``, ``features_vbx``, ``vbx_segmenter``, ``resnet``,
``export_funcs``, ``thread_returning``, ``sidekit_mfcc``) and the
overlapped VFS scorer.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "inaspeechsegmenter_tpu_torch")

CODE = r"""
import os
import sys
sys.modules["h5py"] = None               # importing h5py now raises
import numpy as np
import inaspeechsegmenter_tpu_torch as port
from inaspeechsegmenter_tpu_torch.cli import segment
from inaspeechsegmenter_tpu_torch.models.synthetic import install_synthetic_models
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav

install_synthetic_models("models", size="small")
rng = np.random.default_rng(0)
sig = (rng.standard_normal(16000 * 3) * 3000).astype(np.int16)
sig[16000:24000] = 0
write_wav("t.wav", sig, 16000)
seg = port.Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir="models")
lseg = seg("t.wav")
assert lseg[0][1] == 0.0 and abs(lseg[-1][2] - 2.98) < 1e-9, lseg
from inaspeechsegmenter_tpu_torch.parallel import ParallelEngine, make_mesh
engine = ParallelEngine(seg, make_mesh(devices=["cpu"] * 2))
assert engine("t.wav") == lseg
assert engine.batch_process(["t.wav"] * 3,
                            ["e0.csv", "e1.csv", "e2.csv"])[1] == 3
from inaspeechsegmenter_tpu_torch.cli import vfs  # noqa: F401
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
scorer = port.VoiceFemininityScoring("bgc", ffmpeg=None, device="cpu",
                                     model_dir="models",
                                     xvector_net=net,
                                     xvector_params=net.init_params(seed=0))
score, dur, n = scorer("t.wav")
assert dur >= 0 and n >= 0, (score, dur, n)
long = np.tile(sig, 30)             # 90 s: three chunks, streamed at finalize
online = port.OnlineSegmenter(seg)
for pos in range(0, len(long), 16000 * 10):
    online.feed(long[pos:pos + 16000 * 10])
    online.current()
assert online.finalize() == seg.segment_signal(long)
assert online.chunks_ready == 3, online.chunks_ready
# a released-layout Keras .hdf5, read without h5py, then from its npz cache
sys.path.insert(0, os.path.join(os.environ["PYTHONPATH"], "tests"))
from torch_parity_helpers import write_spec_h5
from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
os.makedirs("h5models")
write_spec_h5("h5models/keras_speech_music_noise_cnn.hdf5",
              *build_patch_cnn(21, 3, 1, "small"))
vads = [port.Segmenter("smn", False, ffmpeg=None, device="cpu",
                       model_dir=d, allow_download=False)
        for d in ("h5models", "h5models", "models")]
assert [v.vad.model.path.rsplit(".", 1)[1] for v in vads] == \
    ["hdf5", "npz", "npz"]
assert vads[0]("t.wav") == vads[1]("t.wav") == vads[2]("t.wav")
bad = [m for m in ("jax", "jaxlib", "pandas", "h5py",
                   "inaspeechsegmenter_tpu") if sys.modules.get(m)]
assert not bad, bad
print("NO-JAX-OK")
"""


CODE_REFERENCE_API = r"""
import os
import sys
sys.modules["h5py"] = None
import numpy as np
import torch
import inaspeechsegmenter_tpu_torch as port
from inaspeechsegmenter_tpu_torch import segmenter as tseg
from inaspeechsegmenter_tpu_torch.audio import native
from inaspeechsegmenter_tpu_torch.audio.io import media2sig16kmono
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.decode.viterbi import viterbi_decoding
from inaspeechsegmenter_tpu_torch.dsp import vbx, vbx_host
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from inaspeechsegmenter_tpu_torch.models.synthetic import install_synthetic_models
from inaspeechsegmenter_tpu_torch.utils.timing import StageTimers

vbx.vbx_i16_enabled = lambda device: True       # the grid, also on the CPU
install_synthetic_models("models", size="small")
rng = np.random.default_rng(0)
em = np.log(rng.dirichlet(np.ones(3), 200))
states = viterbi_decoding(em, np.log(np.full((3, 3), 1 / 3)), consecutive=4,
                          device="cpu")
assert states.shape == (200,)
sig = (rng.standard_normal(16000 * 5) * 3000).astype(np.int16)
stage = tseg.SpeechMusicNoise(32, False, device="cpu", model_dir="models")
seg = port.Segmenter("smn", False, None, device="cpu", model_dir="models")
m = seg._sig2feats(sig)[0]
lseg = stage(m, [("energy", 0, 100), ("noEnergy", 100, 250)])
assert lseg[-1] == ("noEnergy", 100, 250), lseg
assert seg.timers.summary()["features"]["calls"] == 1
fe = vbx.VbxFrontend("cpu")
whole = fe._features_i16(sig, len(sig))
assert torch.equal(fe.features_from_pcm([torch.from_numpy(sig)], len(sig)),
                   whole)
vbx_host.get_features(sig / 32768.0)
net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
scorer = port.VoiceFemininityScoring("bgc", "jax", False,
                                     net.init_params(seed=0), net, None,
                                     device="cpu", model_dir="models")
online = port.OnlineVFS(scorer)
for pos in range(0, len(sig), 16000):
    online.feed(sig[pos:pos + 16000])
    online.current()
assert online._use_stream and online.buffered_samples == 0
assert online.finalize() == scorer.score_signal(sig)
write_wav("x22.wav", sig[:22050], 22050)
x = media2sig16kmono("x22.wav", ffmpeg=None, dtype="int16")
assert abs(len(x) - 16000) <= 2 and native.available()
assert native.library_path().startswith(os.environ["ISS_TORCH_BUILD_DIR"])
bad = [m for m in ("jax", "jaxlib", "pandas", "h5py",
                   "inaspeechsegmenter_tpu") if sys.modules.get(m)]
assert not bad, bad
print("NO-JAX-OK")
"""


def test_reference_api_int16_grid_and_resampler_without_jax(tmp_path):
    """viterbi_decoding, DnnSegmenter.__call__, the timers, the int16 VBx
    grid (VFS and OnlineVFS), vbx_host and the resampler's build, in a
    process without jax."""
    env = dict(os.environ, PYTHONPATH=REPO,
               ISS_TORCH_BUILD_DIR=str(tmp_path / "build"))
    r = subprocess.run([sys.executable, "-c", CODE_REFERENCE_API],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO-JAX-OK" in r.stdout


def test_port_runs_without_jax_pandas_h5py(tmp_path):
    """Segmentation, VFS, online segmentation and a Keras ``.hdf5`` model
    load in a process where importing h5py fails."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", CODE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO-JAX-OK" in r.stdout


def test_no_source_imports_jax_pandas_or_h5py():
    # ``inaspeechsegmenter_tpu`` followed by a word character is the port
    pat = re.compile(r"^\s*(import|from)\s+"
                     r"(jax|jaxlib|optax|pandas|h5py|inaspeechsegmenter_tpu)"
                     r"\b", re.MULTILINE)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            if pat.search(fh.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
    assert pat.search("from inaspeechsegmenter_tpu.online import x")
    assert pat.search("    import pandas as pd")
    assert pat.search("import optax")
    assert not pat.search("from inaspeechsegmenter_tpu_torch import x")


CODE_TRAIN_SCORE_FARM = r"""
import os
import sys
import warnings
for m in ("jax", "jaxlib", "optax", "pandas", "h5py",
          "inaspeechsegmenter_tpu"):
    sys.modules[m] = None                # importing them now raises
import numpy as np
from inaspeechsegmenter_tpu_torch import Segmenter, eval as ev, seg2csv
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.cli import client, evaluate, server, setjobs
from inaspeechsegmenter_tpu_torch.models import synthetic
from inaspeechsegmenter_tpu_torch.models.registry import load_patch_model
from inaspeechsegmenter_tpu_torch.parallel import (JobClient, JobServer,
                                                   client_work_loop)
from inaspeechsegmenter_tpu_torch.train import (ENGINES, Trainer,
                                                class_weights, patch_dataset)

synthetic.install_synthetic_models("models", size="small")
rng = np.random.default_rng(0)
sig = (rng.standard_normal(16000 * 6) * 3000).astype(np.int16)
sig[16000:24000] = 0
write_wav("t.wav", sig, 16000)
seg = Segmenter("smn", True, ffmpeg=None, device="cpu", model_dir="models")
os.makedirs("out")
with open("jobs.csv", "w") as fh:
    fh.write("source_path,dest_path\nt.wav,out/t.csv\nt.wav , out/t.csv\n")
tcp, uri = JobServer("jobs.csv").serve(host="127.0.0.1", port=0)
ret = client_work_loop(uri, seg, hostname="w")
tcp.shutdown()
tcp.server_close()
assert ret[1] == 1, ret
lseg = ev.load_segmentation("out/t.csv")
assert lseg == seg("t.wav") and ev.frame_diff("out/t.csv", lseg) == 0.0
x, y = patch_dataset([("t.wav", "out/t.csv")], "smn", ffmpeg=None,
                     stride=4, device="cpu")
model = load_patch_model("keras_speech_music_noise_cnn.hdf5", "models")
t = Trainer(model.spec, model.params, class_weight=class_weights(y, 3),
            device="cpu")
losses = t.fit(x, y, epochs=2, batch_size=16)
assert losses and np.isfinite(losses).all()
from inaspeechsegmenter_tpu_torch.parallel import make_2d_mesh
tm = Trainer(model.spec, model.params,
             mesh=make_2d_mesh(2, 2, devices=["cpu"] * 4))
assert tm._split and np.isfinite(tm.fit(x, y, batch_size=16)).all()
t.save_checkpoint("ckpt")
t.restore_checkpoint("ckpt")
t.export_model("models/keras_speech_music_noise_cnn.npz")
with warnings.catch_warnings():
    warnings.simplefilter("error")
    load_patch_model("keras_speech_music_noise_cnn.hdf5", "models")
os.makedirs("hyp")
seg2csv(Segmenter("smn", True, ffmpeg=None, device="cpu",
                  model_dir="models")("t.wav"), "hyp/t.csv")
assert evaluate.main(["-r", "out", "-y", "hyp", "--json"]) == 0
bad = [m for m in ("jax", "jaxlib", "optax", "pandas", "h5py",
                   "inaspeechsegmenter_tpu") if sys.modules.get(m)]
assert not bad, bad
print("NO-JAX-OK")
"""


def test_score_train_and_farm_without_jax(tmp_path):
    """The scorer, the patch dataset, the trainer (checkpoint and export)
    and the job farm with its CLIs, in a process where importing jax,
    optax, pandas, h5py or the JAX package fails."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", CODE_TRAIN_SCORE_FARM],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO-JAX-OK" in r.stdout


CODE_REFERENCE_PATHS = r"""
import sys
for m in ("jax", "jaxlib", "optax", "pandas", "h5py",
          "inaspeechsegmenter_tpu"):
    sys.modules[m] = None                # importing them now raises
import importlib
import os
import numpy as np
MODULES = ("io", "remote_utils", "viterbi_utils", "pyannote_viterbi",
           "features_vbx", "vbx_segmenter", "resnet", "export_funcs",
           "thread_returning", "sidekit_mfcc")
mods = {m: importlib.import_module("inaspeechsegmenter_tpu_torch." + m)
        for m in MODULES}
from inaspeechsegmenter_tpu_torch.dsp import vbx
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from inaspeechsegmenter_tpu_torch.models.synthetic import install_synthetic_models

vbx.vbx_i16_enabled = lambda device: True       # the grid, also on the CPU
install_synthetic_models("models", size="small")
sig = np.random.default_rng(0).standard_normal(16000)
ceps = mods["sidekit_mfcc"].mfcc(sig)[0]
assert ceps.shape == (98, 13), ceps.shape
assert mods["features_vbx"].mel_fbank_mx(400, 16000).shape == (257, 20)
assert mods["resnet"].ResNet101().num_blocks == (3, 4, 23, 3)
net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
scorer = mods["vbx_segmenter"].VoiceFemininityScoring(
    "bgc", "jax", False, net.init_params(seed=0), net, None, device="cpu",
    model_dir="models")
t = np.arange(16000 * 45) / 16000
pcm = (8000 * np.sin(2 * np.pi * 1000 * t)).astype(np.int16)
pcm[16000 * 20:16000 * 22] = 0
os.environ["ISS_VFS_OVERLAP"] = "1"
got = scorer.score_signal(pcm)
assert scorer.overlap_stats is not None, "not the overlapped path"
os.environ["ISS_VFS_OVERLAP"] = "auto"
scorer.overlap_stats = None
assert scorer.score_signal(pcm) == got
assert scorer.overlap_stats is None, "auto took the overlapped path"
bad = [m for m in ("jax", "jaxlib", "optax", "pandas", "h5py",
                   "inaspeechsegmenter_tpu") if sys.modules.get(m)]
assert not bad, bad
print("NO-JAX-OK")
"""


def test_reference_paths_and_overlapped_scorer_without_jax(tmp_path):
    """The ten reference import-path modules and the overlapped VFS
    scorer, in a process where importing jax, optax, pandas, h5py or the
    JAX package fails."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("ISS_VFS_OVERLAP", None)
    r = subprocess.run([sys.executable, "-c", CODE_REFERENCE_PATHS],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO-JAX-OK" in r.stdout
