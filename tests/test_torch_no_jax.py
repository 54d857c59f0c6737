"""PyTorch port: runs without jax, pandas or h5py.

The machine with the GPU has none of them, so the port must neither import
them (at module level or on the segmentation path) nor name jax in an
import anywhere in its sources.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "inaspeechsegmenter_tpu_torch")

CODE = r"""
import sys
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
bad = [m for m in ("jax", "jaxlib", "pandas", "h5py") if m in sys.modules]
assert not bad, bad
print("NO-JAX-OK")
"""


def test_port_runs_without_jax_pandas_h5py(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", CODE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO-JAX-OK" in r.stdout


def test_no_source_imports_jax_pandas_or_h5py():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pandas|h5py)\b",
                     re.MULTILINE)
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
