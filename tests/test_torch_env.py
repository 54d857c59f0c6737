"""PyTorch port: the constructors' bounded guard (``utils/env.py``), the
counterpart of tests/test_ctor_guard.py.

A driver that never answers is played by the probe's code replaced with a
sleep, in a subprocess with ``ISS_CTOR_LINK_WAIT=4``: the constructor
raises ``TimeoutError`` naming the variable within the wait plus start-up.
In-process, with the probe stubbed: the guard is free for ``device="cpu"``,
latches after one success, is skipped when this process already made a
CUDA context, is skipped by ``ISS_CTOR_LINK_WAIT <= 0``, and runs before
``torch.cuda.is_available()`` in each constructor.  A driver that answers
"no device" (this host has no ``libcuda``) ends the guard at once, and the
constructor's own device check raises.
"""

import os
import re
import subprocess
import sys
import time

import pytest
import torch

from inaspeechsegmenter_tpu_torch import Segmenter, VoiceFemininityScoring
from inaspeechsegmenter_tpu_torch.segmenter import SpeechMusicNoise
from inaspeechsegmenter_tpu_torch.utils import env as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HUNG = r"""
import time
t0 = time.monotonic()
from inaspeechsegmenter_tpu_torch.utils import env
env.PROBE_CODE = "import time\ntime.sleep(600)\n"
from inaspeechsegmenter_tpu_torch import Segmenter
t1 = time.monotonic()
try:
    Segmenter(ffmpeg=None, allow_download=False, model_dir=%(models)r)
except TimeoutError as e:
    print("CLEAN_TIMEOUT", round(time.monotonic() - t1, 2), e)
"""


def test_constructor_with_a_hung_probe_times_out(synthetic_model_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["ISS_CTOR_LINK_WAIT"] = "4"
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c",
                        HUNG % {"models": synthetic_model_dir}],
                       env=env, capture_output=True, text=True, timeout=120)
    wall = time.monotonic() - t0
    assert "CLEAN_TIMEOUT" in r.stdout, (r.stdout, r.stderr)
    assert "ISS_CTOR_LINK_WAIT=4s" in r.stdout
    waited = float(r.stdout.split("CLEAN_TIMEOUT")[1].split()[0])
    assert 4.0 <= waited < 10.0, waited
    assert wall < 60, wall


@pytest.fixture
def guard(monkeypatch):
    """The guard unlatched, ``is_available`` recording its calls, and the
    probe stubbed: ``probes`` counts them, ``answer[0]`` is their result
    (True, False or None for a hang)."""
    monkeypatch.setattr(tenv, "_DEVICE_OK", False)
    monkeypatch.delenv("ISS_CTOR_LINK_WAIT", raising=False)
    calls = {"probes": [], "is_available": 0, "answer": [True]}

    def probe(device="cuda", timeout=120.0):
        calls["probes"].append((str(torch.device(device)), timeout))
        return calls["answer"][0]

    def is_available():
        calls["is_available"] += 1
        return False

    monkeypatch.setattr(tenv, "probe_device", probe)
    monkeypatch.setattr(torch.cuda, "is_available", is_available)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    return calls


def test_guard_is_free_on_the_cpu(guard):
    tenv.require_device("test", "cpu")
    tenv.require_device("test", torch.device("cpu"))
    assert guard["probes"] == [] and not tenv._DEVICE_OK


def test_guard_latches_after_one_success(guard):
    tenv.require_device("test", "cuda:1")
    tenv.require_device("test", "cuda")
    assert guard["probes"] == [("cuda:1", 120.0)] and tenv._DEVICE_OK


def test_guard_skipped_when_cuda_is_initialised(guard, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    tenv.require_device("test", "cuda")
    assert guard["probes"] == [] and tenv._DEVICE_OK


@pytest.mark.parametrize("wait", ["0", "-1"])
def test_guard_opt_out(guard, monkeypatch, wait):
    monkeypatch.setenv("ISS_CTOR_LINK_WAIT", wait)
    tenv.require_device("test", "cuda")
    assert guard["probes"] == [] and tenv._DEVICE_OK


def test_guard_retries_a_hung_probe_until_the_wait(guard, monkeypatch):
    monkeypatch.setenv("ISS_CTOR_LINK_WAIT", "0.3")
    guard["answer"][0] = None
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ISS_CTOR_LINK_WAIT=0.3s"):
        tenv.require_device("Segmenter()", "cuda")
    assert time.monotonic() - t0 >= 0.3 and len(guard["probes"]) >= 2
    assert not tenv._DEVICE_OK


def test_guard_ends_when_the_driver_answers_no(guard):
    guard["answer"][0] = False
    tenv.require_device("test", "cuda")
    assert len(guard["probes"]) == 1 and not tenv._DEVICE_OK


@pytest.mark.parametrize("ctor", ["Segmenter", "SpeechMusicNoise",
                                  "VoiceFemininityScoring"])
def test_guard_runs_before_is_available(guard, synthetic_model_dir,
                                       monkeypatch, ctor):
    """A hung probe raises before any in-process CUDA call; a healthy one
    passes to the constructor's own device check."""
    make = {"Segmenter": lambda: Segmenter(
                ffmpeg=None, model_dir=synthetic_model_dir),
            "SpeechMusicNoise": lambda: SpeechMusicNoise(
                model_dir=synthetic_model_dir),
            "VoiceFemininityScoring": lambda: VoiceFemininityScoring(
                ffmpeg=None, model_dir=synthetic_model_dir)}[ctor]
    monkeypatch.setenv("ISS_CTOR_LINK_WAIT", "0.1")
    guard["answer"][0] = None
    with pytest.raises(TimeoutError, match=re.escape(f"{ctor}()")):
        make()
    assert guard["is_available"] == 0 and guard["probes"]
    guard["answer"][0] = True
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert guard["is_available"] == 1 and tenv._DEVICE_OK


def test_real_probe_without_a_driver(monkeypatch):
    """This host has no libcuda: the probe's child answers False fast,
    the guard lets the constructor's device check name the fault, and
    ``wait_for_device`` gives up at its limit."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.setattr(tenv, "_DEVICE_OK", False)
    t0 = time.monotonic()
    assert tenv.probe_device("cuda", timeout=60) is False
    tenv.require_device("test", "cuda")
    assert not tenv._DEVICE_OK
    assert tenv.wait_for_device(max_wait=0.5, probe_timeout=60) is False
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Segmenter(ffmpeg=None)


def test_wait_for_device_and_probe_exit_codes(monkeypatch):
    # the probe loads the driver alone: no torch import in the child
    assert "torch" not in tenv.PROBE_CODE
    assert "cuDevicePrimaryCtxRetain" in tenv.PROBE_CODE
    monkeypatch.setattr(tenv, "_DEVICE_OK", False)
    monkeypatch.setattr(tenv, "PROBE_CODE", "import sys\nsys.exit(0)\n")
    assert tenv.probe_device("cuda:3") is True
    assert tenv.wait_for_device(max_wait=5, probe_timeout=5) is True
    assert tenv._DEVICE_OK
    monkeypatch.setattr(tenv, "PROBE_CODE",
                        "import time\ntime.sleep(60)\n")
    t0 = time.monotonic()
    assert tenv.probe_device("cuda", timeout=0.5) is None
    assert time.monotonic() - t0 < 20
