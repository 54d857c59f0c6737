"""PyTorch port: the wheel installs and runs without the repository.

Counterpart of ``tests/test_package_install.py``: the wheel is built once
(``pip wheel --no-deps --no-build-isolation``) and installed with
``--target``; it holds the port's kernel sources and its own copy of the
native audio source, and names the port's six console scripts beside the
JAX package's six.  The installed ``ina_speech_segmenter_torch`` runs a
tiny segmentation on the CPU with the repository off ``sys.path``, its
working directory outside it and jax blocked from import, and writes the
csvs that the checkout writes, a resampled (22.05 kHz) WAV included, whose
native library it builds from the package's source into its own build
directory.
"""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from inaspeechsegmenter_tpu_torch.audio import native as tnative
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.cli import segment
from torch_parity_helpers import speechlike, to_int16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "inaspeechsegmenter_tpu_torch"

TORCH_SCRIPTS = {
    "ina_speech_segmenter_torch": "segment",
    "ina_speech_segmenter_torch_job_server": "server",
    "ina_speech_segmenter_torch_job_client": "client",
    "ina_speech_segmenter_torch_job_setjobs": "setjobs",
    "ina_speech_segmenter_torch_vfs": "vfs",
    "ina_speech_segmenter_torch_eval": "evaluate",
}
JAX_SCRIPTS = [
    "ina_speech_segmenter",
    "ina_speech_segmenter_job_server",
    "ina_speech_segmenter_job_client",
    "ina_speech_segmenter_job_setjobs",
    "ina_speech_segmenter_vfs",
    "ina_speech_segmenter_eval",
]

# runs the installed console script in a process where the repository is
# off sys.path and importing jax, pandas, h5py or the JAX package fails
RUN_SCRIPT = """
import runpy, sys
for m in ("jax", "jaxlib", "optax", "pandas", "h5py",
          "inaspeechsegmenter_tpu"):
    sys.modules[m] = None
repo = %(repo)r
sys.path[:] = [p for p in sys.path if p.rstrip("/") != repo and p != ""]
script = sys.argv[1]
sys.argv = sys.argv[1:]
import inaspeechsegmenter_tpu_torch as port
assert port.__file__.startswith(%(target)r), port.__file__
try:
    runpy.run_path(script, run_name="__main__")
except SystemExit as exc:
    print("EXIT", exc.code)
"""


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    out = tmp_path_factory.mktemp("wheels")
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "-q", "-w", str(out), REPO],
        check=True, timeout=300)
    built = list(out.glob("inaspeechsegmenter_tpu-*.whl"))
    assert len(built) == 1, built
    return built[0]


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    target = tmp_path_factory.mktemp("site")
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "-q", "--no-deps",
         "--no-index", "--target", str(target), str(wheel)],
        check=True, timeout=300)
    return target


def _env(target, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "ISS_TORCH_BUILD_DIR", "ISS_AUDIO_LIB",
                        "ISS_TRACE_DIR")}
    env["PYTHONPATH"] = str(target)
    env.update(extra)
    return env


def _port_files(names):
    return sorted(n for n in names if n.startswith(PKG + "/")
                  and "__pycache__" not in n)


def test_wheel_holds_every_module_and_no_other_file(wheel):
    pkg = os.path.join(REPO, PKG)
    want = []
    for root, _, files in os.walk(pkg):
        want += [os.path.relpath(os.path.join(root, f), REPO)
                 for f in files if f.endswith((".py", ".cu", ".cc"))]
    with zipfile.ZipFile(wheel) as z:
        assert _port_files(z.namelist()) == _port_files(want)


def test_wheel_holds_the_sources_and_names_every_script(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        eps = next(z.read(n).decode() for n in names
                   if n.endswith(".dist-info/entry_points.txt"))
        meta = next(z.read(n).decode() for n in names
                    if n.endswith(".dist-info/METADATA"))
    cu = sorted(n for n in names if n.startswith(f"{PKG}/csrc/"))
    assert cu == sorted(f"{PKG}/csrc/{f}" for f in
                        os.listdir(os.path.join(REPO, PKG, "csrc")))
    assert f"{PKG}/native/issaudio.cc" in names
    assert f"{PKG}/tools/prewarm.py" in names
    assert f"{PKG}/tools/verify_weights.py" in names
    for name, module in TORCH_SCRIPTS.items():
        assert f"{name} = {PKG}.cli.{module}:main" in eps
    for name in JAX_SCRIPTS:
        assert f"{name} = inaspeechsegmenter_tpu.cli." in eps
    # the base dependencies are the JAX package's; the port's are an extra
    requires = [ln for ln in meta.splitlines() if ln.startswith("Requires")]
    for dep in ("jax", "numpy", "scipy", "pandas", "h5py"):
        assert f"Requires-Dist: {dep}" in requires
    for dep in ("torch", "numpy", "scipy"):
        assert f"Requires-Dist: {dep}; extra == \"torch\"" in requires


def test_console_scripts_resolve(installed, tmp_path):
    for name in JAX_SCRIPTS + list(TORCH_SCRIPTS):
        assert (installed / "bin" / name).exists(), f"{name} not generated"
    procs = {name: subprocess.Popen(
        [sys.executable, str(installed / "bin" / name), "--help"],
        env=_env(installed), cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in TORCH_SCRIPTS}
    for name, p in procs.items():
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, (name, out)
        assert "usage" in out.lower(), name


@pytest.fixture
def media(tmp_path):
    d = tmp_path / "media"
    d.mkdir()
    write_wav(str(d / "t16.wav"),
              to_int16(speechlike(4.0, seed=11, silences=[(1.0, 1.6)])),
              16000)
    n = int(3.0 * 22050)
    write_wav(str(d / "t22.wav"),
              to_int16(speechlike(n / 16000, seed=12)), 22050)
    return d


def test_installed_script_segments_like_the_checkout(
        installed, synthetic_model_dir, media, tmp_path, monkeypatch):
    wavs = [str(media / "t16.wav"), str(media / "t22.wav")]
    out = tmp_path / "installed"
    out.mkdir()
    build = tmp_path / "installed_build"
    work = tmp_path / "cwd"
    work.mkdir()
    r = subprocess.run(
        [sys.executable, "-c", RUN_SCRIPT % {"repo": REPO,
                                             "target": str(installed)},
         str(installed / "bin" / "ina_speech_segmenter_torch"), "-i", *wavs,
         "-o", str(out), "-b", "none", "--device", "cpu"],
        env=_env(installed, ISS_TORCH_BUILD_DIR=str(build),
                 ISS_TPU_MODEL_DIR=synthetic_model_dir),
        cwd=str(work), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "EXIT 0" in r.stdout, r.stdout
    # the resampler was built from the package's copy of the source into
    # the install's build directory: the same source hash as the checkout's
    libs = [n for n in os.listdir(build) if n.startswith("libissaudio_")]
    assert libs == [os.path.basename(tnative.library_path())]

    want = tmp_path / "checkout"
    want.mkdir()
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "checkout_b"))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    assert segment.main(["-i", *wavs, "-o", str(want), "-b", "none",
                         "--device", "cpu"]) == 0
    for name in ("t16.csv", "t22.csv"):
        assert (out / name).read_bytes() == (want / name).read_bytes()
    assert (want / "t22.csv").read_text().startswith("labels\tstart\tstop\n")


def test_installed_script_without_a_card_refuses_the_default_device(
        installed, synthetic_model_dir, media, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    out = tmp_path / "out"
    out.mkdir()
    r = subprocess.run(
        [sys.executable, str(installed / "bin" / "ina_speech_segmenter_torch"),
         "-i", str(media / "t16.wav"), "-o", str(out), "-b", "none"],
        env=_env(installed, ISS_TPU_MODEL_DIR=synthetic_model_dir),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert os.listdir(out) == []

