"""PyTorch port: model resolution, the hdf5 conversion cache and downloads.

The cases of ``tests/test_registry.py`` one for one on the port's
``get_remote`` (synthetic gating, stale conversions, priority between real
files and converted caches, corrupt npz, content identity), plus the
port's explicit ``model_dir`` (searched first, an opt-in for synthetic
stand-ins), the conversion of a released ``.hdf5`` into its npz cache and
the download, whose network call is replaced by a stand-in.
"""

import io
import json
import os
import shutil
import time
import urllib.request

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch.models import registry
from inaspeechsegmenter_tpu_torch.models.registry import (ModelNotFoundError,
                                                          get_remote,
                                                          load_patch_model)
from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
from torch_parity_helpers import write_spec_h5


def _write_npz(path, synthetic=False):
    spec = {"layers": [], "synthetic": synthetic}
    np.savez(path, __spec__=np.frombuffer(
        json.dumps(spec).encode(), dtype=np.uint8))


def _write_npz_with_source(path, source_path):
    spec = {"layers": [], "source": {
        "name": os.path.basename(source_path),
        "size": os.path.getsize(source_path),
        "sha256": registry._file_sha256(source_path)}}
    np.savez(path, __spec__=np.frombuffer(
        json.dumps(spec).encode(), dtype=np.uint8))


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """No user directory and no network: HOME is empty, and a download
    attempt fails the test."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("ISS_ALLOW_SYNTHETIC", raising=False)

    def no_network(*args, **kwargs):
        raise AssertionError("a test tried to download")
    monkeypatch.setattr(urllib.request, "urlopen", no_network)


@pytest.fixture()
def model_dir(tmp_path, monkeypatch):
    d = tmp_path / "models"
    d.mkdir()
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", str(d))
    return d


def _dirs(monkeypatch, *dirs):
    monkeypatch.delenv("ISS_TPU_MODEL_DIR", raising=False)
    monkeypatch.setattr(registry, "_search_dirs",
                        lambda model_dir=None: [str(d) for d in dirs])


def test_synthetic_env_zero_is_off(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    cache.mkdir()
    _write_npz(str(cache / "keras_male_female_cnn.npz"), synthetic=True)
    _dirs(monkeypatch, cache)
    for off in ("0", "false", "OFF", "no", ""):
        monkeypatch.setenv("ISS_ALLOW_SYNTHETIC", off)
        with pytest.raises(ModelNotFoundError):
            get_remote("keras_male_female_cnn.hdf5", allow_download=False)
    monkeypatch.setenv("ISS_ALLOW_SYNTHETIC", "1")
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False).endswith(".npz")


def test_stale_npz_does_not_shadow_updated_source(model_dir):
    npz = model_dir / "keras_male_female_cnn.npz"
    src = model_dir / "keras_male_female_cnn.hdf5"
    _write_npz(str(npz))
    src.write_bytes(b"h5")
    old = time.time() - 1000
    os.utime(npz, (old, old))
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(src)
    now = time.time() + 10
    os.utime(npz, (now, now))
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(npz)


def test_fresh_cache_npz_preferred_over_lower_priority_source(
        tmp_path, monkeypatch):
    keras, cache = tmp_path / "keras", tmp_path / "cache"
    keras.mkdir()
    cache.mkdir()
    src = keras / "keras_male_female_cnn.hdf5"
    src.write_bytes(b"h5")
    _dirs(monkeypatch, keras, cache)
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(src)
    npz = cache / "keras_male_female_cnn.npz"
    _write_npz(str(npz))
    now = time.time() + 10
    os.utime(npz, (now, now))
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(npz)
    _write_npz(str(npz), synthetic=True)
    os.utime(npz, (now, now))
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(src)


def test_synthetic_npz_never_shadows_real_source(model_dir):
    npz = model_dir / "keras_male_female_cnn.npz"
    src = model_dir / "keras_male_female_cnn.hdf5"
    _write_npz(str(npz), synthetic=True)
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(npz)
    src.write_bytes(b"h5")
    now = time.time() + 10
    os.utime(npz, (now, now))
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(src)


def test_corrupt_npz_warns_and_falls_back(model_dir):
    npz = model_dir / "keras_male_female_cnn.npz"
    src = model_dir / "keras_male_female_cnn.hdf5"
    npz.write_bytes(b"\x00trash-not-a-zip")
    src.write_bytes(b"h5")
    with pytest.warns(UserWarning, match="unreadable native checkpoint"):
        assert get_remote("keras_male_female_cnn.hdf5",
                          allow_download=False) == str(src)
    src.unlink()
    with pytest.warns(UserWarning, match="unreadable native checkpoint"):
        with pytest.raises(ModelNotFoundError):
            get_remote("keras_male_female_cnn.hdf5", allow_download=False)


def test_conversion_cache_content_identity(tmp_path, monkeypatch):
    keras, cache = tmp_path / "keras", tmp_path / "cache"
    keras.mkdir()
    cache.mkdir()
    src = keras / "keras_male_female_cnn.hdf5"
    npz = cache / "keras_male_female_cnn.npz"
    _dirs(monkeypatch, keras, cache)
    src.write_bytes(b"release-v1")
    _write_npz_with_source(str(npz), str(src))
    src.write_bytes(b"release-v2-different-size")
    old = time.time() - 1000
    os.utime(src, (old, old))
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(src)
    _write_npz_with_source(str(npz), str(src))
    os.utime(npz, (old - 1000, old - 1000))
    assert get_remote("keras_male_female_cnn.hdf5",
                      allow_download=False) == str(npz)


def test_model_dir_is_searched_first_and_opts_in(tmp_path, monkeypatch):
    first, env = tmp_path / "first", tmp_path / "env"
    first.mkdir()
    env.mkdir()
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", str(env))
    _write_npz(str(env / "keras_male_female_cnn.npz"))
    _write_npz(str(first / "keras_male_female_cnn.npz"), synthetic=True)
    assert get_remote("keras_male_female_cnn.hdf5", allow_download=False,
                      model_dir=str(first)) == str(
        first / "keras_male_female_cnn.npz")
    # without the explicit directory the synthetic file is not opted in
    _dirs(monkeypatch, first)
    with pytest.raises(ModelNotFoundError):
        get_remote("keras_male_female_cnn.hdf5", allow_download=False)


def test_hdf5_is_converted_once_then_read_from_the_cache(tmp_path,
                                                        monkeypatch):
    """A released-layout hdf5 loads, writes ``<stem>.npz`` recording its
    source, and the next load takes the npz: equal weights, equal
    outputs, and the JAX package's load of the same file agrees."""
    from inaspeechsegmenter_tpu.models.registry import \
        load_patch_model as jax_load

    spec, params = build_patch_cnn(21, 3, seed=5, size="small")
    d = tmp_path / "m"
    d.mkdir()
    write_spec_h5(str(d / "keras_speech_music_noise_cnn.hdf5"), spec, params)
    first = load_patch_model("keras_speech_music_noise_cnn.hdf5", str(d))
    assert first.path.endswith(".hdf5")
    assert (d / "keras_speech_music_noise_cnn.npz").exists()
    second = load_patch_model("keras_speech_music_noise_cnn.hdf5", str(d))
    assert second.path.endswith(".npz")
    assert second.spec["source"]["sha256"] == registry._file_sha256(
        first.path)
    for a, b in zip(first.state_dict().values(),
                    second.state_dict().values(), strict=True):
        assert torch.equal(a, b)
    x = np.random.default_rng(0).standard_normal(
        (5, 68, 21, 1)).astype(np.float32)
    with torch.no_grad():
        got = second(torch.from_numpy(x)).numpy()
    jd = tmp_path / "j"
    jd.mkdir()
    shutil.copy(first.path, jd)
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", str(jd))
    want = np.asarray(jax_load("keras_speech_music_noise_cnn.hdf5",
                               allow_download=False)(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_download_into_the_cache_and_its_failure(tmp_path, monkeypatch):
    spec, params = build_patch_cnn(24, 2, seed=1, size="small")
    blob_path = write_spec_h5(str(tmp_path / "blob.hdf5"), spec, params)
    blob = open(blob_path, "rb").read()
    calls = []

    def fake_urlopen(url, timeout=None):
        calls.append((url, timeout))
        return io.BytesIO(blob)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    cache = tmp_path / "cache"
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", str(cache))
    model = load_patch_model("keras_male_female_cnn.hdf5")
    assert calls == [(registry.ISS_URL + "keras_male_female_cnn.hdf5", 60)]
    assert model.path == str(cache / "keras_male_female_cnn.hdf5")
    assert sorted(os.listdir(cache)) == ["keras_male_female_cnn.hdf5",
                                         "keras_male_female_cnn.npz"]

    def refused(url, timeout=None):
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", refused)
    with pytest.raises(ModelNotFoundError, match="download from"):
        get_remote("interspeech2023_all.hdf5")
    assert not any(n.startswith("interspeech") for n in os.listdir(cache))
    with pytest.raises(ModelNotFoundError, match="not found"):
        get_remote("not_registered.hdf5")
