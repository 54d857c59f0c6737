"""PyTorch port: the kernel cache's scope (``utils/cache.py``), the shared
CLI bootstrap (``cli/_common.py``) and ``ensure_synthetic_env``, against
the JAX package's helpers where they have the same contract.

- ``enable_kernel_cache``: ``path``, else ``$ISS_TORCH_BUILD_DIR``, else
  the checkout's ``build/torch_kernels``; the directory is made.
- The build's hash takes ``nvcc --version``'s release line: two toolkits
  (stand-in ``nvcc`` binaries) give two library names.
- ``expand_inputs`` / ``check_outdir`` / ``output_paths`` give the JAX
  helpers' results; where those assert, the port's raise ``ValueError``
  with the same message, and the CLIs exit with status 2 and that
  message (``parser.error``); ``bootstrap_runtime`` makes the cache.
- ``ensure_synthetic_env``: a preset ``ISS_TPU_MODEL_DIR`` is kept
  untouched; else the stand-ins go under the user cache and the variable
  points there.
"""

import os
import re
import stat
import sys

import pytest

from inaspeechsegmenter_tpu_torch.cli import _common
from inaspeechsegmenter_tpu_torch.cli import segment as cli_segment
from inaspeechsegmenter_tpu_torch.cli import vfs as cli_vfs
from inaspeechsegmenter_tpu_torch.models.synthetic import ensure_synthetic_env
from inaspeechsegmenter_tpu_torch.utils import cuda_build
from inaspeechsegmenter_tpu_torch.utils.cache import enable_kernel_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_enable_kernel_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("ISS_TORCH_BUILD_DIR", raising=False)
    assert enable_kernel_cache() == os.path.join(REPO, "build",
                                                 "torch_kernels")
    env_dir = tmp_path / "env" / "kernels"
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(env_dir))
    assert enable_kernel_cache() == str(env_dir) and env_dir.is_dir()
    given = tmp_path / "given"
    assert enable_kernel_cache(str(given)) == str(given) and given.is_dir()
    assert cuda_build.build_dir() == str(given)
    assert enable_kernel_cache() == str(given)       # idempotent


def _stand_in_nvcc(directory, release):
    directory.mkdir(parents=True)
    nvcc = directory / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n"
                    f"print('nvcc: NVIDIA (R) Cuda compiler driver')\n"
                    f"print('Cuda compilation tools, release {release}')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return directory.parent


def test_build_hash_takes_the_toolkit_release(tmp_path, monkeypatch):
    hashes = []
    for rel in ("12.4, V12.4.131", "12.8, V12.8.93", "12.4, V12.4.131"):
        home = tmp_path / rel.split(",")[0]
        if not home.exists():
            _stand_in_nvcc(home / "bin", rel)
        monkeypatch.setenv("CUDA_HOME", str(home))
        assert cuda_build.nvcc_release() == \
            f"Cuda compilation tools, release {rel}"
        hashes.append(cuda_build.source_hash())
    assert hashes[0] != hashes[1] and hashes[0] == hashes[2]


def test_build_hash_without_nvcc(tmp_path, monkeypatch):
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this host has nvcc at its default place")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert cuda_build.nvcc_release() == ""
    assert len(cuda_build.source_hash()) == 16


def test_expand_inputs_matches_jax(tmp_path):
    from inaspeechsegmenter_tpu.cli import _common as jax_common

    for name in ("a.wav", "b.wav", "c.mp3"):
        (tmp_path / name).write_bytes(b"")
    cases = [[str(tmp_path / "*.wav")], [str(tmp_path / "c.mp3")],
             [str(tmp_path / "*.wav"), "http://example.com/x.mp3"]]
    for patterns in cases:
        for urls in (False, True):
            try:
                want = sorted(jax_common.expand_inputs(patterns, urls))
            except AssertionError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    _common.expand_inputs(patterns, urls)
                continue
            assert sorted(_common.expand_inputs(patterns, urls)) == want
    with pytest.raises(ValueError, match="No existing media selected"):
        _common.expand_inputs([str(tmp_path / "*.flac")])
    with pytest.raises(ValueError, match="No existing media selected"):
        _common.expand_inputs(["http://example.com/x.mp3"])


def test_check_outdir_and_output_paths_match_jax(tmp_path):
    from inaspeechsegmenter_tpu.cli import _common as jax_common

    odir = f" {tmp_path}/\n"
    assert _common.check_outdir(odir) == jax_common.check_outdir(odir) \
        == str(tmp_path)
    missing = str(tmp_path / "missing")
    with pytest.raises(AssertionError) as jax_err:
        jax_common.check_outdir(missing)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        _common.check_outdir(missing)
    files = ["/data/a.wav", "rel/b.mp3", "http://h/c.d.ogg"]
    for ext in ("csv", "textgrid"):
        assert _common.output_paths(files, "out", ext) == \
            jax_common.output_paths(files, "out", ext)


def test_bootstrap_runtime_makes_the_kernel_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "k"))
    assert _common.bootstrap_runtime() == str(tmp_path / "k")
    assert (tmp_path / "k").is_dir()


@pytest.mark.parametrize("cli", [cli_segment, cli_vfs])
def test_cli_errors_exit_2_with_the_message(cli, tmp_path, capsys,
                                            monkeypatch):
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "k"))
    (tmp_path / "a.wav").write_bytes(b"")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-i", str(tmp_path / "*.flac"), "-o", str(tmp_path),
                  "-b", "none", "--device", "cpu"])
    assert exc.value.code == 2
    assert "No existing media selected" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        cli.main(["-i", str(tmp_path / "a.wav"), "-o",
                  str(tmp_path / "missing"), "-b", "none", "--device",
                  "cpu"])
    assert exc.value.code == 2
    assert "is not writable!" in capsys.readouterr().err
    assert not (tmp_path / "k").exists()     # no bootstrap before a bad -o


def test_ensure_synthetic_env(tmp_path, monkeypatch):
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", str(tmp_path / "real"))
    assert ensure_synthetic_env("small") == str(tmp_path / "real")
    assert not (tmp_path / "real").exists()
    monkeypatch.delenv("ISS_TPU_MODEL_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    d = ensure_synthetic_env("small")
    assert d == str(tmp_path / "cache" / "inaspeechsegmenter_tpu_torch"
                    / "synthetic")
    assert os.environ["ISS_TPU_MODEL_DIR"] == d
    assert sorted(os.listdir(d)) == sorted(
        ["manifest.json", "keras_speech_music_cnn.npz",
         "keras_speech_music_noise_cnn.npz", "keras_male_female_cnn.npz",
         "interspeech2023_all.npz", "interspeech2023_cvfr.npz"])
