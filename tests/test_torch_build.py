"""PyTorch port: the kernel build, driven through a stand-in ``nvcc``.

The build compiles every ``csrc/*.cu`` source in its own ``nvcc`` process
and links the objects in one more; a failed compile raises with the
compiler's output and links nothing.
"""

import os
import stat
import sys

import pytest

from inaspeechsegmenter_tpu_torch.utils import cuda_build

FAKE_NVCC = """#!{python}
import os, sys
with open(os.environ["FAKE_NVCC_LOG"], "a") as fh:
    fh.write(" ".join(sys.argv[1:]) + "\\n")
if os.environ.get("FAKE_NVCC_FAIL", "") and "-c" in sys.argv \\
        and sys.argv[-1].endswith(os.environ["FAKE_NVCC_FAIL"]):
    print("error: refused " + sys.argv[-1])
    sys.exit(2)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").write("built")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return log


def test_one_compile_per_source_then_one_link(fake_nvcc, tmp_path):
    lib = cuda_build.build()
    assert os.path.basename(lib) == (
        f"libiss_torch_kernels_{cuda_build.source_hash()}.so")
    assert open(lib).read() == "built"
    calls = fake_nvcc.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    links = [c for c in calls if "-shared" in c.split()]
    srcs = cuda_build.sources()
    assert len(srcs) >= 2 and len(compiles) == len(srcs) and len(links) == 1
    assert sorted(c.split()[-1] for c in compiles) == sorted(srcs)
    assert all("sm_90a" in c for c in calls)
    # the objects are linked, then removed: only the library stays
    assert sorted(os.listdir(tmp_path / "build")) == [os.path.basename(lib)]
    assert cuda_build.build() == lib            # built once per source hash
    assert len(fake_nvcc.read_text().splitlines()) == len(calls)


def test_failed_compile_raises_and_links_nothing(fake_nvcc, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "viterbi.cu")
    with pytest.raises(RuntimeError, match="refused .*viterbi.cu"):
        cuda_build.build()
    assert not any("-shared" in c.split()
                   for c in fake_nvcc.read_text().splitlines())
    assert os.listdir(tmp_path / "build") == []


def test_concurrent_first_builds_compile_once(fake_nvcc, tmp_path):
    """Threads that launch their first kernels together (the batch
    drivers' producers) wait for one build: each source compiles once and
    the objects link once."""
    import threading

    barrier = threading.Barrier(4)
    libs = []

    def first_launch():
        barrier.wait(timeout=10)
        libs.append(cuda_build.build())

    threads = [threading.Thread(target=first_launch) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(libs) == 4 and len(set(libs)) == 1
    calls = fake_nvcc.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split()[-1] for c in compiles) == sorted(
        cuda_build.sources())
    assert len([c for c in calls if "-shared" in c.split()]) == 1
    assert sorted(os.listdir(tmp_path / "build")) == [os.path.basename(libs[0])]


def test_launch_counts_survive_threads():
    """More counting threads than cores, switching as often as the
    interpreter allows: no launch is lost from a wrapper's count."""
    import threading

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, n_each = 4 * (os.cpu_count() or 1), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [cuda_build.count_launch(wrapper)
                            for _ in range(n_each)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert wrapper.launches == n_threads * n_each
