"""PyTorch port: the numpy HDF5 reader (``models/h5.py``) against h5py.

Files written by h5py (``libver="earliest"`` and ``"latest"``) must read
back with the same member order, equal attributes (type and value) and
bit-equal arrays of the same dtype; what the reader does not support
raises ``KerasImportError``.  The test writer ``write_h5`` is held to h5py
the other way round, and truncated or byte-flipped Keras files raise only
``KerasImportError`` (a ``ValueError``).
"""

import json

import numpy as np
import pytest

from inaspeechsegmenter_tpu_torch.models import h5
from inaspeechsegmenter_tpu_torch.models.keras_h5 import (KerasImportError,
                                                          read_h5)
from torch_parity_helpers import write_h5, write_keras2_h5

h5py = pytest.importorskip("h5py")


def _fill(f, rng):
    f.attrs["vlen_str"] = "a variable-length string"
    f.attrs["fixed_str"] = np.bytes_("fixed")
    f.attrs["fixed_arr"] = np.array([b"conv2d_1", b"dense"], dtype="S16")
    f.attrs["vlen_arr"] = ["kernel:0", "bias:0"]
    f.attrs["int_scalar"] = np.int64(-7)
    f.attrs["float_arr"] = np.linspace(0, 1, 5).astype(np.float32)
    g = f.create_group("model_weights")
    g.create_dataset("f32", data=rng.standard_normal((3, 4, 2))
                     .astype(np.float32))
    g.create_dataset("f64", data=rng.standard_normal(6))
    g.create_dataset("f32be", data=rng.standard_normal((2, 3)).astype(">f4"))
    g.create_dataset("i32", data=np.arange(-4, 8, dtype=np.int32))
    g.create_dataset("u8", data=np.arange(9, dtype=np.uint8).reshape(3, 3))
    g.create_dataset("empty", shape=(0, 5), dtype=np.float32)
    g.create_dataset("scalar", data=np.float32(1.25))
    deep = g.create_group("dense_1/dense_1")
    deep.attrs["weight_names"] = np.array([b"dense_1/kernel:0"], dtype="S32")
    deep.create_dataset("kernel:0", data=np.ones((2, 2), np.float32))
    f.create_group("empty_group")


def _compare(a, b):
    assert list(a.keys()) == list(b.keys())
    assert sorted(a.attrs.keys()) == sorted(b.attrs.keys())
    for k in a.attrs:
        want, got = a.attrs[k], b.attrs[k]
        assert type(got) is type(want), k
        np.testing.assert_array_equal(got, want)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
    for k in a:
        if isinstance(a[k], h5py.Dataset):
            want, got = np.array(a[k]), np.array(b[k])
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k
            assert b[k].name == a[k].name
            assert isinstance(b[k], h5.Dataset)
        else:
            assert isinstance(b[k], h5.Group)
            _compare(a[k], b[k])


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_matches_h5py(tmp_path, libver):
    path = str(tmp_path / f"{libver}.h5")
    with h5py.File(path, "w", libver=libver) as f:
        _fill(f, np.random.default_rng(5))
    with h5py.File(path, "r") as want, h5.File(path) as got:
        _compare(want, got)
        assert "model_weights/dense_1/dense_1/kernel:0" in got
        assert "model_weights/missing" not in got
        assert got["/model_weights"]["/model_weights/f64"].name == \
            "/model_weights/f64"
        with pytest.raises(KeyError):
            got["model_weights/missing"]
        assert np.array(got["model_weights/scalar"]) == np.float32(1.25)


def test_compact_dataset(tmp_path):
    path = str(tmp_path / "compact.h5")
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple(data.shape)
        ds = h5py.h5d.create(f.id, b"c", h5py.h5t.NATIVE_FLOAT, space, dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    np.testing.assert_array_equal(np.array(h5.File(path)["c"]), data)


def test_dense_links_and_attributes_raise(tmp_path):
    """Under ``libver="latest"`` more than 8 links or attributes go to
    dense (fractal heap) storage, which the reader refuses."""
    for n_groups, n_attrs in ((9, 1), (8, 9)):
        path = str(tmp_path / f"dense{n_groups}.h5")
        with h5py.File(path, "w", libver="latest") as f:
            for i in range(n_groups):
                f.create_group(f"g{i}")
            for i in range(n_attrs):
                f["g0"].attrs[f"a{i}"] = i
        f = h5.File(path)
        if n_groups > 8:
            with pytest.raises(KerasImportError, match="dense link storage"):
                f.keys()
        else:
            assert f.keys() == [f"g{i}" for i in range(8)]
            with pytest.raises(KerasImportError,
                               match="dense attribute storage"):
                f["g0"].attrs.get("a0")


@pytest.mark.parametrize("kind", ["chunked", "gzip"])
def test_chunked_and_compressed_datasets_raise(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.ones((64, 8), np.float32),
                         chunks=(8, 8),
                         compression="gzip" if kind == "gzip" else None)
    with pytest.raises(KerasImportError, match="chunked|filter pipeline"):
        np.array(h5.File(path)["d"])


def test_not_hdf5_raises(tmp_path):
    path = tmp_path / "x.h5"
    path.write_bytes(b"not an hdf5 file at all" * 10)
    with pytest.raises(KerasImportError, match="not an HDF5 file"):
        h5.File(str(path))


def test_writer_read_back_by_h5py(tmp_path):
    """``write_h5`` (test scaffolding for hosts without h5py): h5py reads
    every file it writes with equal attributes and bit-equal arrays."""
    rng = np.random.default_rng(8)
    datasets = {"/a/x": rng.standard_normal((3, 4)).astype(np.float32),
                "/a/b/y:0": rng.standard_normal(5).astype(">f8"),
                "/z": np.arange(7, dtype=np.int16),
                "/empty": np.zeros((0, 2), np.float32),
                "/scalar": np.float32(2.5)}
    for i in range(11):                   # wider than one default leaf
        datasets[f"/many/m{i:02d}"] = np.full(3, i, np.float32)
    attrs = {"/": {"model_config": b'{"class_name": "Sequential"}',
                   "names": np.array([b"ab", b"c"], dtype="S8"),
                   "n": np.int64(4), "f": np.arange(3.0)},
             "/a/b": {"weight_names": np.array([b"y:0"], dtype="S16")},
             "/no_members": {}}
    path = write_h5(str(tmp_path / "w.h5"), datasets, attrs)
    with h5py.File(path, "r") as f, h5.File(path) as g:
        for p, arr in datasets.items():
            got = np.array(f[p])
            assert got.dtype == arr.dtype and got.shape == np.shape(arr)
            assert got.tobytes() == np.asarray(arr).tobytes()
        for p, a in attrs.items():
            assert sorted(f[p].attrs.keys()) == sorted(a)
            for k, v in a.items():
                np.testing.assert_array_equal(f[p].attrs[k], v)
        assert list(f["many"].keys()) == [f"m{i:02d}" for i in range(11)]
        _compare(f, g)


# -- fuzzing -----------------------------------------------------------------

def _keras_corpus(tmp_path):
    """The same small Keras model written three ways: h5py earliest (vlen
    strings, symbol tables), h5py latest (v2 object headers, link
    messages) and ``write_keras2_h5``."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    cfg = {"class_name": "Sequential", "config": {"name": "s", "layers": [
        {"class_name": "Dense", "config": {"name": "d", "units": 3,
                                           "activation": "relu"}}]}}
    blobs = []
    for libver in ("earliest", "latest"):
        p = str(tmp_path / f"{libver}.h5")
        with h5py.File(p, "w", libver=libver) as f:
            f.attrs["model_config"] = json.dumps(cfg)
            g = f.create_group("model_weights")
            g.attrs["layer_names"] = [b"d"]
            d = g.create_group("d")
            d.attrs["weight_names"] = ["d/kernel:0", "d/bias:0"]
            d.create_dataset("d/kernel:0", data=k)
            d.create_dataset("d/bias:0", data=b)
        blobs.append(open(p, "rb").read())
    p = write_keras2_h5(str(tmp_path / "w.h5"), cfg,
                        {"d": [("kernel", k), ("bias", b)]})
    blobs.append(open(p, "rb").read())
    for blob in blobs:
        q = tmp_path / "seed.h5"
        q.write_bytes(blob)
        spec, params = read_h5(str(q))
        np.testing.assert_array_equal(params["d"][0], k)
    return blobs


def test_fuzz_truncations_and_byte_flips(tmp_path):
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    blobs = _keras_corpus(tmp_path)
    path = tmp_path / "fuzz.h5"

    @hypothesis.settings(max_examples=300, deadline=None, database=None,
                         derandomize=True)
    @hypothesis.given(st.integers(0, len(blobs) - 1), st.data())
    def case(which, data):
        blob = bytearray(blobs[which])
        if data.draw(st.booleans()):
            del blob[data.draw(st.integers(1, len(blob) - 1)):]
        for _ in range(data.draw(st.integers(0, 8))):
            blob[data.draw(st.integers(0, len(blob) - 1))] = data.draw(
                st.integers(0, 255))
        path.write_bytes(bytes(blob))
        try:
            read_h5(str(path))
        except ValueError:          # KerasImportError and its base only
            pass

    case()
