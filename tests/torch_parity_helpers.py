"""Seeded inputs shared by the PyTorch-port parity tests (tests/test_torch_*).

Signals are broadband wherever they are not digitally silent (noise under a
syllable-rate envelope, plus a tone, at a level that changes every half
second): two float32 DFT implementations then agree on every mel band to
the 1e-4 tolerance, which a pure tone's far sidelobes would not allow.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

SR = 16000


def speechlike(seconds, seed, silences=(), quiet=0.25):
    """float32 signal in [-1, 1).

    :param silences: (start_s, stop_s) stretches of exact digital silence.
    :param quiet: fraction of half-second sections 40-50 dB down (frames
        the energy detector calls noEnergy).
    """
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    t = np.arange(n) / SR
    sig = np.zeros(n)
    sec = SR // 2
    for s0 in range(0, n, sec):
        m = slice(s0, min(n, s0 + sec))
        k = m.stop - m.start
        level = 10 ** (rng.uniform(-2.5, -2.0) if rng.random() < quiet
                       else rng.uniform(-0.6, 0.0))
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 8) * t[m]
                                + rng.uniform(0, 2 * np.pi))
        tone = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t[m])
        sig[m] = level * (am * rng.standard_normal(k) + tone)
    for a, b in silences:
        sig[int(a * SR):int(b * SR)] = 0.0
    return (0.2 * sig).astype(np.float32)


def voiced(seconds, seed, silences=()):
    """float32 signal of one-second tone sections over a -60 dB noise
    floor: 800-1600 Hz tones (which the small synthetic VAD calls speech)
    and 100-300 Hz tones (music, mostly), at levels within 6 dB."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for s0 in range(0, n, SR):
        m = slice(s0, min(n, s0 + SR))
        level = 10 ** rng.uniform(-0.6, 0.0)
        f = rng.uniform(800, 1600) if rng.random() < 0.7 else \
            rng.uniform(100, 300)
        sig[m] = level * (np.sin(2 * np.pi * f * t[m])
                          + 1e-3 * rng.standard_normal(m.stop - m.start))
    for a, b in silences:
        sig[int(a * SR):int(b * SR)] = 0.0
    return (0.2 * sig).astype(np.float32)


def to_int16(sig):
    return np.clip(np.rint(sig * 32768.0), -32768, 32767).astype(np.int16)


def int16_grid_on_cpu(monkeypatch):
    """Both packages on their int16 VBx grid on the CPU: the JAX package
    through its ``ISS_VBX_UPLOAD``, the port, which takes the grid on a
    CUDA device only, through ``dsp.vbx.vbx_i16_enabled``."""
    from inaspeechsegmenter_tpu_torch.dsp import vbx

    monkeypatch.setenv("ISS_VBX_UPLOAD", "int16")
    monkeypatch.setattr(vbx, "vbx_i16_enabled", lambda device: True)


def write_h5(path, datasets=(), attrs=()):
    """Write an HDF5 file with numpy alone: superblock v0, symbol-table
    groups, contiguous datasets, numeric and fixed-length string
    attributes (the layout h5py writes with ``libver="earliest"``).

    :param datasets: {"/group/name": array} (numeric, either byte order);
        groups on the path are created.
    :param attrs: {"/group": {name: value}}: ``bytes`` / ``str`` and
        arrays of them are fixed-length strings, the rest numeric.
    Test scaffolding: it writes the Keras files of the CPU tests and of the
    chip smoke run, whose hosts may have no h5py.
    """
    def node(p):
        g = root
        for part in (q for q in p.split("/") if q):
            g = g["members"].setdefault(part, {"attrs": {}, "members": {}})
        return g

    root = {"attrs": {}, "members": {}}
    for p, arr in dict(datasets).items():
        parent, _, leaf = p.rstrip("/").rpartition("/")
        node(parent)["members"][leaf] = np.asarray(arr)
    for p, a in dict(attrs).items():
        node(p)["attrs"].update(a)
    return _H5Writer().write(path, root)


_UNDEF = b"\xff" * 8


class _H5Writer:
    """Little-endian, 8-byte offsets and lengths, everything 8-aligned."""

    INTERNAL_K = 16

    def write(self, path, root):
        self.buf = bytearray(96)
        self.leaf_k = max(4, -(-self._widest(root) // 2))
        addr, btree, heap = self._group(root)
        sb = (b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", self.leaf_k, self.INTERNAL_K, 0)
              + struct.pack("<Q", 0) + _UNDEF
              + struct.pack("<Q", len(self.buf)) + _UNDEF
              + struct.pack("<QQII", 0, addr, 1, 0)
              + struct.pack("<QQ", btree, heap))
        self.buf[:96] = sb
        with open(path, "wb") as fh:
            fh.write(self.buf)
        return path

    def _widest(self, g):
        kids = [m for m in g["members"].values() if isinstance(m, dict)]
        return max([len(g["members"])] + [self._widest(k) for k in kids])

    def _alloc(self, data):
        self.buf += bytes(-len(self.buf) % 8)
        addr = len(self.buf)
        self.buf += data
        return addr

    def _header(self, msgs):
        body = b""
        for mtype, data in msgs:
            data += bytes(-len(data) % 8)
            body += struct.pack("<HHB3x", mtype, len(data), 0) + data
        return self._alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                       len(body)) + body)

    def _group(self, g):
        names = sorted(g["members"], key=str.encode)
        entries = []
        for name in names:
            m = g["members"][name]
            if isinstance(m, dict):
                addr, btree, heap = self._group(m)
                entries.append((addr, struct.pack("<IIQQ", 1, 0, btree, heap)))
            else:
                entries.append((self._dataset(m), bytes(24)))
        heap_data, offsets = bytearray(8), []
        for name in names:
            offsets.append(len(heap_data))
            raw = name.encode() + b"\0"
            heap_data += raw + bytes(-len(raw) % 8)
        # the data segment follows the 32-byte heap header; 1 ends the
        # (empty) free list
        self.buf += bytes(-len(self.buf) % 8)
        heap = self._alloc(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap_data), 1, len(self.buf) + 32) + heap_data)
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
        for off, (addr, cache) in zip(offsets, entries):
            snod += struct.pack("<QQ", off, addr) + cache
        snod += bytes(8 + 2 * self.leaf_k * 40 - len(snod))
        snod_addr = self._alloc(snod) if names else None
        tree = b"TREE" + struct.pack("<BBH", 0, 0, 1 if names else 0) \
            + _UNDEF + _UNDEF + struct.pack("<Q", 0)
        if names:
            tree += struct.pack("<QQ", snod_addr, offsets[-1])
        k = self.INTERNAL_K
        tree += bytes(24 + (2 * k + 1) * 8 + 2 * k * 8 - len(tree))
        btree = self._alloc(tree)
        msgs = [(0x11, struct.pack("<QQ", btree, heap))]
        msgs += [(0x0C, self._attribute(n, v)) for n, v in g["attrs"].items()]
        return self._header(msgs), btree, heap

    def _dataset(self, arr):
        raw = arr.tobytes()
        addr = self._alloc(raw) if raw else None
        layout = struct.pack("<BB", 3, 1) + (
            _UNDEF if addr is None else struct.pack("<Q", addr)) \
            + struct.pack("<Q", len(raw))
        return self._header([(0x01, _dataspace(arr.shape)),
                             (0x03, _datatype(arr.dtype)), (0x08, layout)])

    @staticmethod
    def _attribute(name, value):
        if isinstance(value, (bytes, str)):
            value = np.bytes_(value.encode() if isinstance(value, str)
                              else value)
        arr = np.asarray(value)
        if arr.dtype.kind in "OU":
            arr = np.array([v.encode() if isinstance(v, str) else v
                            for v in arr.ravel()]).reshape(arr.shape)
        raw_name = name.encode() + b"\0"
        dt, ds = _datatype(arr.dtype), _dataspace(arr.shape)

        def pad(b):
            return b + bytes(-len(b) % 8)
        return (struct.pack("<BBHHH", 1, 0, len(raw_name), len(dt), len(ds))
                + pad(raw_name) + pad(dt) + pad(ds) + arr.tobytes())


def _dataspace(shape):
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _datatype(dtype):
    big = dtype.byteorder == ">"
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 1, 0, 0, max(dtype.itemsize, 1))
    if dtype.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, int(big) | (8 if dtype.kind ==
                                                         "i" else 0), 0, 0,
                           dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f":
        exp_loc, exp_size, mant, bias = {
            2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
            8: (52, 11, 52, 1023)}[dtype.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, int(big) | 0x20,
                           8 * dtype.itemsize - 1, 0, dtype.itemsize, 0,
                           8 * dtype.itemsize, exp_loc, exp_size, 0, mant,
                           bias)
    raise TypeError(f"write_h5: no HDF5 type for {dtype}")


def keras_model_config(spec):
    """A Keras 2 Sequential ``model_config`` for a sequential spec."""
    return {"class_name": "Sequential", "config": {
        "name": "sequential_1",
        "layers": [{"class_name": e["class_name"], "config": e["config"]}
                   for e in spec["layers"]]}}


def write_keras2_h5(path, model_config, weights, keras_version="2.1.6"):
    """Write a Keras hdf5 in the 2018 Keras 2 layout with ``write_h5``:
    JSON ``model_config`` attr, fixed-width bytes ``layer_names`` /
    ``weight_names`` attrs, datasets at the nested
    ``model_weights/<layer>/<layer>/<weight>:0`` paths.

    :param weights: {layer name: [(weight name, array)]} in Keras order.
    """
    import json

    datasets = {}
    attrs = {"/": {"model_config": json.dumps(model_config).encode(),
                   "keras_version": keras_version.encode(),
                   "backend": b"tensorflow"},
             "/model_weights": {
                 "layer_names": np.array([n.encode() for n in weights],
                                         dtype="S64"),
                 "keras_version": keras_version.encode(),
                 "backend": b"tensorflow"}}
    for lname, wlist in weights.items():
        wnames = [f"{lname}/{wn}:0" for wn, _ in wlist]
        attrs[f"/model_weights/{lname}"] = {"weight_names": np.array(
            [n.encode() for n in wnames], dtype="S96")}
        for (_, arr), full in zip(wlist, wnames):
            datasets[f"/model_weights/{lname}/{full}"] = np.asarray(
                arr, np.float32)
    return write_h5(path, datasets, attrs)


KERAS_WEIGHT_NAMES = {"Conv2D": ("kernel", "bias"), "Dense": ("kernel", "bias"),
                      "BatchNormalization": ("gamma", "beta", "moving_mean",
                                             "moving_variance")}


def write_spec_h5(path, spec, params):
    """A sequential spec and its Keras-layout params (the synthetic models)
    as a Keras 2 hdf5 that ``read_h5`` turns back into equal arrays."""
    weights = {}
    for e in spec["layers"]:
        arrays = params.get(e["name"], [])
        names = KERAS_WEIGHT_NAMES.get(e["class_name"], ())
        weights[e["name"]] = list(zip(names, arrays))
    return write_keras2_h5(path, keras_model_config(spec), weights)


def kernel_constant(source, name):
    """The value of ``constexpr int <name>`` in the port's CUDA source
    ``csrc/<source>``, so that a test follows the kernel's settings."""
    from inaspeechsegmenter_tpu_torch.utils.cuda_build import CSRC_DIR

    with open(os.path.join(CSRC_DIR, source)) as fh:
        m = re.search(rf"constexpr int {name} = (\d+);", fh.read())
    return int(m.group(1))


def write_fake_ffmpeg(directory):
    """Write an executable ``ffmpeg`` stand-in into ``directory`` -> its
    path.  Built on the port's WAV reader and numpy: it checks the flags
    the reference builds, applies ``-ss`` / ``-to``, resamples (FFT) and
    streams a WAV with bogus RIFF sizes like ``ffmpeg ... pipe:1``, so both
    packages decode through it to the same signal."""
    import stat
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(str(directory), "ffmpeg")
    with open(script, "w") as fh:
        fh.write(textwrap.dedent(f"""\
        #!{sys.executable}
        import struct, sys
        import numpy as np
        sys.path.insert(0, {os.path.join(repo, "inaspeechsegmenter_tpu_torch",
                                         "audio")!r})
        from wav import read_wav          # the port's reader, without torch
        args = sys.argv[1:]
        def val(flag):
            return args[args.index(flag) + 1] if flag in args else None
        assert val('-f') == 'wav' and val('-acodec') == 'pcm_s16le'
        assert val('-ar') == '16000' and val('-ac') == '1'
        assert args[-1] == 'pipe:1'
        try:
            sig, sr = read_wav(val('-i'), dtype='float64')
        except OSError as exc:
            sys.stderr.write(str(exc))
            sys.exit(1)
        if sig.ndim > 1:
            sig = sig.mean(axis=1)
        if sr != 16000:
            n = round(len(sig) * 16000 / sr)
            spec = np.fft.rfft(sig)[:n // 2 + 1]
            sig = np.fft.irfft(spec, n) * (n / len(sig))
        a = int(float(val('-ss') or 0) * 16000)
        b = int(float(val('-to')) * 16000) if val('-to') else len(sig)
        pcm = np.clip(np.rint(sig[a:b] * 32768.0), -32768, 32767)
        fmt = struct.pack('<HHIIHH', 1, 1, 16000, 32000, 2, 16)
        sys.stdout.buffer.write(
            b'RIFF' + b'\\xff' * 4 + b'WAVE' + b'fmt ' + struct.pack('<I', 16)
            + fmt + b'data' + b'\\xff' * 4 + pcm.astype('<i2').tobytes())
    """))
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    return script
