"""Minimal first-party ONNX model reader (numpy only).

Copy of ``inaspeechsegmenter_tpu/models/onnx_reader.py`` (that package
imports jax).  The port runs the x-vector network as a PyTorch module and
only needs the *weights* out of the released ``final.onnx`` (reference
vbx_segmenter.py:249-266), so instead of depending on the
``onnx``/``onnxruntime`` packages this module parses the protobuf wire
format directly and exposes the graph skeleton: node stream (op_type,
inputs, outputs, in graph order) and initializer tensors (name ->
ndarray).  Constant-node tensors are folded into the initializer map since
some exporters emit weights that way.

Covers the subset of onnx.proto needed for weight extraction; unknown fields
are skipped per standard protobuf semantics, so files written by any
compliant exporter parse fine.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# protobuf wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# ONNX TensorProto.DataType -> numpy dtype (raw_data is little-endian)
_DTYPES = {
    1: np.dtype("<f4"),    # FLOAT
    2: np.dtype("u1"),     # UINT8
    3: np.dtype("i1"),     # INT8
    4: np.dtype("<u2"),    # UINT16
    5: np.dtype("<i2"),    # INT16
    6: np.dtype("<i4"),    # INT32
    7: np.dtype("<i8"),    # INT64
    9: np.dtype("?"),      # BOOL
    10: np.dtype("<f2"),   # FLOAT16
    11: np.dtype("<f8"),   # DOUBLE
    12: np.dtype("<u4"),   # UINT32
    13: np.dtype("<u8"),   # UINT64
}
try:                       # BFLOAT16, where ml_dtypes is installed
    import ml_dtypes

    _DTYPES[16] = np.dtype(ml_dtypes.bfloat16)
except ImportError:        # pragma: no cover
    pass


def _read_varint(buf, i):
    val = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message.

    value is an int for varint/fixed, a memoryview for length-delimited.
    """
    buf = memoryview(buf)
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, i = _read_varint(buf, i)
        elif wt == _LEN:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == _I64:
            val = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wt == _I32:
            val = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val


def _packed_varints(mv):
    out = []
    i = 0
    while i < len(mv):
        v, i = _read_varint(mv, i)
        out.append(v)
    return out


def _parse_tensor(mv):
    """TensorProto -> (name, ndarray)."""
    name = ""
    dims = []
    dtype_code = 1
    raw = None
    float_data = []
    int32_data = []
    int64_data = []
    double_data = []
    uint64_data = []
    for fno, wt, val in _fields(mv):
        if fno == 1:                      # dims (repeated int64)
            dims.extend(_packed_varints(val) if wt == _LEN else [val])
        elif fno == 2:                    # data_type
            dtype_code = val
        elif fno == 4:                    # float_data (packed)
            float_data.append(np.frombuffer(val, "<f4") if wt == _LEN
                              else np.float32(np.uint32(val).view("<f4")))
        elif fno == 5:                    # int32_data
            int32_data.extend(_packed_varints(val) if wt == _LEN else [val])
        elif fno == 7:                    # int64_data
            int64_data.extend(_packed_varints(val) if wt == _LEN else [val])
        elif fno == 8:                    # name
            name = bytes(val).decode()
        elif fno == 9:                    # raw_data
            raw = val
        elif fno == 10:                   # double_data (packed)
            double_data.append(np.frombuffer(val, "<f8") if wt == _LEN
                               else np.float64(np.uint64(val).view("<f8")))
        elif fno == 11:                   # uint64_data (UINT32/UINT64)
            uint64_data.extend(_packed_varints(val) if wt == _LEN else [val])
    dt = _DTYPES.get(dtype_code)
    if dt is None:
        # unsupported element type (e.g. STRING label maps some exporters
        # emit as side Constants): return None so callers SKIP the tensor
        # instead of aborting the whole parse — weight extraction never
        # needs these, and raising here broke otherwise-loadable files
        return name, None
    if raw is not None:
        arr = np.frombuffer(bytes(raw), dt)
    elif float_data:
        arr = np.concatenate([np.atleast_1d(f) for f in float_data])
    elif double_data:
        arr = np.concatenate([np.atleast_1d(f) for f in double_data])
    elif int64_data:
        # protobuf varints are two's-complement encoded in 64 bits
        arr = np.array(int64_data, np.uint64).view(np.int64)
    elif uint64_data:
        # spec-mandated container for UINT32 and UINT64
        arr = np.array(uint64_data, np.uint64).astype(dt)
    elif int32_data:
        # int32_data is the spec-mandated container for INT32 but ALSO for
        # FLOAT16/INT8/INT16/UINT8/UINT16/BOOL when raw_data is absent —
        # reinterpret the low bits per the declared dtype instead of
        # returning raw bit patterns
        u32 = np.array(int32_data, np.uint64).astype(np.uint32)
        if dtype_code == 10:                      # FLOAT16: low 16 bits
            arr = u32.astype(np.uint16).view(np.float16)
        elif dtype_code == 5:                     # INT16: two's complement
            arr = u32.astype(np.uint16).view(np.int16)
        elif dtype_code == 3:                     # INT8: two's complement
            arr = u32.astype(np.uint8).view(np.int8)
        elif dtype_code == 2:                     # UINT8
            arr = u32.astype(np.uint8)
        elif dtype_code == 4:                     # UINT16
            arr = u32.astype(np.uint16)
        elif dtype_code == 9:                     # BOOL
            arr = u32.astype(np.uint8).astype(np.bool_)
        else:
            arr = u32.view(np.int32)
    else:
        arr = np.zeros(0, dt)
    return name, arr.reshape(dims) if dims else arr


def _signed64(v):
    """Fold an unsigned varint to the signed int64 it encodes (protobuf
    int64 is two's-complement in 64 bits — e.g. axis=-1 arrives as 2^64-1)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attribute(mv):
    """AttributeProto -> (name, value) for the subset we use (t/i/ints)."""
    name = ""
    value = None
    for fno, wt, val in _fields(mv):
        if fno == 1:
            name = bytes(val).decode()
        elif fno == 3:                    # i
            value = _signed64(val)
        elif fno == 5:                    # t (tensor)
            value = _parse_tensor(val)[1]
        elif fno == 8:                    # ints
            # repeated int64 may arrive packed (one LEN record) or as one
            # varint field per element — accumulate, don't overwrite
            got = [_signed64(v) for v in
                   (_packed_varints(val) if wt == _LEN else [val])]
            value = (value + got) if isinstance(value, list) else got
    return name, value


@dataclass
class Node:
    op_type: str
    inputs: list
    outputs: list
    name: str = ""
    attrs: dict = field(default_factory=dict)


@dataclass
class Graph:
    nodes: list
    initializers: dict
    inputs: list
    outputs: list


def _value_info_name(mv):
    for fno, _, val in _fields(mv):
        if fno == 1:
            return bytes(val).decode()
    return ""


def _parse_node(mv):
    node = Node("", [], [])
    for fno, _, val in _fields(mv):
        if fno == 1:
            node.inputs.append(bytes(val).decode())
        elif fno == 2:
            node.outputs.append(bytes(val).decode())
        elif fno == 3:
            node.name = bytes(val).decode()
        elif fno == 4:
            node.op_type = bytes(val).decode()
        elif fno == 5:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


def _parse_graph(mv):
    g = Graph([], {}, [], [])
    for fno, _, val in _fields(mv):
        if fno == 1:
            g.nodes.append(_parse_node(val))
        elif fno == 5:
            name, arr = _parse_tensor(val)
            if arr is not None:     # skip unsupported element types
                g.initializers[name] = arr
        elif fno == 11:
            g.inputs.append(_value_info_name(val))
        elif fno == 12:
            g.outputs.append(_value_info_name(val))
    # fold Constant-node tensors in: exporters sometimes emit weights as
    # Constant ops feeding Conv/Gemm instead of initializers
    for node in g.nodes:
        if node.op_type == "Constant" and node.outputs:
            t = node.attrs.get("value")
            if t is not None:
                g.initializers[node.outputs[0]] = t
    return g


def read_model(path_or_bytes):
    """Parse an ONNX file (or bytes) -> Graph.

    Malformed input (the file is untrusted: truncated varints, lying
    length fields, absurd tensor dims) raises ValueError — never a raw
    IndexError/MemoryError from the wire walk."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    try:
        for fno, _, val in _fields(data):
            if fno == 7:                  # ModelProto.graph
                return _parse_graph(val)
    except ValueError:
        raise
    except (IndexError, TypeError, KeyError, AttributeError, OverflowError,
            MemoryError, RecursionError) as e:
        # e.g. a field carrying the wrong wire type (an int where a
        # length-delimited submessage belongs) — found by the fuzzer
        raise ValueError(f"malformed ONNX protobuf: {e!r}") from e
    raise ValueError("no graph found: not an ONNX ModelProto?")
