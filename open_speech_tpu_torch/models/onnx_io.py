"""Minimal ONNX protobuf reader: graph initializers as numpy arrays.

Copy of the read side of ``open_speech_tpu/models/onnx_io.py``. Silero VAD
ships its weights as an ONNX file; the port reimplements the graph in
PyTorch and only needs the weights, so this parses the protobuf wire format
directly instead of depending on ``onnx`` or ``onnxruntime``.

Wire-format facts used (see the public onnx.proto3 schema):
  ModelProto.graph            = field 7  (GraphProto)
  GraphProto.initializer      = field 5  (repeated TensorProto)
  TensorProto.dims            = field 1  (repeated int64)
  TensorProto.data_type       = field 2  (enum)
  TensorProto.float_data      = field 4  (repeated float, packed)
  TensorProto.int32_data      = field 5
  TensorProto.int64_data      = field 7
  TensorProto.name            = field 8  (string)
  TensorProto.raw_data        = field 9  (bytes)
  TensorProto.double_data     = field 10
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# TensorProto.DataType values → numpy dtypes
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


# ── varint / wire primitives ───────────────────────────────────────────


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one protobuf message.

    wire 0 → varint int; wire 1 → 8 raw bytes; wire 2 → bytes; wire 5 → 4
    raw bytes. Groups (3/4) are rejected — onnx never uses them.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


# ── TensorProto ────────────────────────────────────────────────────────


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = b""
    f32: list[bytes] = []
    i32: list[int] = []
    i64: list[int] = []
    f64: list[bytes] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims: packed or repeated varint
            if wire == 0:
                dims.append(val)
            else:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    dims.append(d)
        elif field == 2 and wire == 0:
            data_type = val
        elif field == 4:  # float_data
            f32.append(val if wire == 2 else val)
        elif field == 5:
            if wire == 0:
                i32.append(val)
            else:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    i32.append(d)
        elif field == 7:
            if wire == 0:
                i64.append(val)
            else:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    i64.append(d)
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
        elif field == 10:
            f64.append(val)
    np_dtype = _DTYPES.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif f32:
        arr = np.frombuffer(b"".join(f32), dtype=np.float32).astype(np_dtype)
    elif f64:
        arr = np.frombuffer(b"".join(f64), dtype=np.float64).astype(np_dtype)
    elif i64:
        arr = np.asarray(i64, dtype=np.int64).astype(np_dtype)
    elif i32:
        arr = np.asarray(i32, dtype=np.int32).astype(np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path: str | Path | bytes) -> dict[str, np.ndarray]:
    """All ``graph.initializer`` tensors of an ONNX model, name → array."""
    data = path if isinstance(path, bytes) else Path(path).read_bytes()
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(data):  # ModelProto
        if field == 7 and wire == 2:  # graph
            for gfield, gwire, gval in _iter_fields(val):  # GraphProto
                if gfield == 5 and gwire == 2:  # initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out
