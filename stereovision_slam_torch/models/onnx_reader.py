"""Minimal dependency-free ONNX weight reader and writer (the port's own
copy of `models/onnx_reader.py`, numpy only).

The reference system ships its place-recognition backbone as an ONNX file
(`dnn_weights/mobilenet_v2.onnx`, loaded with cv::dnn). Users migrating
may have only that artifact and no `onnx` package, so this module parses
the protobuf wire format directly and extracts the graph initializers
(name -> numpy array); the graph's topology is ignored (the forward is
`models/mobilenet_v2.py`). The writer emits just enough of the format to
round-trip initializers.

Wire-format facts used (see onnx/onnx.proto):
  ModelProto.graph        = field 7  (length-delimited GraphProto)
  GraphProto.initializer  = field 5  (repeated length-delimited TensorProto)
  TensorProto.dims        = field 1  (repeated int64, possibly packed)
  TensorProto.data_type   = field 2  (varint enum)
  TensorProto.float_data  = field 4  (packed float32)
  TensorProto.int32_data  = field 5  (packed varint)
  TensorProto.int64_data  = field 7  (packed varint)
  TensorProto.name        = field 8  (string)
  TensorProto.raw_data    = field 9  (bytes, little-endian)
  TensorProto.double_data = field 10 (packed float64)
"""

from __future__ import annotations

import struct

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(buf: bytes, start: int, end: int):
    """Yield (field_number, wire_type, payload) over a message's bytes.

    payload: int for varint/fixed fields, memoryview slice for
    length-delimited fields.
    """
    i = start
    while i < end:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:       # varint
            val, i = _read_varint(buf, i)
            yield field, wire, val
        elif wire == 1:     # 64-bit
            yield field, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:     # length-delimited
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:     # 32-bit
            yield field, wire, buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: list[float] = []
    varint_data: list[int] = []
    double_data: list[float] = []
    for field, wire, val in _iter_fields(buf, 0, len(buf)):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                j = 0
                while j < len(val):
                    d, j = _read_varint(val, j)
                    dims.append(d)
        elif field == 2 and wire == 0:
            data_type = val
        elif field == 4:
            if wire == 5:
                float_data.append(struct.unpack("<f", bytes(val))[0])
            else:  # packed
                float_data.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field in (5, 7):
            if wire == 0:
                varint_data.append(val)
            else:
                j = 0
                while j < len(val):
                    d, j = _read_varint(val, j)
                    varint_data.append(d)
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 10:
            if wire == 1:
                double_data.append(struct.unpack("<d", bytes(val))[0])
            else:
                double_data.extend(np.frombuffer(bytes(val), "<f8").tolist())
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported data_type "
                         f"{data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
        arr = arr.astype(dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32).astype(dtype)
    elif double_data:
        arr = np.asarray(double_data, np.float64).astype(dtype)
    elif varint_data:
        # int32_data stores values as two's-complement varints
        arr = np.asarray([v - (1 << 64) if v >= (1 << 63) else v
                          for v in varint_data], np.int64).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path: str) -> dict[str, np.ndarray]:
    """All graph initializers of an ONNX model file, as name -> array."""
    with open(path, "rb") as f:
        data = f.read()
    graph = None
    for field, wire, val in _iter_fields(data, 0, len(data)):
        if field == 7 and wire == 2:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto found (not an ONNX model?)")
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(graph, 0, len(graph)):
        if field == 5 and wire == 2:  # GraphProto.initializer
            name, arr = _parse_tensor(bytes(val))
            out[name] = arr
    return out


# --------------------------------------------------------------------- #
# writer (tests + tooling): enough of the wire format to round-trip
# initializers through read_onnx_initializers

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


_NP_TO_ONNX = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
               np.dtype(np.int8): 3, np.dtype(np.int32): 6,
               np.dtype(np.int64): 7, np.dtype(np.float16): 10,
               np.dtype(np.float64): 11}


def write_onnx_initializers(path: str, tensors: dict[str, np.ndarray]) -> None:
    """Write a minimal valid-enough ONNX file holding only initializers."""
    graph = bytearray()
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        t = bytearray()
        for d in arr.shape:
            t += _tag(1, 0) + _varint(d)
        t += _tag(2, 0) + _varint(_NP_TO_ONNX[arr.dtype])
        t += _len_field(8, name.encode("utf-8"))
        t += _len_field(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
        graph += _len_field(5, bytes(t))
    model = _tag(1, 0) + _varint(8)  # ir_version
    model += _len_field(7, bytes(graph))
    with open(path, "wb") as f:
        f.write(model)
