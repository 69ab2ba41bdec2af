"""Minimal ONNX protobuf writer/reader (no `onnx`/`protobuf` dependency).

The port's own copy of `open_duck_playground_tpu/export/onnx_proto.py`, so
that the exported bytes are the JAX exporter's: exactly the subset needed to
serialize and parse the exported policy graphs (ModelProto / GraphProto /
NodeProto / TensorProto / ValueInfoProto / AttributeProto with float32
tensors). Wire format is plain protobuf (varint + length-delimited fields).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

FLOAT = 1  # TensorProto.DataType.FLOAT


# --------------------------------------------------------------- encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _str_field(field: int, value: str) -> bytes:
    return _len_field(field, value.encode())


def tensor(name: str, array: np.ndarray) -> bytes:
    array = np.ascontiguousarray(array, dtype=np.float32)
    out = b""
    for d in array.shape:
        out += _int_field(1, d)  # dims
    out += _int_field(2, FLOAT)  # data_type
    out += _len_field(9, array.tobytes())  # raw_data
    out += _str_field(8, name)
    return out


def _attr_int(name: str, value: int) -> bytes:
    return _str_field(1, name) + _int_field(3, value) + _int_field(20, 2)  # INT


def _attr_ints(name: str, values: List[int]) -> bytes:
    out = _str_field(1, name)
    for v in values:
        out += _int_field(8, v)
    out += _int_field(20, 7)  # INTS
    return out


def node(
    op_type: str,
    inputs: List[str],
    outputs: List[str],
    name: str = "",
    attrs_int: Optional[Dict[str, int]] = None,
    attrs_ints: Optional[Dict[str, List[int]]] = None,
) -> bytes:
    out = b""
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    out += _str_field(3, name or outputs[0])
    out += _str_field(4, op_type)
    for k, v in (attrs_int or {}).items():
        out += _len_field(5, _attr_int(k, v))
    for k, v in (attrs_ints or {}).items():
        out += _len_field(5, _attr_ints(k, v))
    return out


def value_info(name: str, shape: Tuple[int, ...]) -> bytes:
    dims = b""
    for d in shape:
        dims += _len_field(1, _int_field(1, d))  # Dimension.dim_value
    tensor_type = _int_field(1, FLOAT) + _len_field(2, dims)
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_proto)


def graph(
    nodes: List[bytes],
    name: str,
    initializers: List[bytes],
    inputs: List[bytes],
    outputs: List[bytes],
) -> bytes:
    out = b""
    for n in nodes:
        out += _len_field(1, n)
    out += _str_field(2, name)
    for t in initializers:
        out += _len_field(5, t)
    for i in inputs:
        out += _len_field(11, i)
    for o in outputs:
        out += _len_field(12, o)
    return out


def model(graph_bytes: bytes, opset: int = 11, producer: str = "odp-tpu") -> bytes:
    # the JAX exporter's producer name, so both write the same bytes
    opset_import = _int_field(2, opset)  # domain omitted = default ""
    out = _int_field(1, 7)  # ir_version 7 (matches opset 11 era)
    out += _str_field(2, producer)
    out += _len_field(7, graph_bytes)
    out += _len_field(8, opset_import)
    return out


# --------------------------------------------------------------- decoding
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yields (field_number, wire_type, value) where value is int (wire 0) or
    bytes (wire 2)."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<I", buf[pos : pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack("<Q", buf[pos : pos + 8])[0]
            pos += 8
        else:  # pragma: no cover
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims, raw, name, floats = [], None, "", []
    for field, wire, val in _fields(buf):
        if field == 1:
            dims.append(val)
        elif field == 2:
            assert val == FLOAT, f"only float32 tensors supported, got {val}"
        elif field == 9:
            raw = val
        elif field == 8:
            name = val.decode()
        elif field == 4:
            if wire == 2:  # packed floats
                floats.extend(np.frombuffer(val, np.float32).tolist())
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", val))[0])
    if raw is not None:
        arr = np.frombuffer(raw, np.float32).reshape(dims)
    else:
        arr = np.asarray(floats, np.float32).reshape(dims)
    return name, arr


def parse_node(buf: bytes) -> dict:
    n = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
    for field, wire, val in _fields(buf):
        if field == 1:
            n["inputs"].append(val.decode())
        elif field == 2:
            n["outputs"].append(val.decode())
        elif field == 4:
            n["op"] = val.decode()
        elif field == 5:
            name, ival, ints = "", None, []
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    name = v2.decode()
                elif f2 == 3:
                    ival = v2
                elif f2 == 8:
                    ints.append(v2)
            n["attrs"][name] = ints if ints else ival
    return n


def parse_model(buf: bytes) -> dict:
    out = {"nodes": [], "initializers": {}, "inputs": [], "outputs": []}
    gbuf = None
    for field, wire, val in _fields(buf):
        if field == 7:
            gbuf = val
    assert gbuf is not None, "no graph in model"
    for field, wire, val in _fields(gbuf):
        if field == 1:
            out["nodes"].append(parse_node(val))
        elif field == 5:
            name, arr = parse_tensor(val)
            out["initializers"][name] = arr
        elif field == 11:
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    out["inputs"].append(v2.decode())
        elif field == 12:
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    out["outputs"].append(v2.decode())
    return out
