"""Strict ONNX artifact validator, a stand-in for loading the exported policy
into onnxruntime (the reference's deployment contract,
playground/common/onnx_infer.py:7-9). Counterpart of
`open_duck_playground_tpu/export/onnx_validate.py`, with no `onnx` or
`protobuf` dependency, so it also runs on the card's machine.

Three layers of checking, mirroring what onnxruntime's loader does:

1. **Wire format**: the bytes are decoded against `SCHEMA`, the field
   numbers and types of the subset of the official onnx.proto3 schema that
   the JAX package's `onnx_schema.proto` describes, with the rules of the
   protobuf runtime: a field number or wire type outside the schema at any
   depth, wire types 6 and 7, a varint longer than 10 bytes (5 for a tag),
   a length or fixed-width value running past its end, a packed run that
   does not end on an element, invalid UTF-8 in a `string` field, and more
   than 100 levels of nested messages are rejected; a scalar given twice
   keeps the last value, a message given twice is merged, and a repeated
   number may come packed, unpacked or both.
2. **Model/graph well-formedness** (onnx.checker equivalents): ir_version,
   a default-domain opset import, tensor dtype/dims/raw_data-length
   consistency, attribute type-tag vs payload consistency, SSA form with
   topologically sorted nodes, resolvable inputs, unique value names.
3. **Shape inference** over the opset-11 ops the exporter emits
   (Sub/Div/MatMul/Add/Mul/Sigmoid/Tanh/Split): recomputes every
   intermediate shape from the declared graph input and the initializers
   and checks the declared graph outputs match.

`validate(blob)` raises OnnxValidationError with a precise message, or
returns a summary dict on success.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

FLOAT = 1  # TensorProto.DataType.FLOAT

# field number -> (name, type, repeated, oneof group or None), per message.
# A type is a scalar kind below or the name of another message.
_INT64, _INT32, _UINT64, _ENUM = "int64", "int32", "uint64", "enum"
_FLOAT, _DOUBLE, _STRING, _BYTES = "float", "double", "string", "bytes"
SCHEMA: Dict[str, Dict[int, tuple]] = {
    "ModelProto": {
        1: ("ir_version", _INT64, False, None),
        2: ("producer_name", _STRING, False, None),
        3: ("producer_version", _STRING, False, None),
        4: ("domain", _STRING, False, None),
        5: ("model_version", _INT64, False, None),
        6: ("doc_string", _STRING, False, None),
        7: ("graph", "GraphProto", False, None),
        8: ("opset_import", "OperatorSetIdProto", True, None),
        14: ("metadata_props", "StringStringEntryProto", True, None),
    },
    "AttributeProto": {
        1: ("name", _STRING, False, None),
        2: ("f", _FLOAT, False, None),
        3: ("i", _INT64, False, None),
        4: ("s", _BYTES, False, None),
        5: ("t", "TensorProto", False, None),
        6: ("g", "GraphProto", False, None),
        7: ("floats", _FLOAT, True, None),
        8: ("ints", _INT64, True, None),
        9: ("strings", _BYTES, True, None),
        10: ("tensors", "TensorProto", True, None),
        11: ("graphs", "GraphProto", True, None),
        13: ("doc_string", _STRING, False, None),
        20: ("type", _ENUM, False, None),
        21: ("ref_attr_name", _STRING, False, None),
    },
    "ValueInfoProto": {
        1: ("name", _STRING, False, None),
        2: ("type", "TypeProto", False, None),
        3: ("doc_string", _STRING, False, None),
    },
    "NodeProto": {
        1: ("input", _STRING, True, None),
        2: ("output", _STRING, True, None),
        3: ("name", _STRING, False, None),
        4: ("op_type", _STRING, False, None),
        5: ("attribute", "AttributeProto", True, None),
        6: ("doc_string", _STRING, False, None),
        7: ("domain", _STRING, False, None),
    },
    "StringStringEntryProto": {
        1: ("key", _STRING, False, None),
        2: ("value", _STRING, False, None),
    },
    "GraphProto": {
        1: ("node", "NodeProto", True, None),
        2: ("name", _STRING, False, None),
        5: ("initializer", "TensorProto", True, None),
        10: ("doc_string", _STRING, False, None),
        11: ("input", "ValueInfoProto", True, None),
        12: ("output", "ValueInfoProto", True, None),
        13: ("value_info", "ValueInfoProto", True, None),
    },
    "TensorProto": {
        1: ("dims", _INT64, True, None),
        2: ("data_type", _INT32, False, None),
        4: ("float_data", _FLOAT, True, None),
        5: ("int32_data", _INT32, True, None),
        6: ("string_data", _BYTES, True, None),
        7: ("int64_data", _INT64, True, None),
        8: ("name", _STRING, False, None),
        9: ("raw_data", _BYTES, False, None),
        10: ("double_data", _DOUBLE, True, None),
        11: ("uint64_data", _UINT64, True, None),
        12: ("doc_string", _STRING, False, None),
        13: ("external_data", "StringStringEntryProto", True, None),
        14: ("data_location", _INT32, False, None),
    },
    "TensorShapeProto": {
        1: ("dim", "TensorShapeProto.Dimension", True, None),
    },
    "TensorShapeProto.Dimension": {
        1: ("dim_value", _INT64, False, "value"),
        2: ("dim_param", _STRING, False, "value"),
        3: ("denotation", _STRING, False, None),
    },
    "TypeProto": {
        1: ("tensor_type", "TypeProto.Tensor", False, "value"),
        6: ("denotation", _STRING, False, None),
    },
    "TypeProto.Tensor": {
        1: ("elem_type", _INT32, False, None),
        2: ("shape", "TensorShapeProto", False, None),
    },
    "OperatorSetIdProto": {
        1: ("domain", _STRING, False, None),
        2: ("version", _INT64, False, None),
    },
}

# the wire type each kind is written with; a repeated number also comes packed (2)
_WIRE = {_INT64: 0, _INT32: 0, _UINT64: 0, _ENUM: 0, _FLOAT: 5, _DOUBLE: 1,
         _STRING: 2, _BYTES: 2}
_DEFAULT = {_INT64: 0, _INT32: 0, _UINT64: 0, _ENUM: 0, _FLOAT: 0.0, _DOUBLE: 0.0,
            _STRING: "", _BYTES: b""}
_FIELDS = {msg: {name: (kind, repeated) for name, kind, repeated, _ in fields.values()}
           for msg, fields in SCHEMA.items()}
MAX_DEPTH = 100  # nested message levels below the top one (the runtime's limit)

# TensorProto.DataType values that may appear in raw_data -> bytes per element
_DTYPE_SIZE = {1: 4, 2: 1, 3: 1, 4: 2, 5: 2, 6: 4, 7: 8, 9: 1, 10: 2, 11: 8, 12: 4, 13: 8, 16: 2}

# AttributeProto.AttributeType
UNDEFINED, A_FLOAT, A_INT, A_STRING, A_TENSOR, A_GRAPH, A_FLOATS, A_INTS, A_STRINGS = range(9)
_ATTRIBUTE_TYPE_NAMES = ("UNDEFINED", "FLOAT", "INT", "STRING", "TENSOR", "GRAPH", "FLOATS",
                         "INTS", "STRINGS", "TENSORS", "GRAPHS", "SPARSE_TENSOR")

# (min_inputs, max_inputs, n_outputs) for every op the exporter can emit,
# per the opset-11 operator schemas
_OP_ARITY = {
    "Sub": (2, 2, 1),
    "Div": (2, 2, 1),
    "Add": (2, 2, 1),
    "Mul": (2, 2, 1),
    "MatMul": (2, 2, 1),
    "Sigmoid": (1, 1, 1),
    "Tanh": (1, 1, 1),
    "Split": (1, 1, None),  # variadic outputs
}


class OnnxValidationError(ValueError):
    pass


def _fail(msg: str):
    raise OnnxValidationError(msg)


# --------------------------------------------------------------- wire format
class Message:
    """A decoded message: fields by name, proto3 defaults for the unset ones.
    A message field is present once it occurred (`has`); a oneof group
    remembers which member came last (`which`)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.values: dict = {}
        self.oneofs: dict = {}

    def __getattr__(self, name):
        values = self.__dict__.get("values", {})
        if name in values:
            return values[name]
        if name not in _FIELDS.get(self.__dict__.get("kind"), {}):
            raise AttributeError(name)
        kind, repeated = _FIELDS[self.kind][name]
        if repeated:
            return []
        return _DEFAULT[kind] if kind in _DEFAULT else Message(kind)

    def has(self, name: str) -> bool:
        return name in self.values

    def which(self, group: str):
        return self.oneofs.get(group)


def _varint(buf: bytes, pos: int, end: int, max_bytes: int = 10) -> Tuple[int, int]:
    result = 0
    for k in range(max_bytes):
        if pos >= end:
            _fail("protobuf parse failed: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << (7 * k)
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
    _fail(f"protobuf parse failed: varint longer than {max_bytes} bytes")


def _signed(value: int, bits: int) -> int:
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _scalar(kind: str, value: int) -> int:
    if kind == _INT64:
        return _signed(value, 64)
    if kind in (_INT32, _ENUM):
        return _signed(value, 32)
    return value  # uint64


def _fixed(buf: bytes, pos: int, end: int, kind: str):
    size = 4 if kind == _FLOAT else 8
    if pos + size > end:
        _fail("protobuf parse failed: truncated fixed-width value")
    return struct.unpack_from("<f" if kind == _FLOAT else "<d", buf, pos)[0], pos + size


def _packed(buf: bytes, pos: int, end: int, kind: str) -> list:
    out = []
    while pos < end:
        if kind in (_FLOAT, _DOUBLE):
            v, pos = _fixed(buf, pos, end, kind)
        else:
            v, pos = _varint(buf, pos, end)
            v = _scalar(kind, v)
        out.append(v)
    return out


def _decode(buf: bytes, pos: int, end: int, msg: Message, depth: int) -> Message:
    """Decode buf[pos:end] into `msg` (merging into what it holds)."""
    schema = SCHEMA[msg.kind]
    while pos < end:
        key, pos = _varint(buf, pos, end, max_bytes=5)
        if key >> 32:
            _fail("protobuf parse failed: tag out of range")
        number, wire = key >> 3, key & 7
        if number == 0:
            _fail("protobuf parse failed: field number 0")
        if wire in (6, 7):
            _fail(f"protobuf parse failed: invalid wire type {wire}")
        name, kind, repeated, group = schema.get(number, (None, None, False, None))
        packable = repeated and _WIRE.get(kind, 2) != 2
        if name is None or not (wire == _WIRE.get(kind, 2) or (packable and wire == 2)):
            _fail(f"{msg.kind}: unknown protobuf field {(number, wire)} - outside the ONNX schema")
        if wire == 0:
            v, pos = _varint(buf, pos, end)
            value = _scalar(kind, v)
        elif wire in (1, 5):
            value, pos = _fixed(buf, pos, end, kind)
        else:
            n, pos = _varint(buf, pos, end)
            if n > end - pos:
                _fail("protobuf parse failed: length-delimited field runs past its end")
            sub_end = pos + n
            if packable:
                msg.values.setdefault(name, []).extend(_packed(buf, pos, sub_end, kind))
                pos = sub_end
                continue
            if kind == _STRING:
                try:
                    value = buf[pos:sub_end].decode("utf-8")
                except UnicodeDecodeError:
                    _fail(f"protobuf parse failed: {msg.kind}.{name} is not valid UTF-8")
            elif kind == _BYTES:
                value = bytes(buf[pos:sub_end])
            else:
                if depth >= MAX_DEPTH:
                    _fail("protobuf parse failed: messages nested too deep")
                if repeated:
                    value = _decode(buf, pos, sub_end, Message(kind), depth + 1)
                else:
                    # a message given twice is merged; a oneof member that was
                    # not the group's last one starts anew
                    old = msg.values.get(name)
                    if old is None or (group is not None and msg.oneofs.get(group) != name):
                        old = Message(kind)
                    value = _decode(buf, pos, sub_end, old, depth + 1)
            pos = sub_end
        if repeated:
            msg.values.setdefault(name, []).append(value)
            continue
        if group is not None:
            last = msg.oneofs.get(group)
            if last is not None and last != name:
                msg.values.pop(last, None)
            msg.oneofs[group] = name
        msg.values[name] = value
    return msg


def parse(blob: bytes, kind: str = "ModelProto") -> Message:
    """Decode `blob` as a `kind` message under the wire rules above."""
    blob = bytes(blob)
    return _decode(blob, 0, len(blob), Message(kind), 0)


# --------------------------------------------------------------- model checks
def _tensor_shape(vi: Message, path: str) -> Tuple[int, ...]:
    if vi.type.which("value") != "tensor_type":
        _fail(f"{path} '{vi.name}': TypeProto must be tensor_type")
    tt = vi.type.tensor_type
    if tt.elem_type != FLOAT:
        _fail(f"{path} '{vi.name}': elem_type {tt.elem_type} != FLOAT")
    dims = []
    for i, d in enumerate(tt.shape.dim):
        which = d.which("value")
        if which == "dim_value":
            if d.dim_value <= 0:
                _fail(f"{path} '{vi.name}': dim[{i}] = {d.dim_value} <= 0")
            dims.append(int(d.dim_value))
        elif which == "dim_param":
            dims.append(-1)  # symbolic
        else:
            _fail(f"{path} '{vi.name}': dim[{i}] has neither value nor param")
    return tuple(dims)


def _check_attribute(a: Message, node_name: str):
    if not a.name:
        _fail(f"node '{node_name}': attribute with empty name")
    # onnx.checker: `type` must be set and exactly the matching payload
    # field populated
    payload = {
        A_FLOAT: True,  # proto3 scalar: 0.0 is valid
        A_INT: True,  # proto3 scalar: 0 is valid
        A_STRING: True,
        A_TENSOR: a.has("t"),
        A_GRAPH: a.has("g"),
        A_FLOATS: len(a.floats) > 0,
        A_INTS: len(a.ints) > 0,
        A_STRINGS: len(a.strings) > 0,
    }
    if a.type == UNDEFINED:
        _fail(f"node '{node_name}' attr '{a.name}': type UNDEFINED")
    if a.type not in payload or not payload[a.type]:
        name = (_ATTRIBUTE_TYPE_NAMES[a.type] if 0 <= a.type < len(_ATTRIBUTE_TYPE_NAMES)
                else f"<unknown {a.type}>")
        _fail(f"node '{node_name}' attr '{a.name}': type tag {name} does not match "
              f"its populated payload")
    # no stray payloads of other kinds
    stray = []
    if a.type != A_INTS and len(a.ints):
        stray.append("ints")
    if a.type != A_FLOATS and len(a.floats):
        stray.append("floats")
    if a.type != A_TENSOR and a.has("t"):
        stray.append("t")
    if stray:
        _fail(f"node '{node_name}' attr '{a.name}': stray payload {stray}")


def _broadcast(s1, s2, ctx: str) -> Tuple[int, ...]:
    """Numpy-style multidirectional broadcast (the opset-11 rule for
    elementwise binary ops)."""
    out = []
    for d1, d2 in zip((1,) * (len(s2) - len(s1)) + s1, (1,) * (len(s1) - len(s2)) + s2):
        if d1 == d2 or d2 == 1:
            out.append(d1)
        elif d1 == 1:
            out.append(d2)
        else:
            _fail(f"{ctx}: shapes {s1} and {s2} are not broadcastable")
    return tuple(out)


def validate(blob: bytes) -> dict:
    """Validate an exported ONNX artifact. Raises OnnxValidationError on any
    defect a standards-compliant consumer could reject; returns a summary
    dict (op counts, parameter count, io shapes) on success."""
    m = parse(blob)

    if not 3 <= m.ir_version <= 10:
        _fail(f"ir_version {m.ir_version} outside supported range [3, 10]")
    default_opsets = [o for o in m.opset_import if o.domain == ""]
    if len(default_opsets) != 1:
        _fail(f"expected exactly one default-domain opset import, got "
              f"{[(o.domain, o.version) for o in m.opset_import]}")
    opset = default_opsets[0].version
    if opset < 1:
        _fail(f"opset version {opset} < 1")
    if not m.has("graph"):
        _fail("model has no graph")
    g = m.graph

    # ---- initializers
    inits: Dict[str, Tuple[int, ...]] = {}
    n_params = 0
    for t in g.initializer:
        if not t.name:
            _fail("initializer with empty name")
        if t.name in inits:
            _fail(f"duplicate initializer '{t.name}'")
        if t.data_type not in _DTYPE_SIZE:
            _fail(f"initializer '{t.name}': invalid data_type {t.data_type}")
        dims = tuple(int(d) for d in t.dims)
        if any(d < 0 for d in dims):
            _fail(f"initializer '{t.name}': negative dim in {dims}")
        n_elem = int(np.prod(dims)) if dims else 1
        typed = (
            len(t.float_data)
            or len(t.int32_data)
            or len(t.int64_data)
            or len(t.double_data)
            or len(t.uint64_data)
            or len(t.string_data)
        )
        if t.raw_data:
            if typed:
                _fail(f"initializer '{t.name}': both raw_data and typed data set")
            want = n_elem * _DTYPE_SIZE[t.data_type]
            if len(t.raw_data) != want:
                _fail(
                    f"initializer '{t.name}': raw_data is {len(t.raw_data)} "
                    f"bytes, dims {dims} require {want}"
                )
        elif typed != n_elem:
            _fail(f"initializer '{t.name}': {typed} typed values, dims need {n_elem}")
        if t.data_location not in (0,):  # DEFAULT only; EXTERNAL unsupported
            _fail(f"initializer '{t.name}': external data_location")
        inits[t.name] = dims
        n_params += n_elem

    # ---- graph io
    shapes: Dict[str, Tuple[int, ...]] = dict(inits)
    for vi in g.input:
        if not vi.name:
            _fail("graph input with empty name")
        shapes[vi.name] = _tensor_shape(vi, "graph input")
    declared_out = {vi.name: _tensor_shape(vi, "graph output") for vi in g.output}
    if not declared_out:
        _fail("graph has no outputs")

    # ---- nodes: SSA, topological order, arity, attributes, shape inference
    op_counts: Dict[str, int] = {}
    for k, node in enumerate(g.node):
        ctx = f"node[{k}] '{node.name or node.op_type}'"
        if node.domain not in ("", "ai.onnx"):
            _fail(f"{ctx}: non-default domain '{node.domain}'")
        if node.op_type not in _OP_ARITY:
            _fail(f"{ctx}: op '{node.op_type}' not in the exporter's opset-11 set")
        lo, hi, n_out = _OP_ARITY[node.op_type]
        if not lo <= len(node.input) <= hi:
            _fail(f"{ctx}: {len(node.input)} inputs, schema wants [{lo},{hi}]")
        if n_out is not None and len(node.output) != n_out:
            _fail(f"{ctx}: {len(node.output)} outputs, schema wants {n_out}")
        for a in node.attribute:
            _check_attribute(a, node.name or node.op_type)
        for i in node.input:
            if i not in shapes:
                _fail(
                    f"{ctx}: input '{i}' is not a graph input, initializer, "
                    f"or earlier node output (graph not topologically sorted "
                    f"or dangling reference)"
                )
        op_counts[node.op_type] = op_counts.get(node.op_type, 0) + 1

        # shape inference for the supported op set
        attrs = {a.name: a for a in node.attribute}
        if node.op_type in ("Sub", "Div", "Add", "Mul"):
            out_shapes = [
                _broadcast(shapes[node.input[0]], shapes[node.input[1]], ctx)
            ]
        elif node.op_type in ("Sigmoid", "Tanh"):
            out_shapes = [shapes[node.input[0]]]
        elif node.op_type == "MatMul":
            s1, s2 = shapes[node.input[0]], shapes[node.input[1]]
            if len(s1) != 2 or len(s2) != 2:
                _fail(f"{ctx}: only 2-D MatMul expected, got {s1} x {s2}")
            if s1[1] != s2[0] and -1 not in (s1[1], s2[0]):
                _fail(f"{ctx}: MatMul inner dims mismatch {s1} x {s2}")
            out_shapes = [(s1[0], s2[1])]
        else:  # Split, the last op of _OP_ARITY
            if "axis" not in attrs:
                _fail(f"{ctx}: Split without axis attribute")
            axis = int(attrs["axis"].i)
            s = shapes[node.input[0]]
            if not -len(s) <= axis < len(s):
                _fail(f"{ctx}: Split axis {axis} out of range for {s}")
            axis %= len(s)
            if "split" in attrs:
                parts = [int(v) for v in attrs["split"].ints]
                if len(parts) != len(node.output):
                    _fail(f"{ctx}: {len(parts)} split sizes, {len(node.output)} outputs")
                if s[axis] != -1 and sum(parts) != s[axis]:
                    _fail(f"{ctx}: split sizes {parts} don't sum to dim {s[axis]}")
            else:
                if s[axis] != -1 and s[axis] % len(node.output):
                    _fail(f"{ctx}: dim {s[axis]} not divisible into {len(node.output)}")
                parts = [s[axis] // len(node.output)] * len(node.output)
            out_shapes = [s[:axis] + (p,) + s[axis + 1 :] for p in parts]

        for o, os_ in zip(node.output, out_shapes):
            if not o:
                _fail(f"{ctx}: empty output name")
            if o in shapes:
                _fail(f"{ctx}: output '{o}' redefines an existing value (not SSA)")
            shapes[o] = os_

    for name, want in declared_out.items():
        if name not in shapes:
            _fail(f"graph output '{name}' is produced by no node")
        got = shapes[name]
        if len(got) != len(want) or any(
            w != -1 and gdim != -1 and w != gdim for w, gdim in zip(want, got)
        ):
            _fail(f"graph output '{name}': declared {want}, inferred {got}")

    return {
        "ir_version": int(m.ir_version),
        "opset": int(opset),
        "n_nodes": len(g.node),
        "n_params": n_params,
        "op_counts": op_counts,
        "inputs": {vi.name: _tensor_shape(vi, "graph input") for vi in g.input},
        "outputs": declared_out,
    }


def validate_file(path: str) -> dict:
    with open(path, "rb") as f:
        return validate(f.read())
