"""Minimal self-contained ONNX file reader (and writer, for tests).

A copy of ``metagenomic_deepfri_tpu/models/onnx_reader.py`` (numpy only),
which cannot be imported without jax: its package ``__init__`` loads the JAX
model code.

The reference distributes DeepFRI weights as ONNX graphs (tf2onnx opset 15
exports, reference ``weight_convert/convert_models2onnx.py:41-45``) and
executes them with ONNX Runtime (reference ``predict.pyx:62-72``). The port
replaces the runtime with PyTorch, but still needs to *import* those
weight files — without depending on the ``onnx``/``onnxruntime`` packages.

This module implements just enough of the protobuf wire format to decode
``ModelProto → GraphProto → {NodeProto, TensorProto, ValueInfoProto}`` into
plain Python dataclasses + numpy arrays, and to encode the same subset back
(used to build test fixtures). Field numbers follow onnx.proto3.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# TensorProto.DataType → numpy dtype
DTYPE_MAP = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_TO_ONNX = {np.dtype(v): k for k, v in DTYPE_MAP.items()}


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

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


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"Unsupported wire type {wtype}")
        yield fnum, wtype, val


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_field(out: bytearray, fnum: int, wtype: int, payload):
    _write_varint(out, (fnum << 3) | wtype)
    if wtype == 0:
        _write_varint(out, payload)
    elif wtype == 2:
        _write_varint(out, len(payload))
        out.extend(payload)
    else:
        raise ValueError(wtype)


def _packed_varints(values) -> bytes:
    out = bytearray()
    for v in values:
        _write_varint(out, v)
    return bytes(out)


def _decode_packed_varints(buf: bytes) -> list[int]:
    vals = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        vals.append(v)
    return vals


def _zigzag_to_signed(v: int, bits: int = 64) -> int:
    # ONNX int64 fields are plain (non-zigzag) varints; negative values are
    # encoded as 10-byte two's complement varints.
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------

@dataclass
class OnnxAttribute:
    name: str
    value: object  # int | float | bytes | list | np.ndarray


@dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attributes: dict = field(default_factory=dict)


@dataclass
class OnnxValueInfo:
    name: str
    elem_type: int = 0
    shape: list = field(default_factory=list)  # ints or str dim_params


@dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict            # name -> np.ndarray
    inputs: list[OnnxValueInfo]
    outputs: list[OnnxValueInfo]
    name: str = ""


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def _decode_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            if wtype == 0:
                dims.append(_zigzag_to_signed(val))
            else:
                dims.extend(_zigzag_to_signed(v)
                            for v in _decode_packed_varints(val))
        elif fnum == 2:
            data_type = val
        elif fnum == 4:
            if wtype == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val))
        elif fnum == 5:
            if wtype == 0:
                int32_data.append(_zigzag_to_signed(val, 32))
            else:
                int32_data.extend(_zigzag_to_signed(v, 32)
                                  for v in _decode_packed_varints(val))
        elif fnum == 7:
            if wtype == 0:
                int64_data.append(_zigzag_to_signed(val))
            else:
                int64_data.extend(_zigzag_to_signed(v)
                                  for v in _decode_packed_varints(val))
        elif fnum == 8:
            name = val.decode("utf-8")
        elif fnum == 9:
            raw = val
        elif fnum == 10:
            if wtype == 1:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(struct.unpack(f"<{len(val) // 8}d", val))
    dtype = DTYPE_MAP.get(data_type)
    if dtype is None:
        raise ValueError(f"Unsupported tensor data_type {data_type} ({name})")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype).reshape(dims)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype).reshape(dims)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype).reshape(dims)
    elif double_data:
        arr = np.asarray(double_data, dtype=dtype).reshape(dims)
    else:
        arr = np.zeros(dims, dtype=dtype)
    return name, arr


def _decode_attribute(buf: bytes) -> OnnxAttribute:
    name = ""
    atype = 0
    f_val = i_val = s_val = t_val = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode("utf-8")
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i_val = _zigzag_to_signed(val)
        elif fnum == 4:
            s_val = val
        elif fnum == 5:
            t_val = _decode_tensor(val)[1]
        elif fnum == 7:
            if wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fnum == 8:
            if wtype == 0:
                ints.append(_zigzag_to_signed(val))
            else:
                ints.extend(_zigzag_to_signed(v)
                            for v in _decode_packed_varints(val))
        elif fnum == 9:
            strings.append(val)
        elif fnum == 20:
            atype = val
    if atype == 1 or (atype == 0 and f_val is not None):
        return OnnxAttribute(name, f_val)
    if atype == 2 or (atype == 0 and i_val is not None):
        return OnnxAttribute(name, i_val)
    if atype == 3 or (atype == 0 and s_val is not None):
        return OnnxAttribute(name, s_val)
    if atype == 4 or t_val is not None:
        return OnnxAttribute(name, t_val)
    if atype == 6 or floats:
        return OnnxAttribute(name, floats)
    if atype == 7 or ints:
        return OnnxAttribute(name, ints)
    if atype == 8 or strings:
        return OnnxAttribute(name, strings)
    return OnnxAttribute(name, None)


def _decode_node(buf: bytes) -> OnnxNode:
    node = OnnxNode(op_type="", inputs=[], outputs=[])
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode("utf-8"))
        elif fnum == 2:
            node.outputs.append(val.decode("utf-8"))
        elif fnum == 3:
            node.name = val.decode("utf-8")
        elif fnum == 4:
            node.op_type = val.decode("utf-8")
        elif fnum == 5:
            attr = _decode_attribute(val)
            node.attributes[attr.name] = attr.value
    return node


def _decode_value_info(buf: bytes) -> OnnxValueInfo:
    vi = OnnxValueInfo(name="")
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            vi.name = val.decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim_val = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim_val = v5
                                        elif f5 == 2:
                                            dim_val = v5.decode("utf-8")
                                    vi.shape.append(dim_val)
    return vi


def _decode_graph(buf: bytes) -> OnnxGraph:
    graph = OnnxGraph(nodes=[], initializers={}, inputs=[], outputs=[])
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            graph.nodes.append(_decode_node(val))
        elif fnum == 2:
            graph.name = val.decode("utf-8")
        elif fnum == 5:
            name, arr = _decode_tensor(val)
            graph.initializers[name] = arr
        elif fnum == 11:
            graph.inputs.append(_decode_value_info(val))
        elif fnum == 12:
            graph.outputs.append(_decode_value_info(val))
    return graph


def load_onnx(path: str) -> OnnxGraph:
    """Parse an .onnx file into an :class:`OnnxGraph`."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 7:  # ModelProto.graph
            graph = _decode_graph(val)
    if graph is None:
        raise ValueError(f"No graph found in ONNX file {path}")
    # Graph inputs include initializers in some exporters; keep only true
    # runtime inputs (matching onnxruntime session.get_inputs()).
    graph.inputs = [vi for vi in graph.inputs
                    if vi.name not in graph.initializers]
    return graph


# ---------------------------------------------------------------------------
# Encoding (test fixtures)
# ---------------------------------------------------------------------------

def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    _write_field(out, 1, 2, _packed_varints(
        d & 0xFFFFFFFFFFFFFFFF for d in arr.shape))
    _write_field(out, 2, 0, DTYPE_TO_ONNX[arr.dtype])
    _write_field(out, 8, 2, name.encode("utf-8"))
    _write_field(out, 9, 2, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _encode_attribute(name: str, value) -> bytes:
    out = bytearray()
    _write_field(out, 1, 2, name.encode("utf-8"))
    if isinstance(value, float):
        _write_varint(out, (2 << 3) | 5)
        out.extend(struct.pack("<f", value))
        _write_field(out, 20, 0, 1)
    elif isinstance(value, int):
        _write_field(out, 3, 0, value & 0xFFFFFFFFFFFFFFFF)
        _write_field(out, 20, 0, 2)
    elif isinstance(value, bytes):
        _write_field(out, 4, 2, value)
        _write_field(out, 20, 0, 3)
    elif isinstance(value, np.ndarray):
        _write_field(out, 5, 2, _encode_tensor("", value))
        _write_field(out, 20, 0, 4)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, int) for v in value):
        _write_field(out, 8, 2, _packed_varints(
            v & 0xFFFFFFFFFFFFFFFF for v in value))
        _write_field(out, 20, 0, 7)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, float) for v in value):
        payload = b"".join(struct.pack("<f", v) for v in value)
        _write_field(out, 7, 2, payload)
        _write_field(out, 20, 0, 6)
    else:
        raise TypeError(f"Unsupported attribute value: {value!r}")
    return bytes(out)


def _encode_value_info(name: str, elem_type: int, shape) -> bytes:
    dims = bytearray()
    for d in shape:
        dim = bytearray()
        if isinstance(d, str):
            _write_field(dim, 2, 2, d.encode("utf-8"))
        else:
            _write_field(dim, 1, 0, d)
        _write_field(dims, 1, 2, bytes(dim))
    shape_proto = bytes(dims)
    tensor_type = bytearray()
    _write_field(tensor_type, 1, 0, elem_type)
    _write_field(tensor_type, 2, 2, shape_proto)
    type_proto = bytearray()
    _write_field(type_proto, 1, 2, bytes(tensor_type))
    out = bytearray()
    _write_field(out, 1, 2, name.encode("utf-8"))
    _write_field(out, 2, 2, bytes(type_proto))
    return bytes(out)


def save_onnx(path: str, nodes: list[OnnxNode], initializers: dict,
              inputs: list[tuple], outputs: list[tuple],
              graph_name: str = "graph"):
    """Serialize a minimal ModelProto. inputs/outputs: (name, elem_type, shape)."""
    graph = bytearray()
    for node in nodes:
        nbuf = bytearray()
        for i in node.inputs:
            _write_field(nbuf, 1, 2, i.encode("utf-8"))
        for o in node.outputs:
            _write_field(nbuf, 2, 2, o.encode("utf-8"))
        if node.name:
            _write_field(nbuf, 3, 2, node.name.encode("utf-8"))
        _write_field(nbuf, 4, 2, node.op_type.encode("utf-8"))
        for aname, aval in node.attributes.items():
            _write_field(nbuf, 5, 2, _encode_attribute(aname, aval))
        _write_field(graph, 1, 2, bytes(nbuf))
    _write_field(graph, 2, 2, graph_name.encode("utf-8"))
    for name, arr in initializers.items():
        _write_field(graph, 5, 2, _encode_tensor(name, np.asarray(arr)))
    for name, elem_type, shape in inputs:
        _write_field(graph, 11, 2, _encode_value_info(name, elem_type, shape))
    for name, elem_type, shape in outputs:
        _write_field(graph, 12, 2, _encode_value_info(name, elem_type, shape))

    model = bytearray()
    _write_field(model, 1, 0, 8)  # ir_version
    # opset_import: OperatorSetIdProto {domain="", version=15}
    opset = bytearray()
    _write_field(opset, 2, 0, 15)
    _write_field(model, 8, 2, bytes(opset))
    _write_field(model, 7, 2, bytes(graph))
    with open(path, "wb") as f:
        f.write(bytes(model))
