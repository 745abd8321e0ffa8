"""A weights folder in the published models' format, from the benchmark's
weights: ONNX graphs in the tf2onnx export pattern, their term lists and a
``model_config.json``, as ``predict-function`` and the server load them.

Copied, cut to the unidirectional LSTM-LM and the in-graph symmetric
adjacency normalisation that the published GCNs carry, from the port's
``models/tf2onnx_fixture.py`` (the graph pattern), ``models/onnx_reader.py``
(the protobuf encoding) and ``models/onnx_import.py``
(``lstm_params_to_onnx``, the gate order [i, o, f, c]).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_F32, _INT32, _INT64, _F64 = 1, 6, 7, 11
_ONNX_TYPE = {np.dtype(np.float32): _F32, np.dtype(np.int32): _INT32,
              np.dtype(np.int64): _INT64, np.dtype(np.float64): _F64}


# -- protobuf wire format -----------------------------------------------------

def _varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _field(out: bytearray, fnum: int, wtype: int, payload) -> None:
    _varint(out, (fnum << 3) | wtype)
    if wtype == 0:
        _varint(out, payload)
    else:
        _varint(out, len(payload))
        out.extend(payload)


def _packed(values) -> bytes:
    out = bytearray()
    for v in values:
        _varint(out, v & 0xFFFFFFFFFFFFFFFF)
    return bytes(out)


def _tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    _field(out, 1, 2, _packed(arr.shape))
    _field(out, 2, 0, _ONNX_TYPE[arr.dtype])
    _field(out, 8, 2, name.encode())
    _field(out, 9, 2, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _attribute(name: str, value) -> bytes:
    out = bytearray()
    _field(out, 1, 2, name.encode())
    if isinstance(value, float):
        _varint(out, (2 << 3) | 5)
        out.extend(struct.pack("<f", value))
        _field(out, 20, 0, 1)
    elif isinstance(value, int):
        _field(out, 3, 0, value & 0xFFFFFFFFFFFFFFFF)
        _field(out, 20, 0, 2)
    elif isinstance(value, bytes):
        _field(out, 4, 2, value)
        _field(out, 20, 0, 3)
    elif isinstance(value, np.ndarray):
        _field(out, 5, 2, _tensor("", value))
        _field(out, 20, 0, 4)
    else:  # a list of ints
        _field(out, 8, 2, _packed(value))
        _field(out, 20, 0, 7)
    return bytes(out)


def _value_info(name: str, elem_type: int, shape) -> bytes:
    dims = bytearray()
    for d in shape:
        dim = bytearray()
        if isinstance(d, str):
            _field(dim, 2, 2, d.encode())
        else:
            _field(dim, 1, 0, d)
        _field(dims, 1, 2, bytes(dim))
    tensor_type = bytearray()
    _field(tensor_type, 1, 0, elem_type)
    _field(tensor_type, 2, 2, bytes(dims))
    type_proto = bytearray()
    _field(type_proto, 1, 2, bytes(tensor_type))
    out = bytearray()
    _field(out, 1, 2, name.encode())
    _field(out, 2, 2, bytes(type_proto))
    return bytes(out)


class _Graph:
    def __init__(self):
        self.nodes: list = []
        self.init: dict = {}
        self._n = 0

    def node(self, op, inputs, n_out=1, **attrs):
        outs = [f"{op.lower()}_{self._n}_{k}" for k in range(n_out)]
        self._n += 1
        self.nodes.append((op, list(inputs), outs, attrs))
        return outs[0] if n_out == 1 else outs

    def ini(self, value, dtype=np.float32):
        name = f"const_{self._n}"
        self._n += 1
        self.init[name] = np.asarray(value, dtype)
        return name

    def save(self, path: Path, inputs, outputs) -> None:
        graph = bytearray()
        for op, ins, outs, attrs in self.nodes:
            n = bytearray()
            for i in ins:
                _field(n, 1, 2, i.encode())
            for o in outs:
                _field(n, 2, 2, o.encode())
            _field(n, 3, 2, outs[0].encode())
            _field(n, 4, 2, op.encode())
            for k, v in attrs.items():
                _field(n, 5, 2, _attribute(k, v))
            _field(graph, 1, 2, bytes(n))
        _field(graph, 2, 2, b"model")
        for name, arr in self.init.items():
            _field(graph, 5, 2, _tensor(name, arr))
        for name, t, shape in inputs:
            _field(graph, 11, 2, _value_info(name, t, shape))
        for name, t, shape in outputs:
            _field(graph, 12, 2, _value_info(name, t, shape))
        model = bytearray()
        _field(model, 1, 0, 8)                 # ir_version
        opset = bytearray()
        _field(opset, 2, 0, 15)
        _field(model, 8, 2, bytes(opset))      # opset 15
        _field(model, 7, 2, bytes(graph))
        Path(path).write_bytes(bytes(model))


# -- the graphs ---------------------------------------------------------------

def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      np.float32)


def _iofc(w: np.ndarray, hidden: int) -> np.ndarray:
    """Gate axis 0 from [i, f, c, o] to ONNX's [i, o, f, c]."""
    i, f, c, o = (w[k * hidden:(k + 1) * hidden] for k in range(4))
    return np.concatenate([i, o, f, c], axis=0)


def _dense(g: _Graph, x: str, layer: dict) -> str:
    """Keras Dense as tf2onnx writes it: Gemm with an (out, in) kernel."""
    return g.node("Gemm", [x, g.ini(_np(layer["kernel"]).T),
                           g.ini(_np(layer["bias"]))], transB=1)


def _head(g: _Graph, x: str, batch_vec: str, head: dict, terms: int) -> str:
    logits = _dense(g, x, head)
    target = g.node("Concat", [batch_vec, g.ini([terms], np.int64),
                               g.ini([2], np.int64)], axis=0)
    return g.node("Softmax", [g.node("Reshape", [logits, target])], axis=-1)


def write_gcn(path: Path, tree: dict, terms: int, vocab: int) -> None:
    """A GCN with a unidirectional LSTM-LM and the symmetric adjacency
    normalisation inside the graph."""
    g = _Graph()
    adj = g.node("Identity", ["input_1"])
    seq = g.node("Identity", ["input_2"])
    x_tm = g.node("Transpose", [seq], perm=[1, 0, 2])
    shp = g.node("Shape", [x_tm])
    len_vec = g.node("Unsqueeze", [g.node("Gather", [shp, g.ini(0, np.int64)],
                                          axis=0), g.ini([0], np.int64)])
    batch_vec = g.node("Unsqueeze", [g.node(
        "Gather", [shp, g.ini(1, np.int64)], axis=0), g.ini([0], np.int64)])
    seq_lens = g.node("Cast", [g.node("Expand", [len_vec, batch_vec])],
                      to=_INT32)
    lm_out = None
    for li, layer in enumerate(tree["lm"]):
        if li:
            x_tm = g.node("Transpose", [lm_out], perm=[1, 0, 2])
        hidden = _np(layer["recurrent"]).shape[0]
        W = _iofc(_np(layer["kernel"]).T, hidden)[None]
        R = _iofc(_np(layer["recurrent"]).T, hidden)[None]
        wb = _iofc(_np(layer["bias"]), hidden)
        B = np.concatenate([wb, np.zeros_like(wb)])[None]
        shape3 = g.node("Concat", [g.ini([1], np.int64), batch_vec,
                                   g.ini([hidden], np.int64)], axis=0)
        h0 = g.node("ConstantOfShape", [shape3],
                    value=np.zeros(1, np.float32))
        c0 = g.node("Identity", [h0])
        y, _, _ = g.node("LSTM", [x_tm, g.ini(W), g.ini(R), g.ini(B),
                                  seq_lens, h0, c0],
                         n_out=3, hidden_size=hidden, direction=b"forward")
        yt = g.node("Transpose", [y], perm=[2, 0, 1, 3])
        target = g.node("Concat", [batch_vec, len_vec,
                                   g.ini([hidden], np.int64)], axis=0)
        lm_out = g.node("Reshape", [yt, target])
    x_lm = g.node("MatMul", [lm_out, g.ini(_np(tree["lm_embed"]["kernel"]))])
    x_aa = g.node("Add", [g.node("MatMul", [seq, g.ini(
        _np(tree["aa_embed"]["kernel"]))]), g.ini(
            _np(tree["aa_embed"]["bias"]))])
    h = g.node("Relu", [g.node("Add", [x_lm, x_aa])])
    deg = g.node("ReduceSum", [adj, g.ini([2], np.int64)], keepdims=1)
    s = g.node("Sqrt", [deg])
    a_used = g.node("Div", [g.node("Div", [adj, s]),
                            g.node("Transpose", [s], perm=[0, 2, 1])])
    layers = []
    for layer in tree["gc"]:
        agg = g.node("MatMul", [a_used, h])
        h = g.node("Relu", [g.node("MatMul", [agg, g.ini(
            _np(layer["kernel"]))])])
        layers.append(h)
    pooled = g.node("ReduceSum", [g.node("Concat", layers, axis=-1),
                                  g.ini([1], np.int64)], keepdims=0)
    for layer in tree["fc"]:
        pooled = g.node("Relu", [_dense(g, pooled, layer)])
    out = _head(g, pooled, batch_vec, tree["head"], terms)
    g.save(path, [("input_1", _F32, ["unk__0", "unk__1", "unk__2"]),
                  ("input_2", _F32, ["unk__3", "unk__4", vocab])],
           [(out, _F32, ["unk__5", terms, 2])])


def write_cnn(path: Path, tree: dict, terms: int, vocab: int) -> None:
    """A CNN: 'SAME' Conv branches, ReLU, a max over the length, the dense
    stack and the head."""
    g = _Graph()
    seq = g.node("Identity", ["input_1"])
    shp = g.node("Shape", [seq])
    batch_vec = g.node("Unsqueeze", [g.node(
        "Gather", [shp, g.ini(0, np.int64)], axis=0), g.ini([0], np.int64)])
    s_ncw = g.node("Transpose", [seq], perm=[0, 2, 1])
    branches = []
    for conv in tree["conv"]:
        w = np.transpose(_np(conv["kernel"]), (2, 1, 0))
        k = w.shape[-1]
        y = g.node("Conv", [s_ncw, g.ini(w), g.ini(_np(conv["bias"]))],
                   pads=[(k - 1) // 2, k - 1 - (k - 1) // 2], strides=[1])
        branches.append(g.node("Transpose", [y], perm=[0, 2, 1]))
    act = g.node("Relu", [g.node("Concat", branches, axis=-1)])
    pooled = g.node("ReduceMax", [act, g.ini([1], np.int64)], keepdims=0)
    for layer in tree["fc"]:
        pooled = g.node("Relu", [_dense(g, pooled, layer)])
    out = _head(g, pooled, batch_vec, tree["head"], terms)
    g.save(path, [("input_1", _F32, ["unk__0", "unk__1", vocab])],
           [(out, _F32, ["unk__2", terms, 2])])


def goterms(n: int) -> list:
    return [f"GO:{i:07d}" for i in range(n)]


def write_folder(directory: Path, config: dict, trees: dict) -> Path:
    """The weights folder: a GCN and a CNN a mode (one term list shared by
    both, so each mode writes one prediction matrix), their
    ``_model_params.json`` and ``model_config.json`` (version 1.1)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    names = {"gcn": {}, "cnn": {}}
    gc = "-".join(map(str, config["gc_dims"]))
    fc = "-".join(map(str, config["fc_dims"]))
    for mode, terms in config["modes"].items():
        for net, write in (("gcn", write_gcn), ("cnn", write_cnn)):
            if mode not in trees.get(net, {}):
                continue
            name = (f"DeepFRI-MERGED_GraphConv_gcd_{gc}_fcd_{fc}_ca_"
                    f"{float(config['contact_threshold'])}_{mode}.onnx"
                    if net == "gcn" else f"DeepCNN-MERGED_{mode}.onnx")
            write(directory / name, trees[net][mode], terms, config["vocab"])
            terms_list = goterms(terms)
            (directory / (name[:-5] + "_model_params.json")).write_text(
                json.dumps({"goterms": terms_list,
                            "gonames": [f"term {t}" for t in terms_list]}))
            names[net][mode] = name
    (directory / "model_config.json").write_text(
        json.dumps({**names, "version": "1.1"}))
    return directory
