"""tf2onnx-style DeepFRI graph writers.

A copy, without jax, of ``metagenomic_deepfri_tpu/models/tf2onnx_fixture.py``
(byte-identical output). The published DeepFRI weights are tf2onnx opset-15
exports of TF2 Keras models (reference
``weight_convert/convert_models2onnx.py:41-45``); these writers re-create
that exporter's graph pattern around any parameter tree, so the import path
(``normalize_graph`` → ``infer_*_config`` → ``import_*_params``) and the
:class:`.onnx_import.OnnxExecutor` oracle meet realistic topology on a
machine without JAX:

* runtime inputs named after Keras layers (``input_1``/``input_2``) with
  ``unk__N`` symbolic dims — *different* names on the two adjacency axes,
* ``Identity`` chains after inputs and around weights,
* weights carried as ``Constant`` nodes and ``Cast``/``Transpose``-wrapped
  initializers,
* LSTM nodes in the full 7-input form: ``sequence_lens`` computed by a
  Shape→Gather→Unsqueeze→Expand→Cast chain and ``initial_h``/``initial_c``
  built with Concat→ConstantOfShape,
* optionally the two-unidirectional-LSTM and the ReverseSequence forms of
  Keras ``Bidirectional``,
* dense layers as ``Gemm(transB=1)`` with ``(out, in)``-stored kernels,
* dynamic ``Reshape`` targets assembled from Shape/Gather/Unsqueeze/Concat,
* optionally an in-graph adjacency-normalisation subgraph (``sym``/``row``),
* CNN Conv1D branches as NCW ``Conv`` with explicit SAME pads, and the
  global max-pool as a ``ReduceMax`` over the length axis.
"""

from __future__ import annotations

import numpy as np

from metagenomic_deepfri_tpu_torch.models.deepfri import CNNConfig, GCNConfig
from metagenomic_deepfri_tpu_torch.models.onnx_import import \
    lstm_params_to_onnx
from metagenomic_deepfri_tpu_torch.models.onnx_reader import (OnnxNode,
                                                              save_onnx)

_F32 = 1
_INT32 = 6


def _lstm_wrb(layer: dict):
    """Our LSTM layer params → ONNX (W, R, B), stacking bidirectional."""
    if "fwd" in layer:
        Wf, Rf, Bf = lstm_params_to_onnx(layer["fwd"])
        Wb, Rb, Bb = lstm_params_to_onnx(layer["bwd"])
        return (np.concatenate([Wf, Wb], axis=0),
                np.concatenate([Rf, Rb], axis=0),
                np.concatenate([Bf, Bb], axis=0))
    return lstm_params_to_onnx(layer)


class _GraphBuilder:
    def __init__(self):
        self.nodes: list[OnnxNode] = []
        self.init: dict[str, np.ndarray] = {}
        self._n = 0

    def node(self, op, inputs, n_out=1, name=None, **attrs):
        outs = [f"{op.lower()}_{self._n}_{k}" for k in range(n_out)]
        self._n += 1
        self.nodes.append(OnnxNode(op, list(inputs), outs,
                                   name or outs[0], attrs))
        return outs[0] if n_out == 1 else outs

    def const_node(self, value):
        """A weight carried as a Constant node (tf2onnx noise form)."""
        return self.node("Constant", [], value=np.asarray(value))

    def ini(self, value, dtype=None):
        name = f"const_{self._n}"
        self._n += 1
        arr = np.asarray(value)
        if dtype is not None:
            arr = arr.astype(dtype)
        self.init[name] = arr
        return name

    def identity_weight(self, value):
        """Initializer reached through an Identity node."""
        return self.node("Identity", [self.ini(value)])

    def cast_weight(self, value):
        """float64 initializer Cast down to f32 (tf2onnx noise form)."""
        return self.node("Cast", [self.ini(value, np.float64)], to=_F32)


def _seq_lens_chain(g: _GraphBuilder, x_time_major: str):
    """sequence_lens (batch,) int32 computed from the LSTM input's Shape."""
    shp = g.node("Shape", [x_time_major])
    len_scalar = g.node("Gather", [shp, g.ini(np.asarray(0, np.int64))],
                        axis=0)
    len_vec = g.node("Unsqueeze", [len_scalar, g.ini([0], np.int64)])
    batch_scalar = g.node("Gather", [shp, g.ini(np.asarray(1, np.int64))],
                          axis=0)
    batch_vec = g.node("Unsqueeze", [batch_scalar, g.ini([0], np.int64)])
    lens64 = g.node("Expand", [len_vec, batch_vec])
    lens = g.node("Cast", [lens64], to=_INT32)
    return lens, len_vec, batch_vec


def _initial_state(g: _GraphBuilder, batch_vec: str, num_dir: int,
                   hidden: int):
    shape3 = g.node("Concat",
                    [g.ini([num_dir], np.int64), batch_vec,
                     g.ini([hidden], np.int64)], axis=0)
    h0 = g.node("ConstantOfShape", [shape3],
                value=np.zeros(1, np.float32))
    c0 = g.node("Identity", [h0])
    return h0, c0


def _gemm_dense(g: _GraphBuilder, x: str, kernel, bias) -> str:
    """Keras Dense the tf2onnx way: Gemm with (out, in) kernel, transB=1."""
    wt = g.ini(np.asarray(kernel, np.float32).T)
    b = g.ini(np.asarray(bias, np.float32))
    return g.node("Gemm", [x, wt, b], transB=1)


def _dynamic_head(g: _GraphBuilder, x: str, batch_vec: str, n_labels: int):
    """Reshape (B, 2n) → (B, n, 2) with a Shape-derived target + Softmax."""
    target = g.node("Concat",
                    [batch_vec, g.ini([n_labels], np.int64),
                     g.ini([2], np.int64)], axis=0)
    reshaped = g.node("Reshape", [x, target])
    return g.node("Softmax", [reshaped], axis=-1)


def export_gcn_tf2onnx_style(params: dict, config: GCNConfig, path: str, *,
                             bidir_as_pair: bool = False,
                             bidir_as_revseq: bool = False,
                             adj_norm: str = "none",
                             embed_merge: str = "add",
                             weights_as_inputs: bool = False) -> None:
    """Write a GCN graph in the tf2onnx export pattern (see module doc).

    ``adj_norm`` embeds an in-graph adjacency-normalisation subgraph; the
    caller's ``config.adj_norm`` should be ``'none'`` (the normalisation
    lives in the graph, and import is expected to *detect* it).
    ``bidir_as_revseq`` writes Keras Bidirectional as two *forward* LSTMs
    with the backward branch wrapped in ReverseSequence on input and output
    (the exporter's third Bidirectional lowering). ``embed_merge='concat'``
    produces the unsupported concatenation-merge variant — the importer must
    reject it loudly. ``weights_as_inputs`` additionally lists a handful of
    weight initializers in ``graph.input`` (keras2onnx-lineage exports do
    this; ONNX permits it, and an importer that maps every graph input to a
    runtime input mis-infers the model — ours must filter them like
    onnxruntime's ``session.get_inputs()`` does). GraphConv / LM-embedding biases are emitted whenever
    the parameter tree carries them. ``config.pool='mean'`` pools the
    GraphConv concat with ReduceMean instead of ReduceSum.
    """
    g = _GraphBuilder()
    hidden = config.lm_hidden
    num_dir = 2 if config.lm_bidirectional else 1

    adj = g.node("Identity", ["input_1"])
    seq = g.node("Identity", ["input_2"])

    # --- LM branch: stacked LSTM layers, time-major between layers --------
    x_tm = g.node("Transpose", [seq], perm=[1, 0, 2])
    seq_lens, len_vec, batch_vec = _seq_lens_chain(g, x_tm)
    lm_out = None
    for li, layer in enumerate(params["lm"]):
        if li > 0:
            x_tm = g.node("Transpose", [lm_out], perm=[1, 0, 2])
        W, R, B = _lstm_wrb(layer)
        if bidir_as_revseq and num_dir == 2:
            # Backward branch lowered as forward LSTM over ReverseSequence'd
            # input with its output re-reversed.
            h0, c0 = _initial_state(g, batch_vec, 1, hidden)
            y_f, _yh, _yc = g.node(
                "LSTM", [x_tm, g.ini(W[0:1]), g.ini(R[0:1]), g.ini(B[0:1]),
                         seq_lens, h0, c0],
                n_out=3, hidden_size=hidden, direction=b"forward")
            part_f = g.node("Squeeze", [y_f, g.ini([1], np.int64)])
            x_rev = g.node("ReverseSequence", [x_tm, seq_lens],
                           time_axis=0, batch_axis=1)
            y_b, _yh2, _yc2 = g.node(
                "LSTM", [x_rev, g.ini(W[1:2]), g.ini(R[1:2]), g.ini(B[1:2]),
                         seq_lens, h0, c0],
                n_out=3, hidden_size=hidden, direction=b"forward")
            sq_b = g.node("Squeeze", [y_b, g.ini([1], np.int64)])
            part_b = g.node("ReverseSequence", [sq_b, seq_lens],
                            time_axis=0, batch_axis=1)
            merged = g.node("Concat", [part_f, part_b], axis=-1)
            lm_out = g.node("Transpose", [merged], perm=[1, 0, 2])
        elif bidir_as_pair and num_dir == 2:
            h0, c0 = _initial_state(g, batch_vec, 1, hidden)
            parts = []
            for d, direction in enumerate(("forward", "reverse")):
                if li == 0 and d == 0:
                    w_in = g.const_node(W[d:d + 1])
                    r_in = g.identity_weight(R[d:d + 1])
                else:
                    w_in = g.ini(W[d:d + 1])
                    r_in = g.ini(R[d:d + 1])
                y, _yh, _yc = g.node(
                    "LSTM", [x_tm, w_in, r_in, g.ini(B[d:d + 1]),
                             seq_lens, h0, c0],
                    n_out=3, hidden_size=hidden,
                    direction=direction.encode())
                parts.append(g.node("Squeeze", [y, g.ini([1], np.int64)]))
            merged = g.node("Concat", parts, axis=-1)
            lm_out = g.node("Transpose", [merged], perm=[1, 0, 2])
        else:
            if li == 0:
                w_in = g.const_node(W)
                r_in = g.identity_weight(R)
                b_in = g.ini(B)
            else:
                w_in = g.ini(W)
                r_in = g.cast_weight(R)
                b_in = g.ini(B)
            h0, c0 = _initial_state(g, batch_vec, num_dir, hidden)
            y, _yh, _yc = g.node(
                "LSTM", [x_tm, w_in, r_in, b_in, seq_lens, h0, c0],
                n_out=3, hidden_size=hidden,
                direction=(b"bidirectional" if num_dir == 2 else b"forward"))
            yt = g.node("Transpose", [y], perm=[2, 0, 1, 3])
            target = g.node("Concat",
                            [batch_vec, len_vec,
                             g.ini([num_dir * hidden], np.int64)], axis=0)
            lm_out = g.node("Reshape", [yt, target])

    # LM embedding: kernel stored transposed behind a Transpose node.
    lm_k = np.asarray(params["lm_embed"]["kernel"], np.float32)
    lm_k_node = g.node("Transpose", [g.ini(lm_k.T)], perm=[1, 0])
    x_lm = g.node("MatMul", [lm_out, lm_k_node])
    if "bias" in params["lm_embed"]:
        x_lm = g.node("Add", [x_lm,
                              g.ini(np.asarray(params["lm_embed"]["bias"],
                                               np.float32))])
    # Residue embedding: kernel as a Constant node.
    aa_k = g.const_node(np.asarray(params["aa_embed"]["kernel"], np.float32))
    x_aa = g.node("Add", [g.node("MatMul", [seq, aa_k]),
                          g.ini(np.asarray(params["aa_embed"]["bias"],
                                           np.float32))])
    if embed_merge == "concat":
        h = g.node("Relu", [g.node("Concat", [x_lm, x_aa], axis=-1)])
    else:
        h = g.node("Relu", [g.node("Add", [x_lm, x_aa])])

    # --- adjacency (optionally normalised in-graph) ------------------------
    if adj_norm == "sym":
        deg = g.node("ReduceSum", [adj, g.ini([2], np.int64)], keepdims=1)
        s = g.node("Sqrt", [deg])
        a1 = g.node("Div", [adj, s])
        st = g.node("Transpose", [s], perm=[0, 2, 1])
        a_used = g.node("Div", [a1, st])
    elif adj_norm == "row":
        deg = g.node("ReduceSum", [adj, g.ini([2], np.int64)], keepdims=1)
        a_used = g.node("Div", [adj, deg])
    else:
        a_used = adj

    # --- GraphConv stack ----------------------------------------------------
    concat_in = []
    for gi, layer in enumerate(params["gc"]):
        agg = g.node("MatMul", [a_used, h])
        k = np.asarray(layer["kernel"], np.float32)
        k_in = g.identity_weight(k) if gi == 0 else g.ini(k)
        lin = g.node("MatMul", [agg, k_in])
        if "bias" in layer:
            lin = g.node("Add", [lin, g.ini(np.asarray(layer["bias"],
                                                       np.float32))])
        h = g.node("Relu", [lin])
        concat_in.append(h)
    cat = g.node("Concat", concat_in, axis=-1)
    pool_op = "ReduceMean" if config.pool == "mean" else "ReduceSum"
    pooled = g.node(pool_op, [cat, g.ini([1], np.int64)], keepdims=0)

    # --- FC + head (Gemm transB=1, Keras Dense style) -----------------------
    for layer in params["fc"]:
        pooled = g.node("Relu", [_gemm_dense(g, pooled, layer["kernel"],
                                             layer["bias"])])
    logits = _gemm_dense(g, pooled, params["head"]["kernel"],
                         params["head"]["bias"])
    out = _dynamic_head(g, logits, batch_vec, config.n_labels)

    inputs = [("input_1", _F32, ["unk__0", "unk__1", "unk__2"]),
              ("input_2", _F32, ["unk__3", "unk__4", config.vocab])]
    if weights_as_inputs:
        # initializers shadowed into graph.input (keras2onnx-lineage form)
        dt = {np.dtype(np.float32): _F32, np.dtype(np.int64): 7,
              np.dtype(np.int32): _INT32, np.dtype(np.float64): 11}
        for name in list(g.init)[:4]:
            arr = g.init[name]
            inputs.append((name, dt[arr.dtype], list(arr.shape)))
    save_onnx(path, g.nodes, g.init,
              inputs=inputs,
              outputs=[(out, _F32, ["unk__5", config.n_labels, 2])],
              graph_name="model")


def export_cnn_tf2onnx_style(params: dict, config: CNNConfig,
                             path: str) -> None:
    """Write a CNN graph in the tf2onnx export pattern.

    Keras Conv1D becomes NCW Conv with explicit SAME pads and Transpose
    pairs; GlobalMaxPooling1D becomes a ReduceMax over the length axis in
    NWC layout.
    """
    g = _GraphBuilder()
    seq = g.node("Identity", ["input_1"])
    shp = g.node("Shape", [seq])
    batch_scalar = g.node("Gather", [shp, g.ini(np.asarray(0, np.int64))],
                          axis=0)
    batch_vec = g.node("Unsqueeze", [batch_scalar, g.ini([0], np.int64)])

    s_ncw = g.node("Transpose", [seq], perm=[0, 2, 1])
    branches = []
    for ci, conv in enumerate(params["conv"]):
        w = np.transpose(np.asarray(conv["kernel"], np.float32), (2, 1, 0))
        ksize = w.shape[-1]
        w_in = g.const_node(w) if ci == 0 else g.ini(w)
        y = g.node("Conv", [s_ncw, w_in,
                            g.ini(np.asarray(conv["bias"], np.float32))],
                   pads=[(ksize - 1) // 2, ksize - 1 - (ksize - 1) // 2],
                   strides=[1])
        branches.append(g.node("Transpose", [y], perm=[0, 2, 1]))
    cat = g.node("Concat", branches, axis=-1)
    act = g.node("Relu", [cat])
    pooled = g.node("ReduceMax", [act, g.ini([1], np.int64)], keepdims=0)

    for layer in params["fc"]:
        pooled = g.node("Relu", [_gemm_dense(g, pooled, layer["kernel"],
                                             layer["bias"])])
    logits = _gemm_dense(g, pooled, params["head"]["kernel"],
                         params["head"]["bias"])
    out = _dynamic_head(g, logits, batch_vec, config.n_labels)

    save_onnx(path, g.nodes, g.init,
              inputs=[("input_1", _F32, ["unk__0", "unk__1", config.vocab])],
              outputs=[(out, _F32, ["unk__2", config.n_labels, 2])],
              graph_name="model")
