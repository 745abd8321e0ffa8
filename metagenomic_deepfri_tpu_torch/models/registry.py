"""Model registry of the port: ONNX weights or checkpoints → model handles.

``metagenomic_deepfri_tpu/models/registry.py`` copied without jax:
architecture inference from an ONNX graph (:func:`infer_gcn_config`,
:func:`detect_adj_norm`, :func:`infer_cnn_config`),
:func:`load_model_handle` for GCNs and CNNs, :func:`load_models` for a whole
weights folder, and the native checkpoint format (``.npz`` plus a
``_config.json`` sidecar), whose files are interchangeable with the JAX
package's. Parameter trees come back as numpy; the engine and the trainer
place them on their device.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from metagenomic_deepfri_tpu_torch.batching.engine import ModelHandle
from metagenomic_deepfri_tpu_torch.models.deepfri import (TRUNKS,
                                                          CNNConfig,
                                                          GCNConfig)
from metagenomic_deepfri_tpu_torch.models.onnx_import import (
    _topo_matmul_weights, collect_lstm_layers, detect_embedding_merge,
    detect_gcn_pool, graph_input_roles, import_cnn_params, import_gcn_params,
    normalize_graph)
from metagenomic_deepfri_tpu_torch.models.onnx_reader import (OnnxGraph,
                                                              load_onnx)
from metagenomic_deepfri_tpu_torch.utils import (get_json_values,
                                                 load_deepfri_config)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Architecture inference from an ONNX graph
# ---------------------------------------------------------------------------

def _matmul_weight_shapes(graph: OnnxGraph) -> List[Tuple[int, int]]:
    # Shapes come through the same collection the importer uses, so Gemm
    # transA/transB orientation is applied identically in both places.
    return [tuple(w.shape) for _node, w, _b, _bn in
            _topo_matmul_weights(graph)]


def _search_fc(pool: list, cur: int, head_width: int, fc=()):
    """The FC widths that consume ``pool`` exactly as a chain from width
    ``cur`` ending in the (·, head_width) head, or None; backtracks over
    the consumption order."""
    if len(pool) == 1 and pool[0] == (cur, head_width):
        return list(fc)
    for s in list(dict.fromkeys(pool)):
        if s[0] == cur:
            rest = list(pool)
            rest.remove(s)
            r = _search_fc(rest, s[1], head_width, (*fc, s[1]))
            if r is not None:
                return r
    return None


def infer_gcn_config(graph: OnnxGraph, n_labels: int,
                     vocab: int = 26) -> GCNConfig:
    """Derive GCNConfig hyperparameters from graph structure.

    LM depth/width come from the LSTM nodes; embed_dim from the (vocab, E)
    residue-embedding weight; the GraphConv chain is followed shape-by-shape
    from E; fc dims from the concat width; the head is pinned by
    2·n_labels.
    """
    lstm_layers = collect_lstm_layers(graph)
    if not lstm_layers:
        raise ValueError("No LSTM nodes found — not a DeepFRI GCN graph?")
    merge = detect_embedding_merge(graph, vocab=vocab)
    if merge is not None and merge != "add":
        raise ValueError(
            f"The LM and residue-embedding branches merge via "
            f"{merge.capitalize()!r}; only the additive merge of the "
            f"published DeepFRI architecture is supported. A "
            f"concatenation-merged variant needs a wider GraphConv input "
            f"and a new config field — refusing to guess.")
    _W0, R0, _B0 = lstm_layers[0]
    hidden = R0.shape[-1]
    num_dir = R0.shape[0]
    lm_out = hidden * num_dir
    shapes = _matmul_weight_shapes(graph)

    embed_candidates = [s for s in shapes if s[0] == vocab]
    if not embed_candidates:
        raise ValueError("No residue-embedding weight (26, E) found")
    embed_dim = embed_candidates[0][1]

    pool = [s for s in shapes if s[0] != vocab]
    # remove the LM embedding (lm_out, embed_dim) once
    if (lm_out, embed_dim) in pool:
        pool.remove((lm_out, embed_dim))

    # The weight pool must decompose EXACTLY into
    #   gc chain:  embed → g1 → … → gk          (k ≥ 1)
    #   fc chain:  sum(g1..gk) → f1 → … → fm    (m ≥ 0)
    #   head:      (fm or sum(gc), 2·n_labels)
    # Greedy chain-following is ambiguous (a layer's in_dim can match both
    # "next gc" and "fc entry" — e.g. gc=(8,12): after g1 the cursor 8
    # equals sum so far), so do an exhaustive backtracking search; the pool
    # has ≤ ~8 entries.
    # A chain layer's width may legitimately equal 2·n_labels, so no shape
    # is excluded a priori; the terminal condition (exactly the head left)
    # disambiguates, with backtracking over consumption order.
    def search_gc(pool, cur, gc):
        if gc:
            fc = _search_fc(pool, sum(gc), 2 * n_labels)
            if fc is not None:
                return list(gc), fc
        for s in list(dict.fromkeys(pool)):
            if s[0] == cur:
                rest = list(pool)
                rest.remove(s)
                r = search_gc(rest, s[1], gc + [s[1]])
                if r is not None:
                    return r
        return None

    resolved = search_gc(pool, embed_dim, [])
    if resolved is None:
        raise ValueError(
            f"Could not decompose GCN weight shapes {pool} into "
            f"gc/fc/head chains from embed_dim={embed_dim}, "
            f"n_labels={n_labels}")
    gc_dims, fc_dims = resolved
    return GCNConfig(n_labels=n_labels, vocab=vocab, lm_hidden=hidden,
                     lm_layers=len(lstm_layers), embed_dim=embed_dim,
                     lm_bidirectional=num_dir == 2,
                     gc_dims=tuple(gc_dims), fc_dims=tuple(fc_dims),
                     adj_norm=detect_adj_norm(graph),
                     pool=detect_gcn_pool(graph))


def detect_adj_norm(graph: OnnxGraph) -> str:
    """Sniff in-graph adjacency normalisation.

    Our exporter (and the published DeepFRI graphs, whose GraphConv consumes
    the cmap as fed) leave A unnormalised. A graph that normalises in-graph
    computes a degree vector (ReduceSum over the adjacency) and recombines
    it with A. Detection is structural, not name-based (tf2onnx symbolic
    dims carry *different* placeholder names on the two adjacency axes, so
    ``shape[1] == shape[2]`` cannot identify A):

    1. Resolve the adjacency input by role (the rank-3 runtime input that is
       not the one-hot sequence).
    2. Flood downstream from every ``ReduceSum(A)`` through elementwise /
       shape ops, recording what the degree passes through.
    3. If that flow recombines with A (Mul/Div), the graph normalises:
       a Sqrt — or a Pow with a ±0.5 exponent — on the path means symmetric
       (D^-1/2 · A · D^-1/2), otherwise row (D^-1 · A).
    """
    try:
        roles = graph_input_roles(graph)
    except ValueError:
        return "none"
    adj = roles.get("A")
    if adj is None:
        return "none"

    # Adjacency-derived tensors: A plus elementwise functions of it (covers
    # e.g. a graph normalising A + I rather than A directly).
    elementwise = {"Add", "Sub", "Mul", "Div", "Max", "Min", "Cast",
                   "Identity", "Where", "Clip", "Transpose"}
    adj_like = {adj}
    changed = True
    while changed:
        changed = False
        for node in graph.nodes:
            if node.op_type in elementwise \
                    and any(i in adj_like for i in node.inputs) \
                    and not set(node.outputs) <= adj_like:
                adj_like |= set(node.outputs)
                changed = True

    reduces = [n for n in graph.nodes
               if n.op_type == "ReduceSum" and n.inputs
               and n.inputs[0] in adj_like]
    if not reduces:
        return "none"

    # Flood the degree flow forward, tagging each tensor with whether a
    # Sqrt / Pow(±0.5) lies on ITS path — so sqrt(degree) used on a branch
    # that never reaches the recombination cannot fake 'sym' evidence.
    follow = {"Sqrt", "Pow", "Reciprocal", "Div", "Mul", "Max", "Min",
              "Add", "Sub", "Clip", "Cast", "Unsqueeze", "Squeeze",
              "Transpose", "Expand", "Where", "Reshape", "Greater"}
    sym_on_path: dict = {o: False for n in reduces for o in n.outputs if o}
    changed = True
    while changed:
        changed = False
        for node in graph.nodes:
            if node.op_type not in follow:
                continue
            tagged = [i for i in node.inputs if i in sym_on_path]
            if not tagged:
                continue
            out_sym = any(sym_on_path[i] for i in tagged)
            if node.op_type == "Sqrt":
                out_sym = True
            elif node.op_type == "Pow" and len(node.inputs) > 1:
                exp = graph.initializers.get(node.inputs[1])
                if exp is not None and np.allclose(np.abs(exp), 0.5):
                    out_sym = True
            for o in node.outputs:
                if o and sym_on_path.get(o) != (sym_on_path.get(o, False)
                                                or out_sym):
                    sym_on_path[o] = sym_on_path.get(o, False) or out_sym
                    changed = True
                elif o and o not in sym_on_path:
                    sym_on_path[o] = out_sym
                    changed = True

    # Recombination: a Mul/Div mixing an adjacency-derived operand with a
    # degree-flow operand; 'sym' only if sqrt lies on THAT operand's path.
    recombined = False
    for node in graph.nodes:
        if node.op_type not in ("Mul", "Div"):
            continue
        deg_ins = [i for i in node.inputs
                   if i in sym_on_path and i not in adj_like]
        if deg_ins and any(i in adj_like for i in node.inputs):
            recombined = True
            if any(sym_on_path[i] for i in deg_ins):
                return "sym"
    return "row" if recombined else "none"


def infer_cnn_config(graph: OnnxGraph, n_labels: int,
                     vocab: int = 26) -> CNNConfig:
    """Derive CNNConfig hyperparameters from graph structure: kernel widths
    and filter count from the Conv weights (ONNX (out, in, width)), the FC
    chain by following shapes from the pooled width to the 2·n_labels
    head."""
    conv_nodes = [n for n in graph.nodes if n.op_type == "Conv"]
    if not conv_nodes:
        raise ValueError("No Conv nodes found — not a DeepFRI CNN graph?")
    kernels = []
    filters = None
    for node in conv_nodes:
        w = graph.initializers[node.inputs[1]]
        kernels.append(int(w.shape[-1]))
        filters = int(w.shape[0])
    pool = list(_matmul_weight_shapes(graph))
    fc_dims = _search_fc(pool, filters * len(kernels), 2 * n_labels)
    if fc_dims is None:
        raise ValueError(
            f"Could not decompose CNN weight shapes {pool} into fc/head "
            f"chains from {filters * len(kernels)}, n_labels={n_labels}")
    return CNNConfig(n_labels=n_labels, vocab=vocab, conv_filters=filters,
                     conv_kernels=tuple(kernels), fc_dims=tuple(fc_dims))


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

_CONFIG_CLASSES = {"gcn": GCNConfig, "cnn": CNNConfig}


def load_model_handle(net_type: str, mode: str, model_path,
                      params_json) -> ModelHandle:
    """Load one network (ONNX or native checkpoint) into a ModelHandle."""
    if net_type not in _CONFIG_CLASSES:
        raise ValueError(f"net_type must be 'gcn' or 'cnn', got {net_type!r}")
    goterms = get_json_values(params_json, "goterms")
    gonames = get_json_values(params_json, "gonames")
    n_labels = len(goterms)
    model_path = str(model_path)
    if model_path.endswith(".npz"):
        config, params = load_checkpoint(model_path)
        if not isinstance(config, _CONFIG_CLASSES[net_type]):
            raise ValueError(f"{model_path} holds a {type(config).__name__} "
                             f"checkpoint, not a {net_type} one")
    else:
        # Fold exporter noise (Constant nodes, Identity chains, Cast/
        # Transpose-wrapped weights — the tf2onnx opset-15 pattern of the
        # published weights, reference weight_convert/convert_models2onnx.py)
        # before structural inference and weight import.
        graph = normalize_graph(load_onnx(model_path))
        if net_type == "gcn":
            config = infer_gcn_config(graph, n_labels)
            params = import_gcn_params(graph, config)
        else:
            config = infer_cnn_config(graph, n_labels)
            params = import_cnn_params(graph, config)
    return ModelHandle(net_type=net_type, mode=mode, config=config,
                       params=params, goterms=goterms, gonames=gonames)


def load_models(weights_dir,
                modes: List[str]) -> Tuple[Dict[str, ModelHandle],
                                           Dict[str, ModelHandle], dict]:
    """Load every requested mode's GCN and CNN from a weights folder.

    Returns ``(gcn_handles, cnn_handles, models_config)``; a mode the
    folder's ``model_config.json`` does not name for a network is absent
    from that network's handles.
    """
    models_config = load_deepfri_config(weights_dir)
    gcn, cnn = {}, {}
    for mode in modes:
        for net, bag in (("gcn", gcn), ("cnn", cnn)):
            if mode not in models_config[net]:
                continue
            model_path = models_config[net][mode]
            params_json = str(Path(model_path).with_suffix("")) + \
                "_model_params.json"
            logger.info("Loading %s/%s from %s", net, mode, model_path)
            bag[mode] = load_model_handle(net, mode, model_path, params_json)
    return gcn, cnn, models_config


# ---------------------------------------------------------------------------
# Native checkpoint format
# ---------------------------------------------------------------------------

def _flatten(params, prefix=""):
    flat = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(val)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[k]) for k in sorted(keys, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(path, config, params):
    """Save params (+config) as .npz / .json sidecar (a config with a
    transformer trunk, :data:`..deepfri.TRUNKS`, with the trunk's widths
    under its field: ``esm``, ``t5`` or ``esmc``)."""
    flat = _flatten(params)
    np.savez_compressed(path, **flat)
    cfg = dict(asdict(config))
    cfg["__class__"] = type(config).__name__
    with open(str(Path(path).with_suffix("")) + "_config.json", "w",
              encoding="utf-8") as f:
        json.dump(cfg, f, indent=2)


def load_checkpoint(path):
    """(config, numpy parameter tree) from a :func:`save_checkpoint` file."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    params = _unflatten(flat)
    cfg_path = str(Path(path).with_suffix("")) + "_config.json"
    with open(cfg_path, "r", encoding="utf-8") as f:
        cfg = json.load(f)
    classes = {c.__name__: c for c in (GCNConfig, CNNConfig, *TRUNKS)}
    cls = classes[cfg.pop("__class__")]
    for key in ("gc_dims", "fc_dims", "conv_kernels"):
        if key in cfg:
            cfg[key] = tuple(cfg[key])
    trunk = TRUNKS.get(cls)
    if trunk is not None and trunk.field in cfg:
        cfg[trunk.field] = trunk.widths(**cfg[trunk.field])
    return cls(**cfg), params
