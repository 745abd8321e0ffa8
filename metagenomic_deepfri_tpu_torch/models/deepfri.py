"""DeepFRI GCN and CNN in PyTorch.

Counterpart of ``metagenomic_deepfri_tpu/models/deepfri.py``. Parameters are
plain trees of tensors with the JAX package's structure and layouts (dense
kernels stored (in, out) for ``x @ kernel``; conv kernels (width, in, out)),
so a JAX tree converts with :mod:`..models.convert` and no transposes.
:class:`DeepFRIGCN` and :class:`DeepFRICNN` hold such trees as
modules.

GCN:   one-hot(26) ─┬─ LSTM-LM stack ── Dense(no bias) ──┐
                    └─ Dense(bias) ──────────────────────┴─ add → ReLU
       (an ESMGCNConfig runs ESM-2 on the tokens (:mod:`.esm2`) in the
       LSTM-LM's place)
       → 3 × GraphConv(512, ReLU):  Hₗ₊₁ = relu(Â · Hₗ · Wₗ)
       → concat(H₁‖H₂‖H₃) → masked sum-pool over L
       → Dense(1024, ReLU) → Dense(2·n_labels) → reshape (n_labels, 2)
       → softmax(last) → score = [..., 0]

CNN:   one-hot(26) → parallel Conv1D branches ('SAME', one per width)
       → concat → ReLU → masked global max-pool → Dense stack
       → the same two-way-softmax head.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metagenomic_deepfri_tpu_torch.models.esm2 import (ESM2Config,
                                                       esm2_forward,
                                                       init_esm2,
                                                       trunk_counts)
from metagenomic_deepfri_tpu_torch.models.lstm import (accumulate_dtype,
                                                       init_lstm_stack,
                                                       lstm_stack_forward)
from metagenomic_deepfri_tpu_torch.ops.graphconv import normalized_aggregate
from metagenomic_deepfri_tpu_torch.ops.one_hot import (VOCAB_SIZE,
                                                       seq2tokens,
                                                       tokens2onehot)
from metagenomic_deepfri_tpu_torch.profiling import (count, device_span,
                                                      recording)

# float64 is not a serving dtype: it is the reference precision that float32
# training is checked against (dense path only; the kernels are float32).
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclass(frozen=True)
class GCNConfig:
    n_labels: int
    vocab: int = VOCAB_SIZE
    lm_hidden: int = 512
    lm_layers: int = 2
    lm_bidirectional: bool = False
    embed_dim: int = 1024
    gc_dims: Tuple[int, ...] = (512, 512, 512)
    fc_dims: Tuple[int, ...] = (1024,)
    adj_norm: str = "sym"          # 'sym' | 'row' | 'none'
    pool: str = "sum"              # 'sum' | 'mean' over the length axis
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' | 'float64'


@dataclass(frozen=True)
class ESMGCNConfig(GCNConfig):
    """A GCN whose residue LM is ESM-2 (:mod:`.esm2`, widths ``esm``) in
    the LSTM-LM's place; the ``lm_*`` fields are not read. (A subclass, so
    that :class:`GCNConfig` keeps the JAX package's fields.)"""
    esm: ESM2Config = ESM2Config()


def esm_of(config) -> Optional[ESM2Config]:
    """The ESM-2 trunk's widths of a GCN config, None for an LSTM-LM."""
    return getattr(config, "esm", None)


@dataclass(frozen=True)
class CNNConfig:
    n_labels: int
    vocab: int = VOCAB_SIZE
    conv_filters: int = 512
    conv_kernels: Tuple[int, ...] = (8, 16)
    fc_dims: Tuple[int, ...] = (1024,)
    # Kept for the config contract; the CNN computes in float32 whatever it
    # names, as the JAX package's does.
    compute_dtype: str = "float32"


def compute_dtype_of(config) -> torch.dtype:
    """The torch dtype named by ``config.compute_dtype``."""
    try:
        return _DTYPES[config.compute_dtype]
    except KeyError:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_DTYPES)}, got "
            f"{config.compute_dtype!r}") from None


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def _dense_init(in_dim: int, out_dim: int, generator: torch.Generator,
                device, bias: bool = True) -> dict:
    scale = math.sqrt(6.0 / (in_dim + out_dim))
    u = torch.rand((in_dim, out_dim), generator=generator,
                   dtype=torch.float32, device=generator.device)
    p = {"kernel": ((u * 2.0 - 1.0) * scale).to(device)}
    if bias:
        p["bias"] = torch.zeros(out_dim, dtype=torch.float32, device=device)
    return p


def init_gcn(config: GCNConfig, generator: torch.Generator, device, *,
             gc_bias: bool = False, lm_embed_bias: bool = False) -> dict:
    """Random GCN parameter tree (same structure and shapes as the JAX
    ``init_gcn``; different numbers, since the generators differ). With an
    ESM-2 trunk, ``lm`` is :func:`.esm2.init_esm2`'s tree."""
    if esm_of(config) is not None:
        lm_out = config.esm.dim
        lm = init_esm2(config.esm, generator, device)
    else:
        lm_out = config.lm_hidden * (2 if config.lm_bidirectional else 1)
        lm = init_lstm_stack(config.vocab, config.lm_hidden,
                             config.lm_layers, generator, device,
                             bidirectional=config.lm_bidirectional)
    params = {
        "lm": lm,
        "lm_embed": _dense_init(lm_out, config.embed_dim, generator, device,
                                bias=lm_embed_bias),
        "aa_embed": _dense_init(config.vocab, config.embed_dim, generator,
                                device, bias=True),
        "gc": [],
        "fc": [],
    }
    in_dim = config.embed_dim
    for d in config.gc_dims:
        params["gc"].append(_dense_init(in_dim, d, generator, device,
                                        bias=gc_bias))
        in_dim = d
    in_dim = sum(config.gc_dims)
    for d in config.fc_dims:
        params["fc"].append(_dense_init(in_dim, d, generator, device))
        in_dim = d
    params["head"] = _dense_init(in_dim, 2 * config.n_labels, generator,
                                 device)
    return params


def init_cnn(config: CNNConfig, generator: torch.Generator, device) -> dict:
    """Random CNN parameter tree (same structure and shapes as the JAX
    ``init_cnn``: conv kernels (width, vocab, filters), zero biases)."""
    params = {"conv": [], "fc": []}
    for ksize in config.conv_kernels:
        scale = math.sqrt(6.0 / (ksize * config.vocab + config.conv_filters))
        u = torch.rand((ksize, config.vocab, config.conv_filters),
                       generator=generator, dtype=torch.float32,
                       device=generator.device)
        params["conv"].append({
            "kernel": ((u * 2.0 - 1.0) * scale).to(device),
            "bias": torch.zeros(config.conv_filters, dtype=torch.float32,
                                device=device)})
    in_dim = config.conv_filters * len(config.conv_kernels)
    for d in config.fc_dims:
        params["fc"].append(_dense_init(in_dim, d, generator, device))
        in_dim = d
    params["head"] = _dense_init(in_dim, 2 * config.n_labels, generator,
                                 device)
    return params


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def normalize_adjacency(adj: torch.Tensor, mode: str = "sym") -> torch.Tensor:
    """Degree-normalise a (B, L, L) adjacency; safe on zero (padded) rows."""
    if mode == "none":
        return adj
    deg = adj.sum(dim=-1)
    zero = torch.zeros_like(deg)
    if mode == "sym":
        inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                               zero)
        return adj * inv_sqrt[:, :, None] * inv_sqrt[:, None, :]
    if mode == "row":
        inv = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-12), zero)
        return adj * inv[:, :, None]
    raise ValueError(f"Unknown adjacency normalisation: {mode}")


def _logits(head: dict, x: torch.Tensor, n_labels: int) -> torch.Tensor:
    """Head logits, (…, n_labels, 2)."""
    logits = _dense(head, x)
    return logits.reshape(*logits.shape[:-1], n_labels, 2)


def _head_scores(head_params: dict, x: torch.Tensor,
                 n_labels: int) -> torch.Tensor:
    """Per-term 2-way softmax; score = class-0 probability."""
    return torch.softmax(_logits(head_params, x, n_labels), dim=-1)[..., 0]


def graphconv_apply(layer: dict, agg: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """relu(agg · W [+ b]) — one GraphConv layer after the Â·H aggregation."""
    h = agg @ layer["kernel"].to(dtype)
    if "bias" in layer:
        h = h + layer["bias"].to(dtype)
    return torch.relu(h)


def _pool_over_length(concat: torch.Tensor, valid: torch.Tensor,
                      lengths: torch.Tensor, mode: str) -> torch.Tensor:
    """Masked sum- or mean-pool of (B, L, C) over L."""
    pooled = (concat * valid[:, :, None]).sum(dim=1)
    if mode == "mean":
        denom = lengths.clamp_min(1).to(pooled.dtype)
        pooled = pooled / denom[:, None]
    elif mode != "sum":
        raise ValueError(f"Unknown pooling mode: {mode}")
    return pooled


def _masked_onehot(tokens: torch.Tensor, lengths: torch.Tensor,
                   dtype: torch.dtype):
    """(one-hot zeroed past each length, (B, L) 1/0 valid mask), both in
    ``dtype``."""
    L = tokens.shape[1]
    valid = (torch.arange(L, dtype=torch.int32, device=tokens.device)[None, :]
             < lengths.to(torch.int32)[:, None]).to(dtype)
    return tokens2onehot(tokens, dtype) * valid[:, :, None], valid


def _merge_embeddings(lm_embed: dict, aa_embed: dict, lm_out: torch.Tensor,
                      onehot: torch.Tensor, dtype: torch.dtype):
    """relu(LM embedding + residue embedding), rounded to ``dtype``."""
    return torch.relu(_dense(lm_embed, lm_out)
                      + _dense(aa_embed, onehot)).to(dtype)


def _lm_forward(lm: object, config: GCNConfig, tokens: torch.Tensor,
               onehot: torch.Tensor, lengths: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The residue LM's (B, L, ·) output: the LSTM-LM stack on the one-hot,
    or ESM-2 on the tokens (in float32, float64 for float64 compute), whose
    batch counters ``tokens``, ``slots`` and ``attn_pairs``
    (:func:`.esm2.trunk_counts`) go to the enclosing span while spans are
    recorded."""
    if esm_of(config) is None:
        return lstm_stack_forward(lm, onehot, lengths, compute_dtype=dtype)
    if recording():
        count(**trunk_counts(lengths, tokens.shape[1]))
    return esm2_forward(lm, config.esm, tokens, lengths,
                        accumulate_dtype(dtype))


def _embed(params: dict, config: GCNConfig, tokens: torch.Tensor,
           lengths: torch.Tensor):
    """One-hot → residue LM + residue embedding → (x in compute dtype,
    valid), under the device span ``model/lm``."""
    dtype = compute_dtype_of(config)
    with device_span("model/lm", tokens.device):
        onehot, valid = _masked_onehot(tokens, lengths,
                                       accumulate_dtype(dtype))
        lm_out = _lm_forward(params["lm"], config, tokens, onehot, lengths,
                             dtype)
        x = _merge_embeddings(params["lm_embed"], params["aa_embed"], lm_out,
                              onehot, dtype)
    return x, valid


def _fc_stack(layers: list, pooled: torch.Tensor,
              stages: dict | None = None) -> torch.Tensor:
    """relu(Dense) per FC layer; records ``fc0..fcM`` in ``stages``."""
    for fi, layer in enumerate(layers):
        pooled = torch.relu(_dense(layer, pooled))
        if stages is not None:
            stages[f"fc{fi}"] = pooled
    return pooled


def _pooled_fc(params: dict, config: GCNConfig, gc_outputs: list,
               valid: torch.Tensor, lengths: torch.Tensor,
               stages: dict | None = None) -> torch.Tensor:
    """concat → masked pool → FC stack → (B, fc_dims[-1]) head features."""
    concat = torch.cat(gc_outputs, dim=-1).to(valid.dtype)
    # Padded rows are zero unless a GraphConv bias shifted them, so pooling
    # always re-masks to valid positions.
    pooled = _pool_over_length(concat, valid, lengths, config.pool)
    if stages is not None:
        stages["pooled"] = pooled
    return _fc_stack(params["fc"], pooled, stages)


def _graphconv_stack(layers: list, adj: torch.Tensor, x: torch.Tensor,
                     dtype: torch.dtype, stages: dict | None = None) -> list:
    """The dense GraphConv stack on a normalised adjacency; every layer's
    output (``gc0..gcN`` in ``stages``)."""
    acc = accumulate_dtype(dtype)
    gc_outputs = []
    for gi, layer in enumerate(layers):
        # adj and x are already rounded to the compute dtype; their bmm in
        # float32 (float64 for float64 compute) is the reference's
        # preferred_element_type=float32 product.
        agg = torch.bmm(adj.to(acc), x.to(acc))
        x = graphconv_apply(layer, agg.to(dtype), dtype)
        gc_outputs.append(x)
        if stages is not None:
            stages[f"gc{gi}"] = x
    return gc_outputs


def _gcn_trunk(params: dict, config: GCNConfig, tokens: torch.Tensor,
               adjacency: torch.Tensor, lengths: torch.Tensor, finish,
               stages: dict | None = None):
    """Dense-adjacency trunk: one-hot → LM branch → GraphConv stack → pooled
    FC features (B, fc_dims[-1]) → ``finish(features)``, shared by
    :func:`gcn_forward`, :func:`gcn_forward_logits` and
    :func:`gcn_forward_stages`, under the device spans ``model/lm``,
    ``model/graph`` (normalisation and GraphConv stack) and ``model/head``
    (pool, FC stack, ``finish``). ``stages`` (if given) collects the named
    intermediates."""
    dtype = compute_dtype_of(config)
    x, valid = _embed(params, config, tokens, lengths)
    if stages is not None:
        stages["embed"] = x
    with device_span("model/graph", tokens.device):
        adj = normalize_adjacency(adjacency.to(accumulate_dtype(dtype)),
                                  config.adj_norm).to(dtype)
        gc_outputs = _graphconv_stack(params["gc"], adj, x, dtype, stages)
    with device_span("model/head", tokens.device):
        return finish(_pooled_fc(params, config, gc_outputs, valid, lengths,
                                 stages))


def gcn_forward(params: dict, config: GCNConfig, tokens: torch.Tensor,
                adjacency: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Batched GCN forward on a dense adjacency (the plain reference path).

    Args:
        tokens: (B, L) uint8 token ids (padded with PAD_TOKEN).
        adjacency: (B, L, L) float 0/1 contact maps, padded rows/cols zeroed,
            identity on the valid diagonal.
        lengths: (B,) int32 true lengths.

    Returns:
        (B, n_labels) float32 per-term scores in [0, 1] (float64 for float64
        compute).
    """
    return _gcn_trunk(params, config, tokens, adjacency, lengths,
                      lambda pooled: _head_scores(params["head"], pooled,
                                                  config.n_labels))


def gcn_forward_logits(params: dict, config: GCNConfig, tokens: torch.Tensor,
                       adjacency: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Batched GCN forward returning (B, n_labels, 2) pre-softmax logits.

    Training entry point: the fine-tuning loss needs raw logits, not the
    class-0 probabilities of the inference contract.
    """
    return _gcn_trunk(params, config, tokens, adjacency, lengths,
                      lambda pooled: _logits(params["head"], pooled,
                                             config.n_labels))


def _stages_head(params: dict, n_labels: int, pooled: torch.Tensor,
                 stages: dict) -> dict:
    stages["logits"] = _logits(params["head"], pooled, n_labels)
    stages["scores"] = torch.softmax(stages["logits"], dim=-1)[..., 0]
    return stages


def gcn_forward_stages(params: dict, config: GCNConfig, tokens: torch.Tensor,
                       adjacency: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Batched dense GCN forward returning every named stage.

    Keys: ``embed``, ``gc0..gcN``, ``pooled``, ``fc0..fcM``, ``logits``
    ((B, n_labels, 2) pre-softmax), ``scores`` — the names of the JAX
    ``gcn_forward_stages`` and of
    :func:`..onnx_import.gcn_stage_tensors`, so a divergence from the ONNX
    graph can be pinned to its first stage.
    """
    stages: dict = {}
    return _gcn_trunk(params, config, tokens, adjacency, lengths,
                      lambda pooled: _stages_head(params, config.n_labels,
                                                  pooled, stages), stages)


def gcn_forward_multimode(shared: dict, per_mode: dict, configs: dict,
                          tokens: torch.Tensor, adjacency: torch.Tensor,
                          lengths: torch.Tensor) -> dict:
    """Several GCN modes over one batch, computing the shared trunk once.

    The published models share one frozen LSTM-LM across bp/cc/mf (each
    ONNX file carries a copy). When the engine finds the ``lm`` subtrees of
    the loaded modes identical (and ``lm_embed``/``aa_embed`` too, where
    they are), this runs the LM (and the embedding merge) once per batch,
    normalises the dense adjacency once, and repeats only the GraphConv, FC
    and head stacks per mode.

    Args:
        shared: the common subtrees: ``lm``, and ``lm_embed``/``aa_embed``
            when those are shared too.
        per_mode: {mode: the rest of that mode's tree}.
        configs: {mode: GCNConfig}; they agree on everything but
            ``n_labels`` (the engine checks this).

    Returns:
        {mode: (B, n_labels_mode) scores}.
    """
    cfg0 = next(iter(configs.values()))
    dtype = compute_dtype_of(cfg0)
    acc = accumulate_dtype(dtype)
    dev = tokens.device
    with device_span("model/graph", dev):
        adj = normalize_adjacency(adjacency.to(acc), cfg0.adj_norm).to(dtype)

    with device_span("model/lm", dev):
        onehot, valid = _masked_onehot(tokens, lengths, acc)
        lm_shared = (_lm_forward(shared["lm"], cfg0, tokens, onehot,
                                 lengths, dtype)
                     if "lm" in shared else None)
        x_shared = None
        if (lm_shared is not None and "lm_embed" in shared
                and "aa_embed" in shared):
            x_shared = _merge_embeddings(shared["lm_embed"],
                                         shared["aa_embed"], lm_shared,
                                         onehot, dtype)
    out = {}
    for mode, p in per_mode.items():
        cfg = configs[mode]
        x = x_shared
        if x is None:
            with device_span("model/lm", dev):
                lm_out = (lm_shared if lm_shared is not None
                          else _lm_forward(p["lm"], cfg, tokens, onehot,
                                           lengths, dtype))
                x = _merge_embeddings(
                    shared.get("lm_embed", p.get("lm_embed")),
                    shared.get("aa_embed", p.get("aa_embed")), lm_out,
                    onehot, dtype)
        with device_span("model/graph", dev):
            gc_outputs = _graphconv_stack(p["gc"], adj, x, dtype)
        with device_span("model/head", dev):
            pooled = _pooled_fc(p, cfg, gc_outputs, valid, lengths)
            out[mode] = _head_scores(p["head"], pooled, cfg.n_labels)
    return out


def gcn_forward_fused(params: dict, config: GCNConfig, tokens: torch.Tensor,
                      proj_coords: torch.Tensor, ins_mask: torch.Tensor,
                      lengths: torch.Tensor, threshold: float = 6.0,
                      generated_contacts: int = 2) -> torch.Tensor:
    """GCN forward with the fused-adjacency GraphConv kernels.

    Same math as ``gcn_forward(…, aligned_contacts_from_coords(...))``, but
    the (B, L, L) adjacency never exists in device memory: each tile is
    rebuilt from ``proj_coords`` inside the kernels of
    :mod:`..ops.graphconv`. The degree pass runs once and is shared by the
    GraphConv stack. On CPU tensors the kernels' plain twins run instead.
    """
    dtype = compute_dtype_of(config)
    x, valid = _embed(params, config, tokens, lengths)
    degrees = None
    gc_outputs = []
    with device_span("model/graph", tokens.device):
        for layer in params["gc"]:
            agg, degrees = normalized_aggregate(
                proj_coords, ins_mask, lengths, x.to(torch.float32),
                threshold=threshold, generated_contacts=generated_contacts,
                adj_norm=config.adj_norm, degrees=degrees,
                compute_dtype=config.compute_dtype)
            x = graphconv_apply(layer, agg.to(dtype), dtype)
            gc_outputs.append(x)
    with device_span("model/head", tokens.device):
        pooled = _pooled_fc(params, config, gc_outputs, valid, lengths)
        return _head_scores(params["head"], pooled, config.n_labels)


def same_padding(width: int) -> Tuple[int, int]:
    """(low, high) padding of a stride-1 'SAME' convolution, as XLA splits
    it: the odd element of ``width - 1`` goes high (8 → (3, 4))."""
    return (width - 1) // 2, width // 2


def _cnn_trunk(params: dict, config: CNNConfig, tokens: torch.Tensor,
               lengths: torch.Tensor, stages: dict | None = None):
    """Conv branches → masked global max-pool → FC stack.

    Always float32, whatever ``config.compute_dtype`` says (the JAX trunk
    never casts). Zeroing the one-hot past each length makes a padded batch
    equal, on valid positions, to the unpadded single-protein run; the
    max-pool sees valid positions only, and a row with none pools to 0.
    """
    onehot, valid = _masked_onehot(tokens, lengths, torch.float32)
    x = onehot.transpose(1, 2)                       # (B, vocab, L)
    branches = []
    for conv in params["conv"]:
        kernel = conv["kernel"]                      # (width, in, out)
        y = F.conv1d(F.pad(x, same_padding(kernel.shape[0])),
                     kernel.permute(2, 1, 0))        # (B, out, L)
        branches.append(y.transpose(1, 2) + conv["bias"])
    h = torch.relu(torch.cat(branches, dim=-1))
    h = h.masked_fill(valid[:, :, None] == 0, float("-inf"))
    pooled = h.amax(dim=1)
    pooled = torch.where(torch.isfinite(pooled), pooled,
                         torch.zeros_like(pooled))
    if stages is not None:
        stages["pooled"] = pooled
    return _fc_stack(params["fc"], pooled, stages)


def cnn_forward(params: dict, config: CNNConfig, tokens: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Batched sequence-only CNN forward → (B, n_labels) float32 scores."""
    pooled = _cnn_trunk(params, config, tokens, lengths)
    return _head_scores(params["head"], pooled, config.n_labels)


def cnn_forward_logits(params: dict, config: CNNConfig, tokens: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Batched CNN forward returning (B, n_labels, 2) pre-softmax logits."""
    pooled = _cnn_trunk(params, config, tokens, lengths)
    return _logits(params["head"], pooled, config.n_labels)


def cnn_forward_stages(params: dict, config: CNNConfig, tokens: torch.Tensor,
                       lengths: torch.Tensor) -> dict:
    """Named CNN stages (``pooled``, ``fc*``, ``logits``, ``scores``), as
    :func:`gcn_forward_stages`."""
    stages: dict = {}
    pooled = _cnn_trunk(params, config, tokens, lengths, stages)
    return _stages_head(params, config.n_labels, pooled, stages)


# ---------------------------------------------------------------------------
# Single-protein API (reference Predictor.forward_pass)
# ---------------------------------------------------------------------------

def _single_inputs(params: dict, seqres: str, cmap):
    """(tokens (1, L), lengths (1,), adjacency (1, L, L) or None) on the
    device of the parameter tree."""
    leaf = params["head"]["kernel"]
    tokens = torch.from_numpy(seq2tokens(seqres)[None, :]).to(leaf.device)
    lengths = torch.tensor([len(seqres)], dtype=torch.int32,
                           device=leaf.device)
    adj = None
    if cmap is not None:
        adj = torch.from_numpy(
            np.asarray(cmap, np.float32)[None]).to(leaf.device)
    return tokens, lengths, adj


def forward_pass_single(params: dict, config, seqres: str,
                        cmap=None) -> torch.Tensor:
    """One unpadded protein: the GCN when a (L, L) contact map is given,
    the CNN otherwise; returns the flat (n_labels,) score vector.

    Runs where the parameter tensors are. For parity checks and one-off use;
    the batched engine is the production path.
    """
    tokens, lengths, adj = _single_inputs(params, seqres, cmap)
    if adj is not None:
        scores = gcn_forward(params, config, tokens, adj, lengths)
    else:
        scores = cnn_forward(params, config, tokens, lengths)
    return scores.reshape(-1)


def forward_stages_single(params: dict, config, seqres: str,
                          cmap=None) -> dict:
    """The named stages of :func:`gcn_forward_stages` (with ``cmap``) or
    :func:`cnn_forward_stages` (without) for one unpadded protein."""
    tokens, lengths, adj = _single_inputs(params, seqres, cmap)
    if adj is not None:
        return gcn_forward_stages(params, config, tokens, adj, lengths)
    return cnn_forward_stages(params, config, tokens, lengths)


# ---------------------------------------------------------------------------
# nn.Module holder
# ---------------------------------------------------------------------------

def _to_module(tree, requires_grad: bool) -> nn.Module:
    """Nested dict/list parameter tree → nested ModuleDict/ParameterDict."""
    if isinstance(tree, list):
        return nn.ModuleList([_to_module(v, requires_grad) for v in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=requires_grad)
             for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v, requires_grad)
                          for k, v in tree.items()})


def _to_tree(module: nn.Module):
    if isinstance(module, nn.ModuleList):
        return [_to_tree(m) for m in module]
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    return {k: _to_tree(m) for k, m in module.items()}


class DeepFRIGCN(nn.Module):
    """A GCN parameter tree and its config as an ``nn.Module``.

    ``forward`` runs the fused path (:func:`gcn_forward_fused`);
    :meth:`forward_dense` runs the dense reference (:func:`gcn_forward`).
    Parameters are frozen (inference) unless ``trainable=True``; training
    runs the dense route, whose autograd graph :meth:`forward_dense` and
    :func:`gcn_forward_logits` on :meth:`tree` both record.
    """

    def __init__(self, config: GCNConfig, params: dict,
                 trainable: bool = False):
        super().__init__()
        compute_dtype_of(config)  # reject an unknown dtype up front
        self.config = config
        self.params = _to_module(params, trainable)

    def tree(self) -> dict:
        """The parameters as the plain tree the functional forwards take."""
        return _to_tree(self.params)

    def forward(self, tokens, proj_coords, ins_mask, lengths,
                threshold: float = 6.0,
                generated_contacts: int = 2) -> torch.Tensor:
        return gcn_forward_fused(self.tree(), self.config, tokens,
                                 proj_coords, ins_mask, lengths,
                                 threshold=threshold,
                                 generated_contacts=generated_contacts)

    def forward_dense(self, tokens, adjacency, lengths) -> torch.Tensor:
        return gcn_forward(self.tree(), self.config, tokens, adjacency,
                           lengths)


class DeepFRICNN(nn.Module):
    """A CNN parameter tree and its config as an ``nn.Module`` (frozen);
    ``forward`` runs :func:`cnn_forward`."""

    def __init__(self, config: CNNConfig, params: dict):
        super().__init__()
        self.config = config
        self.params = _to_module(params, False)

    def tree(self) -> dict:
        return _to_tree(self.params)

    def forward(self, tokens, lengths) -> torch.Tensor:
        return cnn_forward(self.tree(), self.config, tokens, lengths)
