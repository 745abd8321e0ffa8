"""DeepFRI GCN in PyTorch: dense reference forward and the fused forward.

Counterpart of ``metagenomic_deepfri_tpu/models/deepfri.py`` (GCN half).
Parameters are plain trees of tensors with the JAX package's structure and
layouts (kernels stored (in, out) for ``x @ kernel``), so a JAX tree converts
with :func:`..models.convert.gcn_params_from_numpy` and no transposes.
:class:`DeepFRIGCN` holds such a tree as an ``nn.Module``.

GCN:   one-hot(26) ─┬─ LSTM-LM stack ── Dense(no bias) ──┐
                    └─ Dense(bias) ──────────────────────┴─ add → ReLU
       → 3 × GraphConv(512, ReLU):  Hₗ₊₁ = relu(Â · Hₗ · Wₗ)
       → concat(H₁‖H₂‖H₃) → masked sum-pool over L
       → Dense(1024, ReLU) → Dense(2·n_labels) → reshape (n_labels, 2)
       → softmax(last) → score = [..., 0]
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from metagenomic_deepfri_tpu_torch.models.lstm import (init_lstm_stack,
                                                       lstm_stack_forward)
from metagenomic_deepfri_tpu_torch.ops.graphconv import normalized_aggregate
from metagenomic_deepfri_tpu_torch.ops.one_hot import (VOCAB_SIZE,
                                                       tokens2onehot)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


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
    ``init_gcn``; different numbers, since the generators differ)."""
    lm_out = config.lm_hidden * (2 if config.lm_bidirectional else 1)
    params = {
        "lm": init_lstm_stack(config.vocab, config.lm_hidden,
                              config.lm_layers, generator, device,
                              bidirectional=config.lm_bidirectional),
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


def _head_scores(head_params: dict, x: torch.Tensor,
                 n_labels: int) -> torch.Tensor:
    """Per-term 2-way softmax; score = class-0 probability."""
    logits = _dense(head_params, x)
    logits = logits.reshape(*logits.shape[:-1], n_labels, 2)
    return torch.softmax(logits, dim=-1)[..., 0]


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


def _embed(params: dict, config: GCNConfig, tokens: torch.Tensor,
           lengths: torch.Tensor):
    """One-hot → LSTM-LM + residue embedding → (x in compute dtype, valid)."""
    dtype = compute_dtype_of(config)
    L = tokens.shape[1]
    valid = (torch.arange(L, dtype=torch.int32, device=tokens.device)[None, :]
             < lengths.to(torch.int32)[:, None]).to(torch.float32)
    onehot = tokens2onehot(tokens, torch.float32) * valid[:, :, None]
    lm_out = lstm_stack_forward(params["lm"], onehot, lengths,
                                compute_dtype=dtype)
    x = _dense(params["lm_embed"], lm_out) + _dense(params["aa_embed"], onehot)
    return torch.relu(x).to(dtype), valid


def _pooled_head(params: dict, config: GCNConfig, gc_outputs: list,
                 valid: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """concat → masked pool → FC stack → per-term scores (B, n_labels)."""
    concat = torch.cat(gc_outputs, dim=-1).to(torch.float32)
    # Padded rows are zero unless a GraphConv bias shifted them, so pooling
    # always re-masks to valid positions.
    pooled = _pool_over_length(concat, valid, lengths, config.pool)
    for layer in params["fc"]:
        pooled = torch.relu(_dense(layer, pooled))
    return _head_scores(params["head"], pooled, config.n_labels)


def gcn_forward(params: dict, config: GCNConfig, tokens: torch.Tensor,
                adjacency: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Batched GCN forward on a dense adjacency (the plain reference path).

    Args:
        tokens: (B, L) uint8 token ids (padded with PAD_TOKEN).
        adjacency: (B, L, L) float 0/1 contact maps, padded rows/cols zeroed,
            identity on the valid diagonal.
        lengths: (B,) int32 true lengths.

    Returns:
        (B, n_labels) float32 per-term scores in [0, 1].
    """
    dtype = compute_dtype_of(config)
    x, valid = _embed(params, config, tokens, lengths)
    adj = normalize_adjacency(adjacency.to(torch.float32),
                              config.adj_norm).to(dtype)
    gc_outputs = []
    for layer in params["gc"]:
        # adj and x are already rounded to the compute dtype; their float32
        # bmm is the reference's preferred_element_type=float32 product.
        agg = torch.bmm(adj.to(torch.float32), x.to(torch.float32))
        x = graphconv_apply(layer, agg.to(dtype), dtype)
        gc_outputs.append(x)
    return _pooled_head(params, config, gc_outputs, valid, lengths)


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
    for layer in params["gc"]:
        agg, degrees = normalized_aggregate(
            proj_coords, ins_mask, lengths, x.to(torch.float32),
            threshold=threshold, generated_contacts=generated_contacts,
            adj_norm=config.adj_norm, degrees=degrees,
            compute_dtype=config.compute_dtype)
        x = graphconv_apply(layer, agg.to(dtype), dtype)
        gc_outputs.append(x)
    return _pooled_head(params, config, gc_outputs, valid, lengths)


# ---------------------------------------------------------------------------
# nn.Module holder
# ---------------------------------------------------------------------------

def _to_module(tree) -> nn.Module:
    """Nested dict/list parameter tree → nested ModuleDict/ParameterDict."""
    if isinstance(tree, list):
        return nn.ModuleList([_to_module(v) for v in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


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
    Parameters are frozen (inference only).
    """

    def __init__(self, config: GCNConfig, params: dict):
        super().__init__()
        compute_dtype_of(config)  # reject an unknown dtype up front
        self.config = config
        self.params = _to_module(params)

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
