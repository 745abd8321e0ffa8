"""Sharding specs and the data- and tensor-parallel GCN forward.

Counterpart of ``metagenomic_deepfri_tpu/parallel/shard.py:32-106``, with
the same layout:

- **data axis**: every per-protein batch array (tokens, adjacency,
  lengths, labels) is split on its leading batch dimension;
- **model axis** (Megatron pairs): the embedding projections are
  column-parallel (output features split), the first GraphConv contracts
  the split embedding (row-parallel, its bias added after the reduce), the
  deeper GraphConv layers are replicated, the FC stack is column-parallel
  and the per-term head row-parallel, so the logits come out replicated
  after one reduce;
- the LSTM-LM is replicated.

GSPMD inserted the collectives for the JAX package; here each is written
out, as autograd functions, since training runs through them:

- :class:`CopyToModel` (identity forward, all-reduce backward) at the input
  of a column-parallel layer: the LM output before the embeddings, the
  pooled vector before the FC stack;
- :class:`ReduceFromModel` (all-reduce forward, identity backward) at the
  output of a row-parallel layer: after the first GraphConv and after the
  head;
- :class:`GatherFromModel` (all-gather forward; backward all-reduces and
  keeps this rank's columns) between consecutive column-parallel FC layers.

Every rank computes the same loss from the replicated logits, so each
replicated parameter receives its full gradient on every model rank and
each split parameter the gradient of its own shard; no other reduction over
``model`` is needed (a collective whose backward reduced again would scale
the gradient by the model-axis size).

The per-rank functions (:func:`shard_params`,
:func:`make_sharded_gcn_forward`, :func:`gather_params`) run inside a
process group on a mesh from :mod:`.mesh`; :func:`sharded_gcn_forward` is
the one-process form over a device list (:func:`.launch.run_ranks`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_from_numpy
from metagenomic_deepfri_tpu_torch.models.deepfri import (
    GCNConfig, _dense, _masked_onehot, _merge_embeddings,
    _pool_over_length, compute_dtype_of, graphconv_apply, normalize_adjacency)
from metagenomic_deepfri_tpu_torch.models.lstm import (accumulate_dtype,
                                                       lstm_stack_forward)
from metagenomic_deepfri_tpu_torch.parallel.launch import run_ranks
from metagenomic_deepfri_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                         MODEL_AXIS,
                                                         axis_group,
                                                         axis_rank,
                                                         axis_size, make_mesh)

# ---------------------------------------------------------------------------
# Specs: which dimension of each leaf (or batch array) is split
# ---------------------------------------------------------------------------


def _with_bias(layer: dict, kernel_dim, bias_dim) -> dict:
    """Layer spec mirroring the layer's optional bias."""
    spec = {"kernel": kernel_dim}
    if "bias" in layer:
        spec["bias"] = bias_dim
    return spec


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated(v) for v in tree]
    return None


def gcn_param_pspecs(params: dict) -> dict:
    """The parameter tree's structure, each leaf replaced by the dimension
    split over ``model`` (None: replicated), as the JAX ``gcn_param_pspecs``
    places them. Bias entries appear only where the tree has them."""
    return {
        "lm": _replicated(params["lm"]),
        # column-parallel into the embedding space
        "lm_embed": _with_bias(params["lm_embed"], 1, 0),
        "aa_embed": _with_bias(params["aa_embed"], 1, 0),
        # the first GraphConv contracts the split embedding (row-parallel,
        # bias after the reduce); deeper layers replicated
        "gc": [_with_bias(params["gc"][0], 0, None)]
        + [_with_bias(layer, None, None) for layer in params["gc"][1:]],
        # FC column-parallel, head row-parallel: one reduce at the output
        "fc": [_with_bias(layer, 1, 0) for layer in params["fc"]],
        "head": _with_bias(params["head"], 0, None),
    }


def batch_pspecs(with_adj: bool = True) -> tuple:
    """The dimension of (tokens, adjacency?, lengths) split over ``data``:
    the batch dimension of each."""
    return (0, 0, 0) if with_adj else (0, 0)


def _map2(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, s) for v, s in zip(tree, spec, strict=True)]
    return fn(tree, spec)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(leaf, np.float32)


def shard_params(params: dict, mesh, pspecs: Optional[dict] = None, *,
                 device, dtype: torch.dtype = torch.float32,
                 requires_grad: bool = False) -> dict:
    """This rank's shards of a full parameter tree, on ``device``.

    ``params`` has the JAX package's structure and layouts (numpy, JAX or
    tensor leaves); each split leaf keeps this rank's equal part along its
    split dimension, every other leaf is copied whole
    (:func:`..models.convert.gcn_params_from_numpy`). A split dimension
    that the model axis does not divide raises ``ValueError``.
    """
    pspecs = pspecs if pspecs is not None else gcn_param_pspecs(params)
    n, k = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)

    def local(leaf, dim):
        a = _host(leaf)
        if dim is None:
            return a
        if a.shape[dim] % n:
            raise ValueError(f"dimension {dim} of a {a.shape} leaf does not "
                             f"split over {n} model ranks")
        return np.split(a, n, axis=dim)[k]

    return gcn_params_from_numpy(_map2(local, params, pspecs), device, dtype,
                                 requires_grad)


def gather_params(local: dict, mesh, pspecs: dict) -> dict:
    """The full parameter tree as float32 numpy, from every model rank's
    shards (all-gather over ``model``; every rank must call it)."""
    group = axis_group(mesh, MODEL_AXIS)
    n = axis_size(mesh, MODEL_AXIS)

    def full(leaf, dim):
        leaf = leaf.detach()
        if dim is not None and n > 1:
            parts = [torch.empty_like(leaf) for _ in range(n)]
            dist.all_gather(parts, leaf.contiguous(), group=group)
            leaf = torch.cat(parts, dim=dim)
        return _host(leaf)

    return _map2(full, local, pspecs)


def data_slice(mesh, *arrays):
    """This data rank's equal slice of each array's batch dimension.

    The batch must be a multiple of the data axis (``finetune`` rounds its
    batch size up to one, as the JAX ``finetune`` does).
    """
    n, k = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    out = []
    for a in arrays:
        if a.shape[0] % n:
            raise ValueError(f"batch of {a.shape[0]} does not split over "
                             f"{n} data ranks")
        b = a.shape[0] // n
        out.append(a[k * b:(k + 1) * b])
    return out


# ---------------------------------------------------------------------------
# Collectives with their gradients
# ---------------------------------------------------------------------------


def _group_size(group) -> int:
    return dist.get_world_size(group)


class CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over ``group`` backward
    (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward; identity backward (the
    output of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class GatherFromModel(torch.autograd.Function):
    """All-gather of the last dimension over ``group`` forward; backward,
    the all-reduced gradient's columns of this rank (between two
    column-parallel layers)."""

    @staticmethod
    def forward(ctx, x, group):
        n = _group_size(group)
        ctx.group, ctx.rank, ctx.width = group, dist.get_rank(group), \
            x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


def _collective(fn, x, group):
    """``fn`` over ``group``, or ``x`` itself over a group of one."""
    return x if _group_size(group) == 1 else fn.apply(x, group)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def sharded_gcn_logits(params: dict, config: GCNConfig, mesh, tokens,
                       adjacency, lengths) -> torch.Tensor:
    """(B_local, n_labels, 2) logits of this data rank's batch slice, with
    ``params`` this rank's shards (:func:`shard_params`); replicated over
    ``model``. The same math as ``gcn_forward_logits`` on the whole tree."""
    group = axis_group(mesh, MODEL_AXIS)
    dtype = compute_dtype_of(config)
    acc = accumulate_dtype(dtype)
    onehot, valid = _masked_onehot(tokens, lengths, acc)
    lm_out = lstm_stack_forward(params["lm"], onehot, lengths,
                                compute_dtype=dtype)
    lm_out = _collective(CopyToModel, lm_out, group)
    # this rank's columns of the embedding
    x = _merge_embeddings(params["lm_embed"], params["aa_embed"], lm_out,
                          onehot, dtype)
    adj = normalize_adjacency(adjacency.to(acc), config.adj_norm).to(dtype)
    gc_outputs = []
    for gi, layer in enumerate(params["gc"]):
        agg = torch.bmm(adj.to(acc), x.to(acc)).to(dtype)
        if gi == 0:  # row-parallel: partial products summed over model
            h = _collective(ReduceFromModel,
                            (agg @ layer["kernel"].to(dtype)).to(acc), group)
            h = h.to(dtype)
            if "bias" in layer:
                h = h + layer["bias"].to(dtype)
            x = torch.relu(h)
        else:
            x = graphconv_apply(layer, agg, dtype)
        gc_outputs.append(x)
    concat = torch.cat(gc_outputs, dim=-1).to(valid.dtype)
    pooled = _pool_over_length(concat, valid, lengths, config.pool)
    pooled = _collective(CopyToModel, pooled, group)
    for fi, layer in enumerate(params["fc"]):
        if fi:
            pooled = _collective(GatherFromModel, pooled, group)
        pooled = torch.relu(_dense(layer, pooled))
    head = params["head"]
    logits = _collective(ReduceFromModel, pooled @ head["kernel"], group)
    if "bias" in head:
        logits = logits + head["bias"]
    return logits.reshape(*logits.shape[:-1], config.n_labels, 2)


def make_sharded_gcn_forward(mesh, config: GCNConfig, params=None):
    """The data- and tensor-parallel GCN forward of one rank.

    Returns ``fn(local_params, tokens, adjacency, lengths) -> (B_local,
    n_labels)`` scores: inputs are this data rank's slice of the batch
    (:func:`data_slice`), ``local_params`` its shards (:func:`shard_params`);
    the scores are replicated over ``model``. ``params`` is accepted for
    the JAX signature and not needed.
    """
    del params

    def fwd(local_params, tokens, adjacency, lengths):
        logits = sharded_gcn_logits(local_params, config, mesh, tokens,
                                    adjacency, lengths)
        return torch.softmax(logits, dim=-1)[..., 0]

    return fwd


def _sharded_forward_rank(device, config, params, tokens, adjacency, lengths,
                          model_parallel):
    mesh = make_mesh(model_parallel=model_parallel)
    local = shard_params(params, mesh, device=device,
                         dtype=accumulate_dtype(compute_dtype_of(config)))
    batch = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in data_slice(mesh, tokens, adjacency, lengths)]
    with torch.no_grad():
        out = make_sharded_gcn_forward(mesh, config)(local, *batch)
    return out.to("cpu", torch.float32).numpy()


def sharded_gcn_forward(devices, config: GCNConfig, params: dict, tokens,
                        adjacency, lengths, *, model_parallel: int = 1
                        ) -> np.ndarray:
    """One-process form: the (B, n_labels) scores of a numpy batch, data-
    parallel and tensor-parallel over one rank a listed device
    (``model_parallel`` of them along the model axis)."""
    results = run_ranks(_sharded_forward_rank, devices, config, params,
                        np.asarray(tokens), np.asarray(adjacency, np.float32),
                        np.asarray(lengths), model_parallel)
    # model rank 0 of each data rank, in data order (ranks fill rows)
    return np.concatenate(results[::model_parallel], axis=0)
