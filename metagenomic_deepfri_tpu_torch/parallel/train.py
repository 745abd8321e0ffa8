"""Fine-tuning step for DeepFRI GCN models, on one device or a mesh.

Counterpart of ``metagenomic_deepfri_tpu/parallel/train.py:42-99``:

- loss: per-term two-way softmax cross-entropy (:func:`gcn_loss`), matching
  the inference head's ``(n_labels, 2) → softmax → class-0 score`` contract,
  so a fine-tuned checkpoint drops straight into the inference engine;
- gradients: autograd through the dense-adjacency forward
  (:func:`..models.deepfri.gcn_forward_logits`), as the JAX package takes
  ``jax.value_and_grad`` of the same forward. The adjacency is data (built by
  the B3 contact-map kernel, :mod:`..ops.contact`) and needs no gradient;
- optimizer: ``torch.optim.Adam`` with ``optax.adam``'s defaults
  (:func:`adam`), or any factory of a ``torch.optim.Optimizer``;
- distribution (with a ``mesh`` from :mod:`.mesh`): each rank holds its
  shards of the parameters (:mod:`.shard`: tensor-parallel over ``model``)
  and its slice of every batch (data-parallel over ``data``). Each data rank
  means the loss over its own slice; the gradients are then summed over the
  data group and divided by its size, which is the gradient of the mean
  over the whole batch, since the slices are equal. Adam is elementwise, so
  stepping each shard equals the unsharded step.

A torch optimizer is a stateful object bound to its parameters, so it lives
in :class:`TrainState` (where the JAX state keeps ``opt_state``) and the
step updates the parameters and moments in place; the JAX step is
functional and donates its state instead.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from metagenomic_deepfri_tpu_torch.models.convert import (gcn_params_from_numpy,
                                                          gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.models.deepfri import (GCNConfig,
                                                          compute_dtype_of,
                                                          gcn_forward_logits,
                                                          init_gcn)
from metagenomic_deepfri_tpu_torch.models.lstm import accumulate_dtype
from metagenomic_deepfri_tpu_torch.parallel.launch import run_ranks
from metagenomic_deepfri_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                         axis_group,
                                                         axis_size, make_mesh)
from metagenomic_deepfri_tpu_torch.parallel.shard import (data_slice,
                                                          gather_params,
                                                          gcn_param_pspecs,
                                                          shard_params,
                                                          sharded_gcn_logits)

OptimizerFactory = Callable[[list], torch.optim.Optimizer]


@dataclass
class TrainState:
    params: dict                     # tree of leaf tensors, requires_grad
    opt_state: torch.optim.Optimizer  # holds the moments; steps in place
    step: int = 0


def adam(learning_rate: float) -> OptimizerFactory:
    """``torch.optim.Adam`` with ``optax.adam``'s defaults (b1 0.9, b2 0.999,
    eps 1e-8 added outside the square root, as in optax)."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8)


def param_leaves(tree) -> list:
    """The tensors of a parameter tree, in a fixed (depth-first) order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in param_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    target = 1 - labels.to(torch.int64)  # positive → class 0
    return F.cross_entropy(logits.reshape(-1, 2), target.reshape(-1))


def gcn_loss(params: dict, config: GCNConfig, tokens, adjacency, lengths,
             labels, mesh=None) -> torch.Tensor:
    """Mean per-term cross-entropy against {0,1} GO-term labels.

    The head emits (B, n_labels, 2) logits whose softmax class 0 is the
    positive-term probability, so a positive label selects class index 0.
    With a ``mesh``, ``params`` are this rank's shards and the batch is this
    data rank's slice; the loss is the mean over that slice.
    """
    if mesh is None:
        logits = gcn_forward_logits(params, config, tokens, adjacency,
                                    lengths)
    else:
        logits = sharded_gcn_logits(params, config, mesh, tokens, adjacency,
                                    lengths)
    return _cross_entropy(logits, labels)


def init_train_state(config: GCNConfig,
                     optimizer: Union[float, OptimizerFactory], device, *,
                     params: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None,
                     mesh=None) -> TrainState:
    """Trainable parameters on ``device`` and their optimizer.

    Pass ``params`` (a numpy or tensor tree, copied) to fine-tune imported
    weights, or a ``generator`` for a fresh :func:`..deepfri.init_gcn`.
    ``optimizer`` is a learning rate (:func:`adam`) or a factory taking the
    list of parameter tensors. Parameters are float32 (float64 for float64
    compute); bfloat16 compute keeps float32 parameters, as the JAX package.
    With a ``mesh`` the state holds this rank's shards (:func:`.shard.
    shard_params`); every rank must pass the same full tree.
    """
    device = torch.device(device)
    if params is None:
        if generator is None:
            raise ValueError("pass params to fine-tune, or a generator to "
                             "initialise")
        params = init_gcn(config, generator,
                          "cpu" if mesh is not None else device)
    dtype = accumulate_dtype(compute_dtype_of(config))
    if mesh is None:
        params = gcn_params_from_numpy(params, device, dtype,
                                       requires_grad=True)
    else:
        params = shard_params(params, mesh, device=device, dtype=dtype,
                              requires_grad=True)
    factory = adam(optimizer) if isinstance(optimizer, (int, float)) \
        else optimizer
    return TrainState(params=params, opt_state=factory(param_leaves(params)))


def _average_over_data(mesh, leaves: list, loss: torch.Tensor) -> None:
    """Replace each gradient, and ``loss``, by its mean over the data group:
    one all-reduce of a flat buffer."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return
    grads = [p.grad for p in leaves if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=axis_group(mesh, DATA_AXIS))
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    loss.copy_(flat[offset])


def make_train_step(config: GCNConfig, mesh=None):
    """Build the train step.

    Returns ``step_fn(state, tokens, adjacency, lengths, labels) ->
    (state, loss)``: inputs are tensors on the state's device (with a
    ``mesh``, this data rank's slice of the batch, :func:`.shard.
    data_slice`), ``loss`` a detached scalar tensor, the mean over the whole
    batch (reading it synchronises; the step itself does not). The
    optimizer is the one in ``state`` (:func:`init_train_state`).
    """
    def step_fn(state: TrainState, tokens, adjacency, lengths, labels):
        loss = gcn_loss(state.params, config, tokens, adjacency, lengths,
                        labels, mesh=mesh)
        state.opt_state.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            _average_over_data(mesh, param_leaves(state.params), loss)
        state.opt_state.step()
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    return step_fn


def _on_device(device, mesh, batch) -> list:
    """This data rank's slice of a numpy batch, as tensors on ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in data_slice(mesh, *batch)]


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grad_tree(v) for v in tree]
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def _value_and_grad_rank(device, config, params, batch, model_parallel):
    mesh = make_mesh(model_parallel=model_parallel)
    local = shard_params(params, mesh, device=device,
                         dtype=accumulate_dtype(compute_dtype_of(config)),
                         requires_grad=True)
    loss = gcn_loss(local, config, *_on_device(device, mesh, batch),
                    mesh=mesh)
    loss.backward()
    loss = loss.detach()
    _average_over_data(mesh, param_leaves(local), loss)
    grads = gather_params(_grad_tree(local), mesh, gcn_param_pspecs(params))
    return (float(loss), grads) if dist.get_rank() == 0 else None


def value_and_grad(devices, config: GCNConfig, params: dict, batch, *,
                   model_parallel: int = 1):
    """One-process form: the mean loss over a whole numpy batch (tokens,
    adjacency, lengths, labels) and its gradient, a numpy tree of the
    parameters' structure, computed as a train step does over one rank a
    listed device (before the optimizer)."""
    return run_ranks(_value_and_grad_rank, devices, config,
                     gcn_params_to_numpy(params), batch, model_parallel)[0]


def _train_steps_rank(device, config, params, batches, learning_rate,
                      model_parallel):
    mesh = make_mesh(model_parallel=model_parallel)
    state = init_train_state(config, learning_rate, device, params=params,
                             mesh=mesh)
    step = make_train_step(config, mesh)
    losses = []
    for batch in batches:
        state, loss = step(state, *_on_device(device, mesh, batch))
        losses.append(float(loss))
    full = gather_params(state.params, mesh, gcn_param_pspecs(params))
    return (losses, full) if dist.get_rank() == 0 else None


def train_steps(devices, config: GCNConfig, params: dict, batches: list,
                learning_rate: float, *, model_parallel: int = 1):
    """One-process form: train on ``batches`` (numpy (tokens, adjacency,
    lengths, labels) tuples, whole batches) over one rank a listed device.
    Returns (the losses, the final full parameter tree as numpy)."""
    losses, full = run_ranks(_train_steps_rank, devices, config,
                             gcn_params_to_numpy(params), batches,
                             learning_rate, model_parallel)[0]
    return losses, full
