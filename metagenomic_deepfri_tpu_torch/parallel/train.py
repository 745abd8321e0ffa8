"""Fine-tuning step for DeepFRI GCN models, on one device.

Counterpart of ``metagenomic_deepfri_tpu/parallel/train.py``:

- loss: per-term two-way softmax cross-entropy (:func:`gcn_loss`), matching
  the inference head's ``(n_labels, 2) → softmax → class-0 score`` contract,
  so a fine-tuned checkpoint drops straight into the inference engine;
- gradients: autograd through the dense-adjacency forward
  (:func:`..models.deepfri.gcn_forward_logits`), as the JAX package takes
  ``jax.value_and_grad`` of the same forward. The adjacency is data (built by
  the B3 contact-map kernel, :mod:`..ops.contact`) and needs no gradient;
- optimizer: ``torch.optim.Adam`` with ``optax.adam``'s defaults
  (:func:`adam`), or any factory of a ``torch.optim.Optimizer``.

A torch optimizer is a stateful object bound to its parameters, so it lives
in :class:`TrainState` (where the JAX state keeps ``opt_state``) and the
step updates the parameters and moments in place; the JAX step is
functional and donates its state instead. There is no mesh: multi-GPU data
and tensor parallelism is later work.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_from_numpy
from metagenomic_deepfri_tpu_torch.models.deepfri import (GCNConfig,
                                                          compute_dtype_of,
                                                          gcn_forward_logits,
                                                          init_gcn)
from metagenomic_deepfri_tpu_torch.models.lstm import accumulate_dtype

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


def gcn_loss(params: dict, config: GCNConfig, tokens, adjacency, lengths,
             labels) -> torch.Tensor:
    """Mean per-term cross-entropy against {0,1} GO-term labels.

    The head emits (B, n_labels, 2) logits whose softmax class 0 is the
    positive-term probability, so a positive label selects class index 0.
    """
    logits = gcn_forward_logits(params, config, tokens, adjacency, lengths)
    target = 1 - labels.to(torch.int64)  # positive → class 0
    return F.cross_entropy(logits.reshape(-1, 2), target.reshape(-1))


def init_train_state(config: GCNConfig,
                     optimizer: Union[float, OptimizerFactory], device, *,
                     params: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """Trainable parameters on ``device`` and their optimizer.

    Pass ``params`` (a numpy or tensor tree, copied) to fine-tune imported
    weights, or a ``generator`` for a fresh :func:`..deepfri.init_gcn`.
    ``optimizer`` is a learning rate (:func:`adam`) or a factory taking the
    list of parameter tensors. Parameters are float32 (float64 for float64
    compute); bfloat16 compute keeps float32 parameters, as the JAX package.
    """
    device = torch.device(device)
    if params is None:
        if generator is None:
            raise ValueError("pass params to fine-tune, or a generator to "
                             "initialise")
        params = init_gcn(config, generator, device)
    dtype = accumulate_dtype(compute_dtype_of(config))
    params = gcn_params_from_numpy(params, device, dtype, requires_grad=True)
    factory = adam(optimizer) if isinstance(optimizer, (int, float)) \
        else optimizer
    return TrainState(params=params, opt_state=factory(param_leaves(params)))


def make_train_step(config: GCNConfig):
    """Build the train step.

    Returns ``step_fn(state, tokens, adjacency, lengths, labels) ->
    (state, loss)``: inputs are tensors on the state's device, ``loss`` a
    detached scalar tensor (reading it synchronises; the step itself does
    not). The optimizer is the one in ``state`` (:func:`init_train_state`).
    """
    def step_fn(state: TrainState, tokens, adjacency, lengths, labels):
        loss = gcn_loss(state.params, config, tokens, adjacency, lengths,
                        labels)
        state.opt_state.zero_grad(set_to_none=True)
        loss.backward()
        state.opt_state.step()
        return (TrainState(state.params, state.opt_state, state.step + 1),
                loss.detach())

    return step_fn
