"""Parameter trees between numpy (the JAX package's form) and torch.

A JAX GCN or CNN tree — nested dicts and lists of arrays from ``init_gcn``,
``init_cnn`` or the ONNX importers — has the layouts the port keeps (dense
kernels (in, out) for ``x @ kernel``; LSTM ``kernel`` (in, 4H),
``recurrent`` (H, 4H), gates ``[i, f, c, o]``; conv kernels (width, in, out),
which the CNN forward permutes for ``conv1d``), so conversion is a plain copy
of each leaf, with no transposes or reordering.
"""

from __future__ import annotations

import numpy as np
import torch


def gcn_params_from_numpy(tree, device,
                          dtype: torch.dtype = torch.float32,
                          requires_grad: bool = False):
    """Copy every array leaf of ``tree`` to a ``dtype`` tensor on ``device``.

    Leaves may be numpy arrays, anything ``np.asarray`` accepts, or tensors
    (moved, not copied, when already of that device and dtype). With
    ``requires_grad`` every leaf is a fresh copy that autograd tracks: the
    trainable parameters of a fine-tuning run, which the optimizer updates
    in place without touching ``tree``.
    """
    if isinstance(tree, dict):
        return {k: gcn_params_from_numpy(v, device, dtype, requires_grad)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gcn_params_from_numpy(v, device, dtype, requires_grad)
                for v in tree]
    if isinstance(tree, torch.Tensor):
        leaf = tree.detach().to(device=device, dtype=dtype,
                                copy=requires_grad)
    else:
        leaf = torch.tensor(np.asarray(tree), dtype=dtype, device=device)
    return leaf.requires_grad_(requires_grad)


def gcn_params_to_numpy(tree):
    """Inverse of :func:`gcn_params_from_numpy`: float32 numpy leaves
    (numpy leaves pass through as float32)."""
    if isinstance(tree, dict):
        return {k: gcn_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gcn_params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", torch.float32).numpy()
    return np.asarray(tree, np.float32)


# The CNN tree converts leaf by leaf exactly as the GCN tree does.
cnn_params_from_numpy = gcn_params_from_numpy
cnn_params_to_numpy = gcn_params_to_numpy
