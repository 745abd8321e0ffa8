"""Parameter trees between numpy (the JAX package's form) and torch.

A JAX GCN tree — nested dicts and lists of arrays from ``init_gcn`` or the
ONNX importers — has the layouts the port keeps (kernels (in, out) for
``x @ kernel``; LSTM ``kernel`` (in, 4H), ``recurrent`` (H, 4H), gates
``[i, f, c, o]``), so conversion is a plain copy of each leaf, with no
transposes or reordering.
"""

from __future__ import annotations

import numpy as np
import torch


def gcn_params_from_numpy(tree, device,
                          dtype: torch.dtype = torch.float32):
    """Copy every array leaf of ``tree`` to a ``dtype`` tensor on ``device``.

    Leaves may be numpy arrays, anything ``np.asarray`` accepts, or tensors
    (moved, not copied, when already of that device and dtype).
    """
    if isinstance(tree, dict):
        return {k: gcn_params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gcn_params_from_numpy(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def gcn_params_to_numpy(tree):
    """Inverse of :func:`gcn_params_from_numpy`: float32 numpy leaves."""
    if isinstance(tree, dict):
        return {k: gcn_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gcn_params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()
