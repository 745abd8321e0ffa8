"""Pairwise squared distances of CA coordinates on the device.

Counterpart of ``_pairwise_sqeuclidean_device`` in
``metagenomic_deepfri_tpu/ops/contact.py:77-90``. The distance is the exact
per-axis float32 difference form, summed x, y, z in that order. The Gram
identity ‖a‖²+‖b‖²−2a·b would run on tensor cores and flip contacts that
sit near the threshold.
"""

from __future__ import annotations

import torch


def pairwise_sqeuclidean_device(coords: torch.Tensor) -> torch.Tensor:
    """(B, L, 3) float32 → (B, L, L) float32 squared distances."""
    dx = coords[:, :, None, 0] - coords[:, None, :, 0]
    dy = coords[:, :, None, 1] - coords[:, None, :, 1]
    dz = coords[:, :, None, 2] - coords[:, None, :, 2]
    return dx * dx + dy * dy + dz * dz
