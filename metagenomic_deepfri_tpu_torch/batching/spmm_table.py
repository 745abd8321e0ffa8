"""Measured per-bucket GraphConv aggregation route (the ``spmm="auto"``
policy).

Counterpart of ``metagenomic_deepfri_tpu/batching/spmm_table.py``. The
engine has two routes for the A·X aggregation of the GCN:

* ``"dense"`` — build the (B, L, L) 0/1 adjacency in device memory once a
  batch (:func:`..ops.cmap_align.aligned_contacts_from_coords`) and run the
  three GraphConv products as ``torch.bmm`` (the JAX package's ``"xla"``);
* ``"fused"`` — the hand-written kernels of :mod:`..ops.graphconv`, which
  rebuild adjacency tiles from the O(L) projected coordinates and contract
  them at once (the JAX package's ``"pallas"``).

Which is faster depends on the bucket length and the compute dtype. The table
below holds the measured choice per (bucket, dtype); ``spmm="auto"`` (the
engine's default) resolves through it, snapping an unmeasured bucket to the
nearest measured one. A batch of two or more modes that share the LSTM-LM
takes the dense shared-trunk step under ``"auto"`` without looking here, as
in the JAX engine.
"""

from __future__ import annotations

import torch

# (bucket, compute_dtype) -> "fused" | "dense".
# Measured on one NVIDIA H100 80GB HBM3, power limit 700.00 W
# (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader),
# 2026-10-16, by
#   python -m metagenomic_deepfri_tpu_torch.bench_utils matrix --device cuda
# (device-only proteins/s of one mf GCN at the published width, 512 terms,
# the engine's own batch sizes, best of 3; raw cells in PERF.md). A cell is
# "dense" only where the dense route beats the fused one by more than the
# larger spread of the two cells' passes.
AUTO_SPMM_TABLE: dict = {
    (128, "bfloat16"): "fused",
    (256, "bfloat16"): "fused",
    (512, "bfloat16"): "fused",
    (1024, "bfloat16"): "fused",
    (2048, "bfloat16"): "fused",
    (128, "float32"): "fused",
    (256, "float32"): "fused",
    (512, "float32"): "fused",
    (1024, "float32"): "fused",
    (2048, "float32"): "fused",
}

SPMM_POLICIES = ("auto", "fused", "dense")


def resolve_spmm(policy: str, bucket: int, compute_dtype: str,
                 device) -> str:
    """The route (``"fused"`` or ``"dense"``) of one bucket under ``policy``.

    ``"fused"``/``"dense"`` pass through. ``"auto"`` is ``"dense"`` off a
    CUDA device (the kernels run only there; the JAX package's ``"auto"`` is
    ``"xla"`` off the TPU) and otherwise the table's entry for the nearest
    measured bucket of ``compute_dtype`` (``"dense"`` for a dtype the table
    lacks).
    """
    if policy not in SPMM_POLICIES:
        raise ValueError(f"spmm must be one of {SPMM_POLICIES}, got "
                         f"{policy!r}")
    if policy != "auto":
        return policy
    if torch.device(device).type != "cuda":
        return "dense"
    dtype = str(compute_dtype)
    candidates = [b for (b, d) in AUTO_SPMM_TABLE if d == dtype]
    if not candidates:
        return "dense"
    nearest = min(candidates, key=lambda b: abs(b - int(bucket)))
    return AUTO_SPMM_TABLE[(nearest, dtype)]
