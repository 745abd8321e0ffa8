"""Length bucketing for variable-size protein batches.

A copy of ``metagenomic_deepfri_tpu/batching/buckets.py``, which is pure
Python but cannot be imported without jax (its package ``__init__`` loads
the JAX engine). The batch rule below was tuned for the JAX package's dense
(B, L, L) adjacency on its original accelerator; the port's fused path never
builds that adjacency, and the rule has not been re-derived for the GPU yet
(``batch_cap`` on the engine bounds it meanwhile).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Sequence

# Bucket boundaries (multiples of 128 beyond the smallest).
DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048)

# Target adjacency elements per GCN batch (B·L²) and batch ceiling, carried
# over unchanged from the JAX package.
_TARGET_ADJ_ELEMS = 512 * 1024 * 1024
_MAX_GCN_BATCH = 2048
# Target token elements per CNN batch (B·L) — CNN has no O(L²) term.
_TARGET_TOK_ELEMS = 512 * 1024
# Token slots (rows × bucket) a batch of a GCN with an ESM-2 trunk, whose
# ~1.3 GFLOP a token dwarfs the rest: the B·L² rule above would give
# ~1 M tokens (~27 s of float32 work) a batch at bucket 512. Chosen by a
# sweep on the H100 (PERF.md).
ESM_TOKEN_SLOTS = 32 * 1024


def assign_bucket(length: int,
                  buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket that fits ``length``; beyond the ceiling, an ad-hoc
    256-aligned bucket (the reference imposes no length limit)."""
    for b in buckets:
        if length <= b:
            return b
    return -(-length // 256) * 256


def gcn_batch_size(bucket: int) -> int:
    """Batch size keeping B·L² ≈ constant (capped), multiple-of-8."""
    b = max(1, min(_MAX_GCN_BATCH, _TARGET_ADJ_ELEMS // (bucket * bucket)))
    if b >= 8:
        b -= b % 8
    return b


def esm_batch_size(bucket: int) -> int:
    """Rows keeping B·L ≈ :data:`ESM_TOKEN_SLOTS`: 256, 128, 64, 32 at
    buckets 128-1024; multiple-of-8 from 8 up."""
    b = max(1, ESM_TOKEN_SLOTS // bucket)
    if b >= 8:
        b -= b % 8
    return b


def cnn_batch_size(bucket: int) -> int:
    b = max(1, _TARGET_TOK_ELEMS // bucket)
    if b >= 8:
        b -= b % 8
    return b


def bucket_plan(lengths: Iterable[int],
                buckets: Sequence[int] = DEFAULT_BUCKETS) -> dict:
    """Group item indices by bucket: {bucket_len: [indices]}."""
    plan = defaultdict(list)
    for idx, length in enumerate(lengths):
        plan[assign_bucket(length, buckets)].append(idx)
    return dict(plan)
