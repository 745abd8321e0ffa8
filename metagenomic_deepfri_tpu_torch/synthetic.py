"""Seeded synthetic inputs (numpy) for parity tests and the GPU smoke run.

Published weights and structures are not needed: every input here is built
from a seed, so the JAX package and the port can be handed identical arrays.
"""

from __future__ import annotations

import numpy as np

from metagenomic_deepfri_tpu_torch.ops.cmap_align import (
    _SENTINEL_BASE, _SENTINEL_SPACING, project_alignment_coords)

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def contact_batch(B: int = 2, L: int = 128, seed: int = 0, n_ins: int = 3):
    """Random-walk CA chains with sentinels and insertions.

    The same generator as the JAX package's ``tests/test_pallas.py::_mk_batch``:
    lengths in [L/2, L], 3.8 Å steps, two unmapped (sentinel) positions and
    ``n_ins`` insertion positions per protein. Returns numpy
    ``coords (B, L, 3) float32, ins (B, L) bool, lengths (B,) int32``.
    """
    rng = np.random.default_rng(seed)
    coords = np.zeros((B, L, 3), np.float32)
    ins = np.zeros((B, L), bool)
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    for b in range(B):
        n = lengths[b]
        steps = rng.normal(size=(n, 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        coords[b, :n] = np.cumsum(3.8 * steps, axis=0)
        unmapped = rng.choice(n, size=2, replace=False)
        coords[b, unmapped] = 0.0
        coords[b, unmapped, 0] = (_SENTINEL_BASE
                                  + _SENTINEL_SPACING * unmapped)
        ins[b, rng.choice(n, size=n_ins, replace=False)] = True
    return coords, ins, lengths


def _sqdist_f32(p: np.ndarray, q: np.ndarray) -> np.float32:
    """Squared distance in float32, multiplied then added x, y, z in order."""
    d = (p - q).astype(np.float32)
    return np.float32(np.float32(d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])


def near_threshold_batch(B: int = 4, L: int = 512, seed: int = 0,
                         threshold: float = 6.0):
    """Points whose float32 distance² to row 0 sits within an ulp of thr².

    Row 0 of each protein is a centre; every other row lies in a random
    direction at distance ≈ threshold, with its x nudged by single ulps until
    the float32 squared distance (mul-then-add, x, y, z) is thr² − 1 ulp,
    thr² or thr² + 1 ulp. An FMA-contracted distance rounds differently and
    flips some of these pairs. Returns the same triple as
    :func:`contact_batch`, with full lengths and no insertions.
    """
    rng = np.random.default_rng(seed)
    thr2 = np.float32(threshold * threshold)
    targets = (np.nextafter(thr2, np.float32(0)), thr2,
               np.nextafter(thr2, np.float32(np.inf)))
    coords = np.zeros((B, L, 3), np.float32)
    for b in range(B):
        centre = rng.uniform(-4.0, 4.0, size=3).astype(np.float32)
        coords[b, 0] = centre
        for i in range(1, L):
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            q = (centre + threshold * u).astype(np.float32)
            want = targets[rng.integers(3)]
            for _ in range(64):
                got = _sqdist_f32(q, centre)
                if got == want:
                    break
                step = np.float32(np.inf if (got < want) == (q[0] > centre[0])
                                  else -np.inf)
                q[0] = np.nextafter(q[0], step)
            coords[b, i] = q
    ins = np.zeros((B, L), bool)
    lengths = np.full(B, L, np.int32)
    return coords, ins, lengths


def _target_chain(rng, n: int) -> np.ndarray:
    steps = rng.normal(size=(n, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def aligned_protein(rng, query_len: int, indel_rate: float = 0.08):
    """One query protein aligned to a synthetic target structure with indels.

    Walks a gapped alignment column by column: matches, query insertions
    (target gap) and deletions (query gap). Returns
    ``(sequence, proj_coords (Q, 3), ins_mask (Q,))`` through
    :func:`.ops.cmap_align.project_alignment_coords`, so unmapped query
    residues carry sentinel coordinates.
    """
    q_cols, t_cols = [], []
    t_len = 0
    q = 0
    while q < query_len:
        r = rng.random()
        if r < indel_rate / 2:            # query residue against a target gap
            q_cols.append("A")
            t_cols.append("-")
            q += 1
        elif r < indel_rate:              # target residue against a query gap
            q_cols.append("-")
            t_cols.append("A")
            t_len += 1
        else:
            q_cols.append("A")
            t_cols.append("A")
            q += 1
            t_len += 1
    seq = "".join(rng.choice(list(AMINO_ACIDS), size=query_len))
    proj, ins, qlen = project_alignment_coords(
        "".join(q_cols), "".join(t_cols), _target_chain(rng, max(t_len, 1)))
    assert qlen == query_len
    return seq, proj, ins


def aligned_items(n: int, seed: int, min_len: int = 40, max_len: int = 500):
    """``n`` engine items ``(id, seq, proj_coords, ins_mask)`` with lengths
    drawn uniformly from [min_len, max_len]."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        seq, proj, ins = aligned_protein(
            rng, int(rng.integers(min_len, max_len + 1)))
        items.append((f"p{i}", seq, proj, ins))
    return items
