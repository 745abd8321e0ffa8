"""Needleman–Wunsch alignment: ctypes binding to the native host engine, a
numpy oracle, and a batched score-only wavefront on a torch device.

Counterpart of ``metagenomic_deepfri_tpu/ops/nw.py``: :func:`nw_align`,
:func:`nw_score_many`, :func:`alignment_stats` and the numpy Gotoh
``_nw_align_python``, used when ``force_python=True`` (the parity oracle of
the tests). The native library is the JAX package's ``nw.cpp``, built by
:mod:`..native.build`; unlike the JAX package, a failed build raises
:class:`..native.build.NativeBuildError` instead of falling back to numpy.
:func:`nw_scores_device` / :func:`nw_score_many_device` port the JAX
package's anti-diagonal wavefront (a ``lax.scan``, so plain torch ops here);
the host engine stays the pipeline's NW, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, List, Tuple

import numpy as np
import torch

from metagenomic_deepfri_tpu_torch.native import build as native

if TYPE_CHECKING:  # align.pairwise imports this module
    from metagenomic_deepfri_tpu_torch.align.matrices import ScoringMatrix

_NEG_INF = np.int32(-(2 ** 29))


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# Python (numpy) reference implementation
# ---------------------------------------------------------------------------

def _nw_align_python(q: np.ndarray, t: np.ndarray, matrix: np.ndarray,
                     gap_open: int, gap_extend: int) -> Tuple[int, str]:
    m, n = len(q), len(t)
    H = np.full((m + 1, n + 1), _NEG_INF, np.int32)
    E = np.full((m + 1, n + 1), _NEG_INF, np.int32)
    F = np.full((m + 1, n + 1), _NEG_INF, np.int32)
    tb = np.zeros((m + 1, n + 1), np.uint8)
    H[0, 0] = 0
    for j in range(1, n + 1):
        E[0, j] = -gap_open - (j - 1) * gap_extend
        H[0, j] = E[0, j]
        tb[0, j] = 1 | (4 if j > 1 else 0)
    for i in range(1, m + 1):
        H[i, 0] = -gap_open - (i - 1) * gap_extend
        F[i, 0] = H[i, 0]
        tb[i, 0] = 2 | (8 if i > 1 else 0)
        srow = matrix[q[i - 1]]
        for j in range(1, n + 1):
            e_open = H[i, j - 1] - gap_open
            e_ext = E[i, j - 1] - gap_extend
            E[i, j] = max(e_open, e_ext)
            f_open = H[i - 1, j] - gap_open
            f_ext = F[i - 1, j] - gap_extend
            F[i, j] = max(f_open, f_ext)
            diag = H[i - 1, j - 1] + srow[t[j - 1]]
            best, flags = diag, 0
            if E[i, j] > best:
                best, flags = E[i, j], 1
            if F[i, j] > best:
                best, flags = F[i, j], 2
            if e_ext > e_open:
                flags |= 4
            if f_ext > f_open:
                flags |= 8
            H[i, j] = best
            tb[i, j] = flags
    # traceback
    i, j = m, n
    state = 0
    out = []
    while i > 0 or j > 0:
        flags = tb[i, j]
        if state == 0:
            if i == 0:
                state = 1
            elif j == 0:
                state = 2
            else:
                state = flags & 3
            if state == 0:
                out.append("M")
                i -= 1
                j -= 1
                continue
        if state == 1:
            out.append("I")
            if not flags & 4:
                state = 0
            j -= 1
        else:
            out.append("D")
            if not flags & 8:
                state = 0
            i -= 1
    return int(H[m, n]), "".join(reversed(out))


def _nw_score_python(q, t, matrix, gap_open, gap_extend) -> int:
    score, _ = _nw_align_python(q, t, matrix, gap_open, gap_extend)
    return score


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def nw_align(query: str, target: str, scoring: ScoringMatrix,
             gap_open: int = 10, gap_extend: int = 1,
             force_python: bool = False) -> Tuple[int, str]:
    """Global alignment; returns (score, alignment string of M/I/D).

    'I' = gap in query, 'D' = gap in target — the convention consumed by
    :func:`..align.pairwise.insert_gaps`.
    """
    q = scoring.encode(query)
    t = scoring.encode(target)
    if force_python:
        return _nw_align_python(q, t, scoring.matrix, gap_open, gap_extend)
    lib = native.load("nw")
    out_buf = ctypes.create_string_buffer(len(q) + len(t) + 1)
    out_len = ctypes.c_int32(0)
    matrix = np.ascontiguousarray(scoring.matrix, np.int32)
    score = lib.nw_align(
        _ptr(q, ctypes.c_int32), len(q),
        _ptr(t, ctypes.c_int32), len(t),
        _ptr(matrix, ctypes.c_int32), matrix.shape[0],
        gap_open, gap_extend, out_buf, ctypes.byref(out_len))
    return int(score), out_buf.raw[: out_len.value].decode("ascii")


def nw_score_many(query: str, targets: List[str], scoring: ScoringMatrix,
                  gap_open: int = 10, gap_extend: int = 1,
                  threads: int = 1,
                  force_python: bool = False) -> np.ndarray:
    """Scores of the query against each target (one-vs-many 'score' mode)."""
    q = scoring.encode(query)
    matrix = np.ascontiguousarray(scoring.matrix, np.int32)
    if force_python:
        return np.asarray([
            _nw_score_python(q, scoring.encode(t), matrix, gap_open,
                             gap_extend) for t in targets], np.int32)
    lib = native.load("nw")
    encoded = [scoring.encode(t) for t in targets]
    offsets = np.zeros(len(targets) + 1, np.int64)
    offsets[1:] = np.cumsum([len(e) for e in encoded])
    concat = (np.concatenate(encoded) if encoded
              else np.zeros(0, np.int32)).astype(np.int32)
    scores = np.zeros(len(targets), np.int32)
    lib.nw_score_batch(
        _ptr(q, ctypes.c_int32), len(q),
        _ptr(concat, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
        len(targets),
        _ptr(matrix, ctypes.c_int32), matrix.shape[0],
        gap_open, gap_extend, threads, _ptr(scores, ctypes.c_int32))
    return scores


def alignment_stats(query: str, target: str,
                    alignment: str) -> Tuple[float, float, float]:
    """(identity, query_coverage, target_coverage) for an M/I/D alignment.

    identity = exact residue matches / alignment length (pyOpal
    ``identity()`` semantics); coverages = consumed residues / sequence
    length (1.0 for global alignment).
    """
    qi = ti = matches = q_cons = t_cons = 0
    for a in alignment:
        if a == "I":
            ti += 1
            t_cons += 1
        elif a == "D":
            qi += 1
            q_cons += 1
        else:
            if qi < len(query) and ti < len(target) and \
                    query[qi].upper() == target[ti].upper():
                matches += 1
            qi += 1
            ti += 1
            q_cons += 1
            t_cons += 1
    length = len(alignment) if alignment else 1
    return (matches / length,
            q_cons / max(len(query), 1),
            t_cons / max(len(target), 1))


# ---------------------------------------------------------------------------
# Device score-mode NW: batched anti-diagonal wavefront.
# ---------------------------------------------------------------------------

def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Shift (B, W) one step along the last axis, filling column 0."""
    return torch.cat([torch.full((x.shape[0], 1), fill, dtype=x.dtype,
                                 device=x.device), x[:, :-1]], dim=1)


def nw_scores_device(query_tokens, target_tokens, target_lengths, matrix,
                     gap_open: int = 10, gap_extend: int = 1, *,
                     device) -> torch.Tensor:
    """Batched global affine-gap NW scores on ``device`` (one query vs B
    targets).

    The DP runs over anti-diagonals: every cell on a diagonal depends only
    on the two previous diagonals, so each step is one vectorised (B, m+1)
    update with no dependency inside it. The substitution scores are
    skewed into diagonal layout before the loop, so its body does no
    gathers. Exact int32 arithmetic: the scores equal the host engine's.

    Args:
        query_tokens: (m,) encoded query, m ≥ 1.
        target_tokens: (B, N) encoded targets, padded arbitrarily.
        target_lengths: (B,) true lengths (≥ 1).
        matrix: (A, A) substitution matrix.

    Returns:
        (B,) int32 tensor of global alignment scores on ``device``.
    """
    def as_int32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    q, t = as_int32(query_tokens), as_int32(target_tokens)
    lengths, matrix = as_int32(target_lengths), as_int32(matrix)
    neg, go, ge = int(_NEG_INF), int(gap_open), int(gap_extend)
    m = q.shape[0]
    B, N = t.shape
    K = m + N
    dev = t.device

    # S_diag[k-1, b, i] = matrix[q[i-1], t[b, k-i-1]] for cell (i, j=k-i).
    prof = matrix[q.long()]                              # (m, A)
    S = prof[:, t.long()].permute(1, 0, 2)               # (B, m, N)
    k_idx = torch.arange(1, K + 1, device=dev)[:, None]  # (K, 1)
    i_idx = torch.arange(m + 1, device=dev)[None, :]     # (1, m+1)
    j_idx = k_idx - i_idx
    interior = (i_idx >= 1) & (j_idx >= 1) & (i_idx <= m) & (j_idx <= N)
    gi = (i_idx - 1).clamp(0, m - 1)
    gj = (j_idx - 1).clamp(0, N - 1)
    S_diag = torch.where(interior[None], S[:, gi, gj],
                         torch.zeros((), dtype=torch.int32, device=dev))
    S_diag = S_diag.permute(1, 0, 2).contiguous()        # (K, B, m+1)
    # Per-diagonal masks: off the grid, first row (i=0), first column (j=0).
    on_grid = (j_idx >= 0) & (i_idx <= k_idx) & (j_idx <= N)  # (K, m+1)
    row0 = (i_idx == 0).expand(K, m + 1)
    col0 = j_idx == 0
    bval = (-go - (k_idx - 1) * ge).to(torch.int32)      # (K, 1)
    neg_t = torch.full((), neg, dtype=torch.int32, device=dev)

    H1 = torch.full((B, m + 1), neg, dtype=torch.int32, device=dev)
    H1[:, 0] = 0                                         # diagonal 0
    H2 = torch.full_like(H1, neg)
    E1 = torch.full_like(H1, neg)
    F1 = torch.full_like(H1, neg)
    ys = torch.empty((K, B), dtype=torch.int32, device=dev)
    for k in range(K):                                   # diagonal k + 1
        # E: gap consuming target — cell (i, j-1) is diagonal k, index i.
        E = torch.maximum(H1 - go, E1 - ge)
        # F: gap consuming query — cell (i-1, j) is diagonal k, index i-1.
        F = torch.maximum(_shift_right(H1, neg) - go,
                          _shift_right(F1, neg) - ge)
        # Match: cell (i-1, j-1) is diagonal k-1, index i-1.
        H = torch.maximum(_shift_right(H2, neg) + S_diag[k],
                          torch.maximum(E, F))
        b = bval[k]
        H = torch.where(row0[k] | col0[k], b, H)
        E = torch.where(row0[k], b, E)
        F = torch.where(col0[k], b, F)
        H = torch.where(on_grid[k], H, neg_t)
        E = torch.where(on_grid[k], E, neg_t)
        F = torch.where(on_grid[k], F, neg_t)
        ys[k] = H[:, m]
        H2, H1, E1, F1 = H1, H, E, F
    # score[b] = H[m, n_b], on diagonal m + n_b (row m + n_b - 1 of ys).
    rows = (m + lengths - 1).long()
    return ys.gather(0, rows[None, :])[0]


def nw_score_many_device(query: str, targets: List[str],
                         scoring: ScoringMatrix, gap_open: int = 10,
                         gap_extend: int = 1, *, device) -> np.ndarray:
    """Device wavefront counterpart of :func:`nw_score_many`.

    Pads the targets to their longest length rounded up to 32 and runs one
    batched wavefront on ``device``. Useful when ranking a query against
    many candidates with the GPU otherwise idle; the host engine remains
    the pipeline's NW, where the device is busy with inference.
    """
    if not targets:
        return np.zeros(0, np.int32)
    q = scoring.encode(query)
    encoded = [scoring.encode(t) for t in targets]
    N = -(-max(len(e) for e in encoded) // 32) * 32
    batch = np.zeros((len(encoded), N), np.int32)
    lengths = np.zeros(len(encoded), np.int32)
    for i, e in enumerate(encoded):
        batch[i, : len(e)] = e
        lengths[i] = len(e)
    scores = nw_scores_device(q, batch, lengths, scoring.matrix, gap_open,
                              gap_extend, device=device)
    return scores.cpu().numpy().astype(np.int32)
