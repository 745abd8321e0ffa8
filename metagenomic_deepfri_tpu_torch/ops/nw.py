"""Needleman–Wunsch alignment on the host: ctypes binding to the native
engine, and a numpy oracle.

A copy of the host part of ``metagenomic_deepfri_tpu/ops/nw.py`` (``:1-229``):
:func:`nw_align`, :func:`nw_score_many`, :func:`alignment_stats` and the
numpy Gotoh ``_nw_align_python``, used when ``force_python=True`` (the parity
oracle of the tests). The native library is the JAX package's ``nw.cpp``,
built by :mod:`..native.build`; unlike the JAX package, a failed build raises
:class:`..native.build.NativeBuildError` instead of falling back to numpy.
The JAX-only device wavefront (``nw_score_many_device``) is not ported.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, List, Tuple

import numpy as np

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
