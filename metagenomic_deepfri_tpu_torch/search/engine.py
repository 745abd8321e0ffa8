"""Built-in homology search engine (mmseqs-free fallback).

A copy of ``metagenomic_deepfri_tpu/search/engine.py``: the k-mer prefilter
(the JAX package's ``kmersearch.cpp``, built by :mod:`..native.build`) and
the NW rescoring give the same rows as the JAX ``builtin_search``.

Pipeline-compatible replacement for the external MMseqs2 search when its
binary is unavailable (the reference hard-depends on a vendored binary,
reference ``mmseqs.py:45``, ``setup.py:115-135``). Two stages:

1. k-mer prefilter: shared-k-mer counting against an inverted index over the
   target database (``native/kmersearch.cpp``, OpenMP).
2. rescoring: Gotoh global alignment of each query against its candidate set
   (``native/nw.cpp``), traceback-derived statistics filling the same
   14-column result contract as ``mmseqs convertalis``
   (reference ``mmseqs.py:197-201``).

Bit scores use the standard gapped BLOSUM62 Karlin–Altschul parameters
(λ=0.267, K=0.041); E-value = K·m·N·e^(−λS) with N the database residue
count. Sensitivity differs from MMseqs2 (global-alignment rescoring, no
profile stages) but the pipeline's downstream thresholds (coverage ≥0.9,
identity ≥0.5 — reference ``cli.py:141-161``) target exactly the
near-full-length regime where global alignment is appropriate. Measured on
a known-homology benchmark (``tests/test_search_recall.py``: 200 targets,
point-mutated queries spanning 35–95% identity, NW oracle at the pipeline
thresholds): recall 0.98, precision 1.00; the rare misses are short
(<100 aa) sequences near the 50%-identity boundary where fewer than
``min_kmer_hits`` 5-mers survive mutation.
"""

from __future__ import annotations

import ctypes
import logging
import math
from typing import Dict, Optional

import numpy as np

from metagenomic_deepfri_tpu_torch import profiling
from metagenomic_deepfri_tpu_torch.align.matrices import ScoringMatrix
from metagenomic_deepfri_tpu_torch.native import build as native
from metagenomic_deepfri_tpu_torch.ops.nw import nw_align, nw_score_many
from metagenomic_deepfri_tpu_torch.ops.nw import alignment_stats
from metagenomic_deepfri_tpu_torch.search.results import SearchResults

logger = logging.getLogger(__name__)

# Karlin–Altschul gapped BLOSUM62 parameters (NCBI BLAST defaults).
KA_LAMBDA = 0.267
KA_K = 0.041

_KMER = 5
_PREFILTER_ALPHABET = "ARNDCQEGHILKMFPSTWYV"  # 20 standard residues

def _encode20(seq: str) -> np.ndarray:
    lut = _encode20.lut
    raw = np.frombuffer(seq.upper().encode("ascii", "replace"),
                        dtype=np.uint8)
    return lut[raw].astype(np.int32)


_encode20.lut = np.full(256, -1, dtype=np.int32)
for _i, _c in enumerate(_PREFILTER_ALPHABET):
    _encode20.lut[ord(_c)] = _i


def _concat(encoded):
    offsets = np.zeros(len(encoded) + 1, np.int64)
    offsets[1:] = np.cumsum([len(e) for e in encoded])
    concat = (np.concatenate(encoded) if encoded
              else np.zeros(0, np.int32)).astype(np.int32)
    return concat, offsets


def builtin_search(queries: Dict[str, str],
                   targets: Dict[str, str],
                   max_eval: float = 1e-4,
                   max_candidates: int = 64,
                   min_kmer_hits: int = 2,
                   top_hits: int = 30,
                   gap_open: int = 11,
                   gap_extend: int = 1,
                   threads: int = 1,
                   query_fasta: Optional[str] = None,
                   database: Optional[str] = None) -> SearchResults:
    """Search ``queries`` against ``targets``; returns a SearchResults table.

    While spans are recorded: one ``kmer/prefilter`` for the prefilter of
    every query, then for each query with candidates ``nw/rescore`` (their
    NW scores) and ``nw/traceback`` (the alignments of its top hits that
    pass ``max_eval``, counter ``alignments``; counter ``gated``, the top
    hits cut by their e-value before any alignment)."""
    q_ids = list(queries)
    t_ids = list(targets)
    if not q_ids or not t_ids:
        return SearchResults([], query_fasta, database)

    lib = native.load("kmersearch")
    with profiling.span("kmer/prefilter"):
        q_enc = [_encode20(queries[q]) for q in q_ids]
        t_enc = [_encode20(targets[t]) for t in t_ids]
        q_cat, q_off = _concat(q_enc)
        t_cat, t_off = _concat(t_enc)

        cand = np.full((len(q_ids), max_candidates), -1, np.int32)
        counts = np.zeros((len(q_ids), max_candidates), np.int32)
        lib.kmer_candidates(
            t_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            t_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(t_ids),
            q_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            q_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(q_ids),
            _KMER, len(_PREFILTER_ALPHABET), max_candidates, min_kmer_hits,
            threads,
            cand.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    scoring = ScoringMatrix.from_name("BLOSUM62")
    db_residues = float(sum(len(s) for s in targets.values()))
    rows = []
    for qi, qid in enumerate(q_ids):
        cand_ids = [int(c) for c in cand[qi] if c >= 0]
        if not cand_ids:
            continue
        qseq = queries[qid].upper()
        cand_seqs = [targets[t_ids[c]].upper() for c in cand_ids]
        with profiling.span("nw/rescore"):
            scores = nw_score_many(qseq, cand_seqs, scoring, gap_open,
                                   gap_extend, threads=threads)
        order = np.argsort(scores)[::-1][:top_hits]
        # The e-value falls as the score rises, and ``order`` is by
        # descending score, so the hits that pass ``max_eval`` are a prefix
        # of it: align only those. ``nw_align`` returns the score that
        # ``nw_score_many`` gave.
        kept = []
        for rank in order:
            bits = (KA_LAMBDA * int(scores[rank]) - math.log(KA_K)) \
                / math.log(2.0)
            evalue = len(qseq) * db_residues * math.pow(2.0, -bits) \
                if bits > 0 else float("inf")
            if evalue > max_eval:
                break
            kept.append((int(rank), bits, evalue))
        with profiling.span("nw/traceback", alignments=len(kept),
                            gated=len(order) - len(kept)):
            for rank, bits, evalue in kept:
                tid = t_ids[cand_ids[rank]]
                tseq = cand_seqs[rank]
                _, aln = nw_align(qseq, tseq, scoring, gap_open, gap_extend)
                ident, qcov, tcov = alignment_stats(qseq, tseq, aln)
                matches = round(ident * len(aln))
                gapopens = _count_gap_opens(aln)
                mismatches = sum(1 for a in aln if a == "M") - matches
                rows.append({
                    "query": qid, "target": tid, "fident": round(ident, 4),
                    "alnlen": len(aln), "mismatch": mismatches,
                    "gapopen": gapopens,
                    "qstart": 1, "qend": len(qseq),
                    "tstart": 1, "tend": len(tseq),
                    "qcov": round(qcov, 4), "tcov": round(tcov, 4),
                    "evalue": evalue, "bits": round(bits, 1),
                })
    return SearchResults(rows, query_fasta, database)


def _count_gap_opens(alignment: str) -> int:
    opens = 0
    prev = "M"
    for a in alignment:
        if a in ("I", "D") and prev != a:
            opens += 1
        prev = a
    return opens
