"""Alignment-result containers and batch drivers.

A copy of ``metagenomic_deepfri_tpu/align/pairwise.py`` (``:30-193``) over
the port's NW binding (:mod:`..ops.nw`).

API parity with reference ``mDeepFRI/alignment.py``: ``insert_gaps`` (:38-62),
``AlignmentResult`` (:65-150), ``best_hit_database`` (:163-193),
``align_pairwise`` (:196-220), ``pairwise_against_database`` (:223-250),
``align_mmseqs_results`` (:266-320) — with pyOpal replaced by the in-repo NW
engine and the process-pool fan-out replaced by the native engine's OpenMP
batch scoring plus a thread pool for tracebacks (no fork overhead, no
per-worker FASTA reload).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from metagenomic_deepfri_tpu_torch.align.matrices import \
    resolve_scoring_matrix
from metagenomic_deepfri_tpu_torch.data.fasta import (
    load_fasta_as_dict, retrieve_fasta_entries_as_dict)
from metagenomic_deepfri_tpu_torch.ops.nw import (alignment_stats, nw_align,
                                            nw_score_many)

logger = logging.getLogger(__name__)


def insert_gaps(sequence: str, reference: str,
                alignment_string: str) -> Tuple[str, str]:
    """Insert '-' gaps per the M/I/D alignment string.

    Exact reference semantics (``alignment.py:38-62``): 'I' inserts a gap
    into the query at that alignment column, 'D' into the target.
    """
    seq_out: List[str] = []
    ref_out: List[str] = []
    qi = ti = 0
    for a in alignment_string:
        if a == "I":
            seq_out.append("-")
            ref_out.append(reference[ti])
            ti += 1
        elif a == "D":
            seq_out.append(sequence[qi])
            ref_out.append("-")
            qi += 1
        else:
            seq_out.append(sequence[qi])
            ref_out.append(reference[ti])
            qi += 1
            ti += 1
    # trailing unconsumed residues (possible with partial alignment strings)
    seq_out.append(sequence[qi:])
    ref_out.append(reference[ti:])
    return "".join(seq_out), "".join(ref_out)


class AlignmentResult:
    """Pairwise alignment container (reference ``alignment.py:65-150``)."""

    def __init__(self,
                 query_name: str = "",
                 query_sequence: str = "",
                 target_name: str = "",
                 target_sequence: str = "",
                 alignment: str = "",
                 query_identity: Optional[float] = None,
                 query_coverage: Optional[float] = None,
                 target_coverage: Optional[float] = None,
                 db_name: Optional[str] = None,
                 coords: Optional[np.ndarray] = None):
        self.query_name = query_name
        self.query_sequence = query_sequence
        self.target_name = target_name
        self.target_sequence = target_sequence
        self.alignment = alignment
        self.query_identity = query_identity
        self.query_coverage = query_coverage
        self.target_coverage = target_coverage
        self.insert_gaps()
        self.db_name = db_name
        self.coords = coords

    def __repr__(self):
        return (f"AlignmentResult(query_name={self.query_name}, "
                f"target_name={self.target_name}, "
                f"query_identity={self.query_identity}, "
                f"query_coverage={self.query_coverage})")

    __str__ = __repr__

    def insert_gaps(self):
        self.gapped_sequence, self.gapped_target = insert_gaps(
            self.query_sequence, self.target_sequence, self.alignment)


def _upper(seq: Optional[str]) -> Optional[str]:
    return seq.upper() if seq else seq


def best_hit_database(query: str,
                      target_sequences: Dict[str, str],
                      gap_open: int = 10,
                      gap_extend: int = 1,
                      scoring_matrix: str = "auto",
                      threads: int = 1) -> Tuple[str, str]:
    """Best-scoring target for a query (score-mode NW over the partial DB)."""
    query = _upper(query)
    ids = list(target_sequences.keys())
    seqs = [_upper(target_sequences[i]) for i in ids]
    scoring = resolve_scoring_matrix(scoring_matrix)
    scores = nw_score_many(query, seqs, scoring, gap_open, gap_extend,
                           threads=threads)
    best = int(np.argmax(scores))
    return ids[best], seqs[best]


def align_pairwise(query: str,
                   target: str,
                   gap_open: int = 10,
                   gap_extend: int = 1,
                   scoring_matrix: str = "auto"):
    """Full NW alignment → (alignment string, identity, qcov, tcov)."""
    query = _upper(query)
    target = _upper(target)
    scoring = resolve_scoring_matrix(scoring_matrix)
    _, alignment = nw_align(query, target, scoring, gap_open, gap_extend)
    identity, qcov, tcov = alignment_stats(query, target, alignment)
    return alignment, identity, qcov, tcov


def pairwise_against_database(query_id: str,
                              query_sequence: str,
                              target_sequences: Dict[str, str],
                              gap_open: int = 10,
                              gap_extend: int = 1,
                              scoring_matrix: str = "auto") -> AlignmentResult:
    """Pick the best hit then produce the full alignment (reference
    ``alignment.py:223-250``)."""
    query_sequence = _upper(query_sequence)
    best_idx, best_target = best_hit_database(
        query_sequence, target_sequences, gap_open, gap_extend,
        scoring_matrix)
    alignment, identity, qcov, tcov = align_pairwise(
        query_sequence, best_target, gap_open, gap_extend, scoring_matrix)
    return AlignmentResult(query_id, query_sequence, best_idx, best_target,
                           alignment, identity, query_coverage=qcov,
                           target_coverage=tcov)


def align_mmseqs_results(best_matches_filepath,
                         sequence_db,
                         alignment_gap_open: int = 10,
                         alignment_gap_extend: int = 1,
                         threads: int = 1,
                         scoring_matrix: str = "auto") -> List[AlignmentResult]:
    """Re-align every query against its top-k search hits.

    Reference flow (``alignment.py:266-320``): load best-match table, fetch
    query + target sequences, build per-query partial databases, fan out.
    UniProt ``sp|ID|NAME`` headers are re-keyed by their accession
    (reference ``alignment.py:284-287``).
    """
    from metagenomic_deepfri_tpu_torch.search.results import SearchResults

    best_matches = SearchResults.load(best_matches_filepath)
    if len(best_matches) == 0:
        return []

    query_dict = load_fasta_as_dict(best_matches.query_fasta)
    query_dict = {k: _upper(v) for k, v in query_dict.items()}
    for qid in list(query_dict.keys()):
        if "|" in qid:
            query_dict[qid.split("|")[1]] = query_dict.pop(qid)

    unique_queries = best_matches.targets_by_query()
    target_ids = best_matches.get_targets()
    target_seqs = retrieve_fasta_entries_as_dict(sequence_db, target_ids)
    target_seqs = {k: _upper(v) for k, v in target_seqs.items()}

    def align_one(qid):
        partial_db = {t: target_seqs[t] for t in unique_queries[qid]}
        return pairwise_against_database(
            qid, query_dict[qid], partial_db,
            gap_open=alignment_gap_open, gap_extend=alignment_gap_extend,
            scoring_matrix=scoring_matrix)

    qids = list(unique_queries.keys())
    with ThreadPoolExecutor(max_workers=max(threads, 1)) as pool:
        alignments = list(pool.map(align_one, qids))
    return alignments
