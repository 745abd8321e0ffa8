"""Resumable prediction checkpoints.

Counterpart of ``metagenomic_deepfri_tpu/checkpoint.py``: parts written by
either package load in the other, and so does the JAX package's
``overflow.log``.

The reference has file-existence caching for database artifacts but NO
mid-inference resume — a killed prediction loop restarts from scratch
(SURVEY.md §5; reference ``database.py:139-159`` vs nothing for the loop).
Here per-protein scores stream to disk as the engine drains batches, so an
interrupted catalogue annotation resumes where it stopped:

- scores are flushed as numbered ``part-NNNN.npz`` files (one array per
  ``{net}|{mode}|{qid}`` key) — append-only, crash-safe (a truncated part is
  detected by numpy and skipped with a warning);
- on restart, :meth:`PredictionCheckpoint.completed` reports which queries
  already have every requested mode for a network, and the pipeline excludes
  them from the work list;
- the port's engine always returns dense score rows, so it writes no
  ``overflow.log``; one left by an earlier run (the JAX package's top-k
  fetch, or an older port's) marks with ``OVER`` the rows that were still
  truncated when it stopped. Their vectors are dropped on every load (the
  log is never rewritten), so :meth:`~PredictionCheckpoint.completed`
  leaves those queries out and the resumed run recomputes them in its main
  stream;
- the checkpoint directory is removed after ``results.tsv`` is written
  (unless ``keep=True``).
"""

from __future__ import annotations

import logging
import pathlib
import shutil
from typing import Dict, Iterable, List, Set

import numpy as np

logger = logging.getLogger(__name__)

_SEP = "|"


class PredictionCheckpoint:
    """Streaming score store under ``<output>/checkpoints``."""

    def __init__(self, directory):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._scores: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        self._n_parts = 0
        self._load_existing()

    # -- persistence ---------------------------------------------------------

    def _load_existing(self) -> None:
        parts = sorted(self.dir.glob("part-*.npz"))
        for part in parts:
            try:
                with np.load(part) as npz:
                    for key in npz.files:
                        net, mode, qid = key.split(_SEP, 2)
                        self._scores.setdefault(net, {}).setdefault(
                            mode, {})[qid] = npz[key]
            except Exception as e:  # truncated part from a crash mid-write
                logger.warning("Skipping unreadable checkpoint part %s (%s)",
                               part, e)
        self._n_parts = len(parts)
        if parts:
            n = sum(len(q) for net in self._scores.values()
                    for q in net.values())
            logger.info("Resumed prediction checkpoint: %d score vectors "
                        "from %d parts.", n, len(parts))
        self._drop_pending_overflow()

    def _drop_pending_overflow(self) -> None:
        """Drop the score vectors that an earlier run's ``overflow.log``
        still marks ``OVER`` (a ``DONE`` line strikes a mark out; a
        truncated last line is ignored)."""
        log = self.dir / "overflow.log"
        if not log.exists():
            return
        pending: Set[tuple] = set()
        for line in log.read_text(encoding="utf-8").splitlines():
            fields = line.split(_SEP)
            if len(fields) != 4:  # truncated trailing line from a crash
                continue
            op, net, mode, qid = fields
            if op == "OVER":
                pending.add((net, mode, qid))
            elif op == "DONE":
                pending.discard((net, mode, qid))
        dropped = sum(
            self._scores.get(net, {}).get(mode, {}).pop(qid, None) is not None
            for net, mode, qid in pending)
        if pending:
            logger.info("Checkpoint overflow.log: dropped %d truncated score "
                        "vector(s) of %d pending mark(s); those queries are "
                        "recomputed.", dropped, len(pending))

    def add(self, net: str, partial: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Flush one engine result group ({mode: {qid: scores}}) to disk."""
        payload = {}
        for mode, per_q in partial.items():
            store = self._scores.setdefault(net, {}).setdefault(mode, {})
            for qid, scores in per_q.items():
                store[qid] = scores
                payload[f"{net}{_SEP}{mode}{_SEP}{qid}"] = scores
        if not payload:
            return
        part = self.dir / f"part-{self._n_parts:04d}.npz"
        # keep the .npz suffix on the temp name (np.savez appends it
        # otherwise); the leading dot keeps it out of the part glob
        tmp = self.dir / f".tmp-part-{self._n_parts:04d}.npz"
        np.savez(tmp, **payload)
        tmp.rename(part)  # atomic publish
        self._n_parts += 1

    # -- queries -------------------------------------------------------------

    def completed(self, net: str, modes: Iterable[str]) -> Set[str]:
        """Queries that already have scores for EVERY requested mode."""
        modes = list(modes)
        if not modes:
            return set()
        per_mode: List[Set[str]] = []
        for mode in modes:
            per_mode.append(set(self._scores.get(net, {}).get(mode, {})))
        done = set.intersection(*per_mode) if per_mode else set()
        return done

    def scores(self, net: str) -> Dict[str, Dict[str, np.ndarray]]:
        """{mode: {qid: scores}} accumulated so far for a network."""
        return self._scores.get(net, {})

    def merge_into(self, net: str,
                   out: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Fill engine results with checkpointed scores (engine wins ties)."""
        for mode, per_q in self.scores(net).items():
            target = out.setdefault(mode, {})
            for qid, scores in per_q.items():
                target.setdefault(qid, scores)

    def remove(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
