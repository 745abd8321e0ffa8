"""Search result tables.

A copy of ``metagenomic_deepfri_tpu/search/results.py``: files saved by
either package load in the other.

Replaces the reference's ``MMseqsResult`` recarray subclass (reference
``mmseqs.py:208-483``) with a structured-array wrapper exposing the same
operations — filtering (qcov/tcov/fident/bits), top-k best-match selection by
(bits, fident), TSV/NPZ persistence carrying the query-FASTA and database
provenance columns — but vectorised (the reference's per-query ThreadPool
top-k, ``mmseqs.py:341-372``, becomes a single lexsort + group slice).
"""

from __future__ import annotations

import csv
from typing import List

import numpy as np

# convertalis column contract (reference mmseqs.py:197-201)
SEARCH_COLUMNS = [
    "query", "target", "fident", "alnlen", "mismatch", "gapopen",
    "qstart", "qend", "tstart", "tend", "qcov", "tcov", "evalue", "bits",
]

_FLOAT_COLS = {"fident", "qcov", "tcov", "evalue", "bits"}
_INT_COLS = {"alnlen", "mismatch", "gapopen", "qstart", "qend", "tstart",
             "tend"}


def _dtype(max_id_len: int = 256):
    fields = []
    for col in SEARCH_COLUMNS:
        if col in ("query", "target"):
            fields.append((col, f"U{max_id_len}"))
        elif col in _FLOAT_COLS:
            fields.append((col, "f8"))
        else:
            fields.append((col, "i8"))
    return np.dtype(fields)


class SearchResults:
    """Tabular homology-search results with provenance."""

    def __init__(self, rows, query_fasta=None, database=None):
        if isinstance(rows, np.ndarray) and rows.dtype.names:
            self.table = rows
        else:
            rows = list(rows)
            table = np.zeros(len(rows), dtype=_dtype())
            for i, row in enumerate(rows):
                for col in SEARCH_COLUMNS:
                    table[col][i] = row[col] if isinstance(row, dict) \
                        else row[SEARCH_COLUMNS.index(col)]
            self.table = table
        self.query_fasta = str(query_fasta) if query_fasta else None
        self.database = str(database) if database else None

    # -- container protocol --------------------------------------------------

    def __len__(self):
        return len(self.table)

    def __getitem__(self, key):
        return self.table[key]

    @property
    def size(self):
        return self.table.size

    @property
    def columns(self) -> np.ndarray:
        return np.array(self.table.dtype.names)

    # -- filtering / selection ------------------------------------------------

    def apply_mask(self, mask: np.ndarray) -> "SearchResults":
        return SearchResults(self.table[mask], self.query_fasta,
                             self.database)

    def apply_filters(self, min_cov: float = 0.0, min_ident: float = 0.0,
                      min_bits: float = 0) -> "SearchResults":
        """qcov AND tcov ≥ min_cov, fident ≥ min_ident, bits ≥ min_bits
        (reference ``mmseqs.py:315-339``)."""
        t = self.table
        mask = ((t["qcov"] >= min_cov) & (t["tcov"] >= min_cov)
                & (t["fident"] >= min_ident) & (t["bits"] >= min_bits))
        return self.apply_mask(mask)

    def find_best_matches(self, k: int = 5,
                          threads: int = 1) -> "SearchResults":
        """Top-k hits per query by (bits, fident) descending (reference
        ``mmseqs.py:341-372``). ``threads`` kept for API parity; the
        vectorised lexsort needs none."""
        del threads
        t = self.table
        if t.size == 0:
            return SearchResults(t, self.query_fasta, self.database)
        order = np.lexsort((t["fident"], t["bits"], t["query"]))
        sorted_t = t[order][::-1]  # descending within reversed query order
        # stable group-wise selection over contiguous query groups
        keep = np.zeros(len(sorted_t), bool)
        change = np.nonzero(
            sorted_t["query"][1:] != sorted_t["query"][:-1])[0] + 1
        bounds = np.concatenate([[0], change, [len(sorted_t)]])
        for s, e in zip(bounds[:-1], bounds[1:]):
            keep[s:min(s + k, e)] = True
        return SearchResults(sorted_t[keep], self.query_fasta, self.database)

    def get_queries(self) -> np.ndarray:
        return np.unique(self.table["query"])

    def get_targets(self) -> np.ndarray:
        return np.unique(self.table["target"])

    def get_query_targets(self, query: str) -> np.ndarray:
        return np.unique(
            self.table[self.table["query"] == query]["target"])

    def targets_by_query(self) -> dict:
        """{query: unique targets} for ALL queries in one sorted pass.

        ``get_query_targets`` scans the whole table per call; mapping a
        10k-query result set that way is O(queries × rows) — measured ~15 s
        on a 10k-seq run and quadratic beyond. This is O(rows log rows).
        """
        if len(self.table) == 0:
            return {}
        order = np.argsort(self.table, order=("query", "target"))
        q = self.table["query"][order]
        t = self.table["target"][order]
        out: dict = {}
        starts = np.concatenate(
            [[0], np.nonzero(q[1:] != q[:-1])[0] + 1, [len(q)]])
        for s, e in zip(starts[:-1], starts[1:]):
            grp = t[s:e]
            out[q[s]] = grp[np.concatenate(
                [[True], grp[1:] != grp[:-1]])]
        return out

    # -- persistence -----------------------------------------------------------

    def save(self, filepath, filetype: str = "tsv"):
        """TSV (with provenance columns) or compressed NPZ
        (reference ``mmseqs.py:270-313``)."""
        if filetype == "tsv":
            with open(filepath, "w", newline="", encoding="utf-8") as f:
                writer = csv.writer(f, delimiter="\t")
                header = list(SEARCH_COLUMNS)
                extra = []
                if self.query_fasta:
                    header.append("query_file")
                    extra.append(self.query_fasta)
                if self.database:
                    header.append("database_file")
                    extra.append(self.database)
                writer.writerow(header)
                for row in self.table:
                    writer.writerow([row[c] for c in SEARCH_COLUMNS] + extra)
        elif filetype == "npz":
            np.savez_compressed(filepath, table=self.table,
                                query_fasta=self.query_fasta or "",
                                database=self.database or "")
        else:
            raise ValueError("File type should be 'tsv' or 'npz'.")

    @classmethod
    def load(cls, filepath) -> "SearchResults":
        """Load a TSV or NPZ produced by :meth:`save` (reference
        ``from_mmseqs_result``/``from_best_matches``, mmseqs.py:423-483)."""
        filepath = str(filepath)
        if filepath.endswith(".npz"):
            data = np.load(filepath, allow_pickle=False)
            return cls(data["table"],
                       str(data["query_fasta"]) or None,
                       str(data["database"]) or None)
        rows: List[dict] = []
        query_fasta = database = None
        with open(filepath, "r", encoding="utf-8") as f:
            reader = csv.reader(f, delimiter="\t")
            header = next(reader, None)
            if header is None:
                return cls([], None, None)
            idx = {name: i for i, name in enumerate(header)}
            for row in reader:
                if not row:
                    continue
                rows.append({c: _coerce(c, row[idx[c]]) for c in
                             SEARCH_COLUMNS if c in idx})
                if "query_file" in idx:
                    query_fasta = row[idx["query_file"]]
                if "database_file" in idx:
                    database = row[idx["database_file"]]
        return cls(rows, query_fasta, database)

    # reference-compatible aliases
    from_mmseqs_result = load
    from_best_matches = load


def _coerce(col: str, val: str):
    if col in _FLOAT_COLS:
        return float(val)
    if col in _INT_COLS:
        return int(float(val))
    return val
