"""Query FASTA management.

A copy of ``metagenomic_deepfri_tpu/search/query.py`` (``:26-139``).

API parity with reference ``QueryFile`` (``mmseqs.py:486-745``): sequence
loading (length-sorted), filtering, selenocysteine removal, ID-based loading,
removal of already-hit queries, and ``search()``. Search dispatches to the
external MMseqs2 binary when available, otherwise to the built-in native
k-mer engine — same SearchResults contract either way.
"""

from __future__ import annotations

import logging
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

from metagenomic_deepfri_tpu_torch.data.fasta import (iter_fasta,
                                                load_fasta_as_dict,
                                                retrieve_fasta_entries_as_dict,
                                                write_fasta)
from metagenomic_deepfri_tpu_torch.search.results import SearchResults

logger = logging.getLogger(__name__)


class QueryFile:
    """FASTA-backed query set (reference ``mmseqs.py:486-666``)."""

    def __init__(self, filepath) -> None:
        self.filepath = filepath
        self.sequences: Dict[str, str] = {}
        self.filtered_out: Dict[str, str] = {}

    def __repr__(self) -> str:
        return f"QueryFile(filepath={self.filepath})"

    __str__ = __repr__

    def __setitem__(self, key, value):
        self.sequences[key] = value

    def __getitem__(self, key):
        return self.sequences[key]

    def load_ids(self, ids: Iterable[str]) -> None:
        filepath = Path(self.filepath)
        if not filepath.exists():
            raise FileNotFoundError(f"File {self.filepath} not found.")
        self.sequences = retrieve_fasta_entries_as_dict(filepath, ids)

    def load_sequences(self, ids: Optional[List[str]] = None,
                       sort: bool = True) -> None:
        if ids:
            self.load_ids(ids)
        else:
            if not Path(self.filepath).exists():
                raise FileNotFoundError(f"File {self.filepath} not found.")
            self.sequences = dict(iter_fasta(self.filepath))
        if sort:
            self.sequences = dict(
                sorted(self.sequences.items(), key=lambda x: len(x[1])))

    def remove_sequences(self, ids: Iterable[str]) -> None:
        for seq_id in ids:
            self.sequences.pop(seq_id, None)

    def filter_sequences(self,
                         condition: Optional[Callable[[str], bool]] = None):
        if not self.sequences:
            raise ValueError(
                "No sequences loaded. Use load_sequences() or load_ids() "
                "method to load sequences from FASTA file.")
        filtered = self.sequences.copy()
        if condition:
            filtered = {k: v for k, v in filtered.items() if condition(v)}
            for seq_id, seq in self.sequences.items():
                if seq_id not in filtered:
                    self.filtered_out[seq_id] = seq
        self.sequences = filtered
        if not self.sequences:
            raise ValueError("No sequences left after filtering.")

    def remove_selenocysteine(self) -> List[str]:
        """Drop sequences containing 'U' (reference ``mmseqs.py:645-666``)."""
        if not self.sequences:
            raise ValueError(
                "No sequences loaded. Use load_sequences() or load_ids() "
                "before removing selenocysteine sequences.")
        removed = [sid for sid, seq in self.sequences.items() if "U" in seq]
        for sid in removed:
            self.filtered_out[sid] = self.sequences.pop(sid)
        return removed

    def search(self,
               database_path,
               eval: float = 1e-4,
               mmseqs_sensitivity: float = 5.7,
               index_target: bool = False,
               tmpdir=None,
               threads: int = 1) -> SearchResults:
        """Search loaded sequences against a database FASTA / MMseqs2 DB.

        Engine dispatch: external mmseqs when on PATH (reference behaviour),
        otherwise the built-in k-mer engine (``search/engine.py``). The
        result carries query-FASTA and database provenance either way.
        """
        if not 1.0 <= mmseqs_sensitivity <= 7.5:
            raise ValueError(
                "MMseqs2 sensitivity value should be between 1.0 and 7.5.")
        from metagenomic_deepfri_tpu_torch.search import mmseqs as mm

        if mm.mmseqs_available():
            with tempfile.TemporaryDirectory(dir=tmpdir) as tmp_path:
                if self.sequences:
                    fasta_path = Path(tmp_path) / "filtered_query.fa"
                    write_fasta(fasta_path, self.sequences)
                else:
                    fasta_path = self.filepath
                result = mm.mmseqs_search(
                    fasta_path, database_path,
                    max_eval=eval, sensitivity=mmseqs_sensitivity,
                    index_target=index_target, tmpdir=tmpdir,
                    threads=threads)
                result.query_fasta = str(Path(self.filepath).resolve())
                result.database = str(database_path)
                return result

        logger.info("mmseqs binary not found — using built-in k-mer search "
                    "engine.")
        from metagenomic_deepfri_tpu_torch.search.engine import builtin_search

        queries = self.sequences or load_fasta_as_dict(self.filepath)
        # database_path must be a FASTA (possibly gzipped) for the built-in
        # engine; MMseqs2 binary DBs require the mmseqs binary.
        targets = load_fasta_as_dict(database_path)
        return builtin_search(
            queries, targets, max_eval=eval, threads=threads,
            query_fasta=str(Path(self.filepath).resolve()),
            database=str(database_path))
