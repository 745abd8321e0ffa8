"""MMseqs2 subprocess wrappers (used when an ``mmseqs`` binary is present).

A copy of ``metagenomic_deepfri_tpu/search/mmseqs.py`` (``:24-130``). Same
verb contract as the reference (``mmseqs.py:72-205``): createdb →
createindex → search → convertalis with the 14-column format. The binary is
found through ``MDEEPFRI_MMSEQS_PATH``, the ``get-binaries`` tools directory
or PATH (the port vendors no binaries); :func:`mmseqs_available` gates all
call sites so the built-in engine can take over.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from pathlib import Path

from metagenomic_deepfri_tpu_torch.search.results import (SEARCH_COLUMNS,
                                                          SearchResults)
from metagenomic_deepfri_tpu_torch.utils import run_command

logger = logging.getLogger(__name__)


def _tool_path(name: str, env_var: str) -> str | None:
    """Discovery order: env override → `get-binaries` tools dir → PATH."""
    from metagenomic_deepfri_tpu_torch.search.binaries import tools_dir

    env = os.environ.get(env_var)
    if env and Path(env).exists():
        return env
    fetched = tools_dir() / name
    if fetched.exists() and os.access(fetched, os.X_OK):
        return str(fetched)
    return shutil.which(name)


def mmseqs_path() -> str | None:
    return _tool_path("mmseqs", "MDEEPFRI_MMSEQS_PATH")


def mmseqs_available() -> bool:
    return mmseqs_path() is not None


def foldcomp_path() -> str | None:
    return _tool_path("foldcomp", "MDEEPFRI_FOLDCOMP_PATH")


def foldcomp_available() -> bool:
    return foldcomp_path() is not None


def _createdb(sequences_file, db_path):
    """FASTA → MMseqs2 DB (reference ``mmseqs.py:72-104``)."""
    run_command(
        f"{mmseqs_path()} createdb {sequences_file} {db_path} --dbtype 1")


def _createindex(db_path, threads: int = 1):
    with tempfile.TemporaryDirectory() as tmp_path:
        run_command(
            f"{mmseqs_path()} createindex {db_path} {tmp_path} "
            f"--threads {threads}")


def _search(query_db, target_db, result_db,
            mmseqs_max_eval: float = 1e-4,
            mmseqs_sensitivity: float = 5.7,
            threads: int = 1):
    with tempfile.TemporaryDirectory() as tmp_path:
        run_command(
            f"{mmseqs_path()} search -e {mmseqs_max_eval} "
            f"--threads {threads} -s {mmseqs_sensitivity} "
            f"{query_db} {target_db} {result_db} {tmp_path}")


def _convertalis(query_db, target_db, result_db, output_file,
                 threads: int = 1, columns=None):
    if columns is None:
        columns = SEARCH_COLUMNS
    args = ",".join(columns)
    run_command(
        f"{mmseqs_path()} convertalis {query_db} {target_db} {result_db} "
        f"{output_file} --format-mode 4 --format-output {args} "
        f"--threads {threads}")


def mmseqs_search(query_fasta, target_db_or_fasta,
                  max_eval: float = 1e-4,
                  sensitivity: float = 5.7,
                  index_target: bool = False,
                  tmpdir=None,
                  threads: int = 1) -> SearchResults:
    """End-to-end mmseqs search of a query FASTA against a DB or FASTA
    (reference ``QueryFile.search``, mmseqs.py:668-745)."""
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp_path:
        input_db_path = Path(tmp_path) / "query.mmseqsDB"
        _createdb(query_fasta, input_db_path)

        with open(target_db_or_fasta, "rb") as f:
            first = f.read(2)
        if first[:1] == b">" or first == b"\x1f\x8b":
            target_db_path = Path(str(target_db_or_fasta)).with_suffix(
                ".mmseqsDB")
            if not target_db_path.exists():
                _createdb(target_db_or_fasta, target_db_path)
                if index_target:
                    _createindex(target_db_path, threads)
        else:
            target_db_path = target_db_or_fasta

        result_db = Path(tmp_path) / "search_resultDB"
        _search(input_db_path, target_db_path, result_db, max_eval,
                sensitivity, threads)
        output_file = Path(tmp_path) / "search_results.tsv"
        _convertalis(input_db_path, target_db_path, result_db, output_file,
                     threads)
        return SearchResults.load(str(output_file))
