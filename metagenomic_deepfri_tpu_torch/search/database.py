"""Structure database management.

A copy of ``metagenomic_deepfri_tpu/search/database.py`` (``:28-195``).

API parity with reference ``mDeepFRI/database.py``: the :class:`Database`
dataclass (:35-72) and :func:`build_database` (:75-165) — FoldComp FASTA
extraction + search-index construction with file-existence caching and
``overwrite``. FoldComp extraction shells out to a ``foldcomp`` binary when
present; a plain-FASTA "database" (the built-in engine's native format) is
also accepted directly, which the reference cannot do.
"""

from __future__ import annotations

import gzip
import logging
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from metagenomic_deepfri_tpu_torch.utils import run_command

logger = logging.getLogger(__name__)

ESM_DATABASES = ["highquality_clust30", "esmatlas", "esmatlas_v2023_02"]


@dataclass
class Database:
    """Paths bundle for one structure database (reference database.py:35-72)."""
    foldcomp_db: Path
    sequence_db: Path
    mmseqs_db: Path
    mmseqs_result: Optional[Path] = None

    def __post_init__(self):
        self.foldcomp_db = Path(self.foldcomp_db)
        self.sequence_db = Path(self.sequence_db)
        self.mmseqs_db = Path(self.mmseqs_db)
        if self.mmseqs_result:
            self.mmseqs_result = Path(self.mmseqs_result)
        self.name = self.sequence_db.stem.rsplit(".", 1)[0]


def extract_fasta_foldcomp(foldcomp_db, output_file, threads: int = 1):
    """Extract FASTA from a FoldComp DB via the foldcomp binary (reference
    ``mmseqs.py:748-789``, incl. the ESM header fix)."""
    from metagenomic_deepfri_tpu_torch.search.mmseqs import (foldcomp_available,
                                                       foldcomp_path)

    if not foldcomp_available():
        from metagenomic_deepfri_tpu_torch.search.binaries import tool_install_hint
        raise RuntimeError(
            "A FoldComp (.fcz) database needs the foldcomp binary, which "
            f"is not installed: {tool_install_hint('foldcomp')}.")
    database_name = Path(foldcomp_db).stem
    run_command(
        f"{foldcomp_path()} extract --fasta -t {threads} {foldcomp_db} "
        f"{output_file}")
    if database_name in ESM_DATABASES:
        _fix_esm_headers(output_file)
    gz_path = str(output_file) + ".gz"
    with open(output_file, "rb") as fin, gzip.open(gz_path, "wb") as fout:
        fout.writelines(fin)
    os.remove(output_file)
    return Path(gz_path)


def _fix_esm_headers(fasta_path):
    """Strip the 'ESMFOLD V0 PREDICTION FOR ' header prefix (reference
    ``mmseqs.py:772-776`` does this with sed)."""
    pattern = re.compile(r"^>ESMFOLD V0 PREDICTION FOR (.*)$")
    tmp = str(fasta_path) + ".tmp"
    with open(fasta_path, "r", encoding="utf-8") as fin, \
            open(tmp, "w", encoding="utf-8") as fout:
        for line in fin:
            m = pattern.match(line.rstrip("\n"))
            fout.write(f">{m.group(1)}\n" if m else line)
    os.replace(tmp, fasta_path)


def build_database(input_path, output_path, overwrite: bool = False,
                   threads: int = 1) -> Database:
    """Prepare a database for hierarchical search (reference
    ``database.py:75-165``): extract FASTA (FoldComp) → build search index
    (mmseqs createdb+createindex when the binary exists; otherwise the
    sequence FASTA itself serves the built-in engine)."""
    from metagenomic_deepfri_tpu_torch.search import mmseqs as mm

    logger.info("Building search database from %s", input_path)
    input_path = Path(input_path)
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    if input_path.is_dir():
        # Structure-directory database: a folder of .pdb/.cif[.gz] files
        # (e.g. an AlphaFold dump). Sequences are extracted from the CA
        # records; coordinates are served from the files at predict time
        # (search/pdb.py::extract_calpha_coords). Not supported by the
        # reference (FoldComp/PDB100 only).
        return _build_structure_dir_database(input_path, output_path,
                                             overwrite, threads)

    output_sequences = output_path / Path(input_path.stem + ".fasta.gz")
    unzipped = output_sequences.with_suffix("")
    needs_new_index = False

    with open(input_path, "rb") as f:
        head = f.read(2)
    is_fasta = head[:1] == b">" or head == b"\x1f\x8b"

    if output_sequences.exists() and not overwrite:
        logger.info("Found %s — skipping FASTA extraction.", output_sequences)
    elif is_fasta:
        # Plain/gzipped FASTA input: link it in place as the sequence DB.
        logger.info("Input is FASTA; using it directly as sequence DB.")
        if head == b"\x1f\x8b":
            output_sequences = input_path
        else:
            with open(input_path, "rb") as fin, \
                    gzip.open(output_sequences, "wb") as fout:
                fout.writelines(fin)
        needs_new_index = True
    else:
        logger.info("Extracting FASTA from FoldComp database.")
        output_sequences = extract_fasta_foldcomp(input_path, unzipped,
                                                  threads)
        needs_new_index = True

    mmseqs_db_path = output_path / Path(input_path.stem + ".mmseqsDB")
    if mm.mmseqs_available():
        if overwrite or needs_new_index or not mmseqs_db_path.exists():
            logger.info("Creating and indexing MMseqs2 database.")
            mm._createdb(output_sequences, mmseqs_db_path)
            mm._createindex(mmseqs_db_path, threads)
        else:
            logger.info("Found %s — skipping MMseqs2 DB creation.",
                        mmseqs_db_path)
    else:
        # built-in engine searches the FASTA directly
        mmseqs_db_path = output_sequences

    return Database(foldcomp_db=input_path,
                    sequence_db=output_sequences,
                    mmseqs_db=mmseqs_db_path)


def _build_structure_dir_database(input_path: Path, output_path: Path,
                                  overwrite: bool, threads: int) -> Database:
    """Sequence DB from a directory of structure files (CA-record parse)."""
    import warnings

    from metagenomic_deepfri_tpu_torch.data.structures import (
        get_residues_coordinates, load_structure, read_structure_file,
        structure_id_and_type)
    from metagenomic_deepfri_tpu_torch.search import mmseqs as mm

    output_sequences = output_path / (input_path.name + ".fasta.gz")
    needs_new_index = False
    if output_sequences.exists() and not overwrite:
        logger.info("Found %s — skipping sequence extraction.",
                    output_sequences)
    else:
        n = 0
        with gzip.open(output_sequences, "wt", encoding="utf-8") as out:
            for f in sorted(input_path.iterdir()):
                sid, _ = structure_id_and_type(f.name)
                if sid is None:
                    continue
                try:
                    text, ftype = read_structure_file(f)
                    table = load_structure(text, filetype=ftype)
                    chains = table.chains()
                    if not chains:
                        raise ValueError("no chains")
                    seq, _ = get_residues_coordinates(table, chain=chains[0])
                except (KeyError, ValueError) as e:
                    warnings.warn(f"Skipping structure {f.name}: {e}")
                    continue
                if seq:
                    out.write(f">{sid}\n{seq}\n")
                    n += 1
        logger.info("Extracted %d sequences from %s", n, input_path)
        needs_new_index = True

    mmseqs_db_path = output_path / (input_path.name + ".mmseqsDB")
    if mm.mmseqs_available():
        if overwrite or needs_new_index or not mmseqs_db_path.exists():
            mm._createdb(output_sequences, mmseqs_db_path)
            mm._createindex(mmseqs_db_path, threads)
    else:
        mmseqs_db_path = output_sequences
    return Database(foldcomp_db=input_path,
                    sequence_db=output_sequences,
                    mmseqs_db=mmseqs_db_path)
