"""PDB100 integration and C-alpha coordinate extraction.

A copy of ``metagenomic_deepfri_tpu/search/pdb.py``: PDB100 over RCSB,
FoldComp through a lazily imported ``foldcomp``, and the structure
directory.

API parity with reference ``mDeepFRI/pdb.py``: ``create_pdb_mmseqs`` (:23-69,
PDB100 FASTA download + search-DB build, cached), ``get_pdb_structure``
(:72-92, RCSB mmCIF fetch), ``get_pdb_seq_coords`` (:97-127) and
``extract_calpha_coords`` (:130-162) dispatching between HTTP-fetched
experimental structures and FoldComp-decompressed predicted structures.

Network and FoldComp access are gated with clear errors so offline
deployments degrade to sequence-only (CNN) predictions rather than
tracebacks.
"""

from __future__ import annotations

import logging
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from metagenomic_deepfri_tpu_torch.data.structures import (
    extract_residues_coordinates)
from metagenomic_deepfri_tpu_torch.search.database import Database
from metagenomic_deepfri_tpu_torch.utils import download_file

logger = logging.getLogger(__name__)

PDB100_URL = "https://wwwuser.gwdg.de/~compbiol/colabfold/pdb100_230517.fasta.gz"
RCSB_CIF_URL = "https://files.rcsb.org/view/{pdb_id}.cif"


def default_cache_dir() -> Path:
    path = Path.home() / ".cache" / "mdeepfri_tpu"
    path.mkdir(parents=True, exist_ok=True)
    return path


def create_pdb_mmseqs(threads: int = 1,
                      cache_dir: Optional[Path] = None) -> Database:
    """Download PDB100 (cached) and prepare it as a search database."""
    from metagenomic_deepfri_tpu_torch.search import mmseqs as mm

    cache = Path(cache_dir) if cache_dir else default_cache_dir()
    compressed = cache / "pdb100_230517.fasta.gz"
    if not compressed.exists():
        logger.info("Downloading PDB100 FASTA from %s", PDB100_URL)
        download_file(PDB100_URL, compressed)

    pdb100_db = cache / "pdb100_230517.mmseqsDB"
    if mm.mmseqs_available():
        if not pdb100_db.exists():
            mm._createdb(compressed, pdb100_db)
            mm._createindex(pdb100_db, threads=threads)
    else:
        pdb100_db = compressed  # built-in engine searches the FASTA

    return Database(foldcomp_db=cache / "pdb100_230517",
                    sequence_db=compressed,
                    mmseqs_db=pdb100_db)


def get_pdb_structure(pdb_id: str,
                      save_directory: Optional[Path] = None) -> str:
    """Fetch an mmCIF from RCSB (reference ``pdb.py:72-92``)."""
    import urllib.request

    pdb_id = pdb_id.lower()
    url = RCSB_CIF_URL.format(pdb_id=pdb_id)
    req = urllib.request.Request(url, headers={"User-Agent": "mdeepfri-tpu"})
    with urllib.request.urlopen(req) as resp:
        structure = resp.read().decode("utf-8", "replace")
    if save_directory:
        with open(Path(save_directory) / f"{pdb_id}.cif", "w",
                  encoding="utf-8") as f:
            f.write(structure)
    return structure


def get_pdb_seq_coords(
        pdb_id_chain: str,
        query_name: str,
        save_directory: Optional[Path] = None
) -> Tuple[Optional[str], Optional[np.ndarray]]:
    """Sequence + CA coords for one PDB chain; errors are warnings and yield
    (None, None) so one broken structure never kills the batch (reference
    ``pdb.py:97-127``)."""
    pdb_id, chain = pdb_id_chain.split("_")
    try:
        structure = get_pdb_structure(pdb_id, save_directory=save_directory)
        sequence, coords = extract_residues_coordinates(
            structure, chain=chain, filetype="mmcif")
    except (KeyError, ValueError, OSError) as e:
        warnings.warn(
            f"Error extracting residues and coordinates for PDB ID "
            f"{pdb_id.upper()}[Chain {chain}] - {e}; "
            f"{query_name} alignment skipped.")
        return None, None
    return sequence, coords


def get_foldcomp_structures(ids: List[str], database_path) -> List[str]:
    """Decompress structures by ID from a FoldComp DB.

    Uses the ``foldcomp`` Python bindings when importable (reference
    ``bio_utils.py:328-345``); otherwise raises — predicted-structure DBs
    without foldcomp degrade to CNN-only annotation upstream.
    """
    try:
        import foldcomp  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "FoldComp python bindings are not installed; cannot decompress "
            "structures from a FoldComp database.") from e
    structures = []
    with foldcomp.open(database_path, ids=ids) as db:  # pragma: no cover
        for _, pdb in db:
            structures.append(pdb)
    return structures


def foldcomp_sniff_suffix(idx: str, database_path) -> Optional[str]:
    """Determine whether DB entries carry a '.pdb' suffix (reference
    ``bio_utils.py:305-325``)."""
    try:
        if get_foldcomp_structures([idx], database_path):
            return None
    except (RuntimeError, Exception):  # noqa: BLE001 - bindings raise varied
        pass
    try:
        if get_foldcomp_structures([idx + ".pdb"], database_path):
            return ".pdb"
    except Exception:  # noqa: BLE001
        pass
    return None


def extract_calpha_coords(db: Database,
                          target_ids: List[str],
                          query_ids: List[str],
                          save_directory: Optional[Path] = None,
                          threads: int = 1) -> List[Optional[np.ndarray]]:
    """CA coordinates for each target hit (reference ``pdb.py:130-162``).

    PDB100 targets are fetched from RCSB concurrently (thread pool — the
    reference uses a process pool for what is pure network I/O); FoldComp
    targets are batch-decompressed and parsed.
    """
    if "pdb100" in db.name:
        def fetch(args):
            tid, qid = args
            return get_pdb_seq_coords(tid, qid,
                                      save_directory=save_directory)

        with ThreadPoolExecutor(max_workers=max(threads, 1)) as pool:
            results = list(pool.map(fetch, zip(target_ids, query_ids)))
        return [coord for _, coord in results]

    if Path(db.foldcomp_db).is_dir():
        return _extract_coords_from_dir(Path(db.foldcomp_db), target_ids,
                                        save_directory=save_directory)

    suffix = foldcomp_sniff_suffix(target_ids[0], db.foldcomp_db)
    if suffix:
        target_ids = [f"{t}{suffix}" for t in target_ids]
    coords: List[Optional[np.ndarray]] = []
    structures = get_foldcomp_structures(target_ids, db.foldcomp_db)
    for idx, struct in zip(target_ids, structures):
        try:
            _, coord = extract_residues_coordinates(struct, filetype="pdb")
        except (KeyError, ValueError) as e:
            warnings.warn(f"Error parsing FoldComp structure {idx}: {e}")
            coord = None
        coords.append(coord)
        if save_directory:
            with open(Path(save_directory) / f"{idx}.pdb", "w",
                      encoding="utf-8") as f:
                f.write(struct)
    return coords


def _extract_coords_from_dir(structures_dir: Path,
                             target_ids: List[str],
                             save_directory: Optional[Path] = None
                             ) -> List[Optional[np.ndarray]]:
    """CA coords from a structure-directory database (one file per target).

    Companion to ``search.database._build_structure_dir_database``; the
    chain used is the file's first chain, matching the sequence the DB
    build extracted.
    """
    from metagenomic_deepfri_tpu_torch.data.structures import (
        STRUCTURE_SUFFIXES, get_residues_coordinates, load_structure,
        read_structure_file)

    coords: List[Optional[np.ndarray]] = []
    for tid in target_ids:
        path = None
        for suffix, _ in STRUCTURE_SUFFIXES:
            cand = structures_dir / f"{tid}{suffix}"
            if cand.exists():
                path = cand
                break
        if path is None:
            warnings.warn(f"No structure file for target {tid} in "
                          f"{structures_dir}")
            coords.append(None)
            continue
        text = None
        try:
            text, ftype = read_structure_file(path)
            table = load_structure(text, filetype=ftype)
            _, coord = get_residues_coordinates(table,
                                                chain=table.chains()[0])
        except (KeyError, ValueError, IndexError) as e:
            warnings.warn(f"Error parsing structure {path.name}: {e}")
            coord = None
        coords.append(coord)
        if save_directory and text is not None:
            with open(Path(save_directory) / f"{tid}.pdb", "w",
                      encoding="utf-8") as f:
                f.write(text)
    return coords
