"""Protein structure parsing: PDB and mmCIF → C-alpha coordinates.

A copy of ``metagenomic_deepfri_tpu/data/structures.py`` (numpy only): the
port imports no module of the JAX package.

Replaces the reference's biotite-based path (reference
``bio_utils.py:230-302``: ``load_structure`` / ``get_residues_coordinates`` /
``extract_residues_coordinates``) with a dependency-free parser that extracts
exactly what the pipeline needs: per-chain CA atoms of non-hetero residues
(model 1), a one-letter residue string, and an (L, 3) float32 coordinate
array.

The non-standard-residue substitution table mirrors the pdbfixer-derived
table the reference embeds (reference ``bio_utils.py:47-193``; original
source: openmm/pdbfixer) — it is public reference data, reproduced for parity
of accepted inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Literal, Optional, Tuple

import numpy as np

# Standard 20 amino acids, 3-letter → 1-letter.
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    # common extras accepted by biotite's ProteinSequence
    "SEC": "U", "PYL": "O", "ASX": "B", "GLX": "Z", "UNK": "X",
}

# Non-standard residue substitutions (pdbfixer table; reference
# bio_utils.py:48-193). Keys are modified residues, values their standard
# parent.
SUBSTITUTIONS = {
    '2AS': 'ASP', '3AH': 'HIS', '5HP': 'GLU', '5OW': 'LYS', 'ACL': 'ARG',
    'AGM': 'ARG', 'AIB': 'ALA', 'ALM': 'ALA', 'ALO': 'THR', 'ALY': 'LYS',
    'ARM': 'ARG', 'ASA': 'ASP', 'ASB': 'ASP', 'ASK': 'ASP', 'ASL': 'ASP',
    'ASQ': 'ASP', 'AYA': 'ALA', 'BCS': 'CYS', 'BHD': 'ASP', 'BMT': 'THR',
    'BNN': 'ALA', 'BUC': 'CYS', 'BUG': 'LEU', 'C5C': 'CYS', 'C6C': 'CYS',
    'CAS': 'CYS', 'CCS': 'CYS', 'CEA': 'CYS', 'CGU': 'GLU', 'CHG': 'ALA',
    'CLE': 'LEU', 'CME': 'CYS', 'CSD': 'ALA', 'CSO': 'CYS', 'CSP': 'CYS',
    'CSS': 'CYS', 'CSW': 'CYS', 'CSX': 'CYS', 'CXM': 'MET', 'CY1': 'CYS',
    'CY3': 'CYS', 'CYG': 'CYS', 'CYM': 'CYS', 'CYQ': 'CYS', 'DAH': 'PHE',
    'DAL': 'ALA', 'DAR': 'ARG', 'DAS': 'ASP', 'DCY': 'CYS', 'DGL': 'GLU',
    'DGN': 'GLN', 'DHA': 'ALA', 'DHI': 'HIS', 'DIL': 'ILE', 'DIV': 'VAL',
    'DLE': 'LEU', 'DLY': 'LYS', 'DNP': 'ALA', 'DPN': 'PHE', 'DPR': 'PRO',
    'DSN': 'SER', 'DSP': 'ASP', 'DTH': 'THR', 'DTR': 'TRP', 'DTY': 'TYR',
    'DVA': 'VAL', 'EFC': 'CYS', 'FLA': 'ALA', 'FME': 'MET', 'GGL': 'GLU',
    'GL3': 'GLY', 'GLZ': 'GLY', 'GMA': 'GLU', 'GSC': 'GLY', 'HAC': 'ALA',
    'HAR': 'ARG', 'HIC': 'HIS', 'HIP': 'HIS', 'HMR': 'ARG', 'HPQ': 'PHE',
    'HTR': 'TRP', 'HYP': 'PRO', 'IAS': 'ASP', 'IIL': 'ILE', 'IYR': 'TYR',
    'KCX': 'LYS', 'LLP': 'LYS', 'LLY': 'LYS', 'LTR': 'TRP', 'LYM': 'LYS',
    'LYZ': 'LYS', 'MAA': 'ALA', 'MEN': 'ASN', 'MHS': 'HIS', 'MIS': 'SER',
    'MK8': 'LEU', 'MLE': 'LEU', 'MPQ': 'GLY', 'MSA': 'GLY', 'MSE': 'MET',
    'MVA': 'VAL', 'NEM': 'HIS', 'NEP': 'HIS', 'NLE': 'LEU', 'NLN': 'LEU',
    'NLP': 'LEU', 'NMC': 'GLY', 'OAS': 'SER', 'OCS': 'CYS', 'OMT': 'MET',
    'PAQ': 'TYR', 'PCA': 'GLU', 'PEC': 'CYS', 'PHI': 'PHE', 'PHL': 'PHE',
    'PR3': 'CYS', 'PRR': 'ALA', 'PTR': 'TYR', 'PYX': 'CYS', 'SAC': 'SER',
    'SAR': 'GLY', 'SCH': 'CYS', 'SCS': 'CYS', 'SCY': 'CYS', 'SEL': 'SER',
    'SEP': 'SER', 'SET': 'SER', 'SHC': 'CYS', 'SHR': 'LYS', 'SMC': 'CYS',
    'SOC': 'CYS', 'STY': 'TYR', 'SVA': 'SER', 'TIH': 'ALA', 'TPL': 'TRP',
    'TPO': 'THR', 'TPQ': 'ALA', 'TRG': 'LYS', 'TRO': 'TRP', 'TYB': 'TYR',
    'TYI': 'TYR', 'TYQ': 'TYR', 'TYS': 'TYR', 'TYY': 'TYR',
}


@dataclass
class AtomTable:
    """Columnar CA-atom table for one structure model."""
    chain_id: List[str]
    res_name: List[str]
    hetero: np.ndarray       # (N,) bool
    coords: np.ndarray       # (N, 3) float32

    def chains(self) -> List[str]:
        seen = []
        for c in self.chain_id:
            if c not in seen:
                seen.append(c)
        return seen


def _parse_pdb(structure_string: str) -> AtomTable:
    chain_ids, res_names, hetero, coords = [], [], [], []
    for line in structure_string.splitlines():
        rec = line[:6]
        if rec == "ENDMDL":
            break  # model 1 only (reference bio_utils.py:275: get_structure()[0])
        if rec not in ("ATOM  ", "HETATM"):
            continue
        atom_name = line[12:16].strip()
        if atom_name != "CA":
            continue
        altloc = line[16]
        if altloc not in (" ", "A"):
            continue
        chain_ids.append(line[21].strip())
        res_names.append(line[17:20].strip())
        hetero.append(rec == "HETATM")
        coords.append((float(line[30:38]), float(line[38:46]),
                       float(line[46:54])))
    return AtomTable(chain_ids, res_names,
                     np.asarray(hetero, bool),
                     np.asarray(coords, np.float32).reshape(-1, 3))


def _tokenize_cif_line(line: str) -> List[str]:
    """Split an mmCIF data line honouring quoted fields."""
    tokens = []
    i = 0
    n = len(line)
    while i < n:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n:
            break
        if line[i] in "'\"":
            quote = line[i]
            j = line.find(quote, i + 1)
            if j == -1:
                j = n
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


def _parse_mmcif(structure_string: str) -> AtomTable:
    lines = structure_string.splitlines()
    chain_ids, res_names, hetero, coords = [], [], [], []
    i = 0
    n = len(lines)
    while i < n:
        if lines[i].strip() != "loop_":
            i += 1
            continue
        # collect the loop's column headers
        headers = []
        j = i + 1
        while j < n and lines[j].strip().startswith("_"):
            headers.append(lines[j].strip().split()[0])
            j += 1
        if not headers or not headers[0].startswith("_atom_site."):
            i = j
            continue
        col = {h.split(".", 1)[1]: k for k, h in enumerate(headers)}
        need = ("group_PDB", "label_atom_id", "Cartn_x", "Cartn_y", "Cartn_z")
        if not all(k in col for k in need):
            i = j
            continue
        chain_col = col.get("auth_asym_id", col.get("label_asym_id"))
        res_col = col.get("auth_comp_id", col.get("label_comp_id"))
        model_col = col.get("pdbx_PDB_model_num")
        first_model: Optional[str] = None
        while j < n:
            line = lines[j].strip()
            if not line or line.startswith(("#", "loop_", "_", "data_")):
                break
            row = _tokenize_cif_line(line)
            j += 1
            if len(row) < len(headers):
                continue
            if model_col is not None:
                if first_model is None:
                    first_model = row[model_col]
                elif row[model_col] != first_model:
                    continue
            if row[col["label_atom_id"]] != "CA":
                continue
            if "label_alt_id" in col and row[col["label_alt_id"]] not in (
                    ".", "?", "A"):
                continue
            chain_ids.append(row[chain_col] if chain_col is not None else "A")
            res_names.append(row[res_col] if res_col is not None else "UNK")
            hetero.append(row[col["group_PDB"]] == "HETATM")
            coords.append((float(row[col["Cartn_x"]]),
                           float(row[col["Cartn_y"]]),
                           float(row[col["Cartn_z"]])))
        i = j
    return AtomTable(chain_ids, res_names,
                     np.asarray(hetero, bool),
                     np.asarray(coords, np.float32).reshape(-1, 3))


def load_structure(structure_string: str,
                   filetype: Literal["mmcif", "pdb"] = "mmcif") -> AtomTable:
    """Parse a structure string (reference ``bio_utils.py:258-279`` API)."""
    if filetype == "mmcif":
        return _parse_mmcif(structure_string)
    if filetype == "pdb":
        return _parse_pdb(structure_string)
    raise NotImplementedError(f"Filetype {filetype} not supported.")


def get_residues_coordinates(structure: AtomTable,
                             chain: str = "A") -> Tuple[str, np.ndarray]:
    """One-letter residue string + (L, 3) CA coords for a chain.

    Reference semantics (``bio_utils.py:230-255``): raises ValueError if the
    chain is absent; hetero CA atoms excluded; non-standard residues mapped
    through :data:`SUBSTITUTIONS`; unknown residues raise KeyError (caught by
    callers, reference ``pdb.py:115-127``).
    """
    if chain not in structure.chains():
        raise ValueError(f"Chain {chain} not found in structure.")
    residues = []
    coords = []
    for cid, res, het, xyz in zip(structure.chain_id, structure.res_name,
                                  structure.hetero, structure.coords):
        if cid != chain or het:
            continue
        res = SUBSTITUTIONS.get(res, res)
        if res not in THREE_TO_ONE:
            raise KeyError(res)
        residues.append(THREE_TO_ONE[res])
        coords.append(xyz)
    return "".join(residues), np.asarray(coords, np.float32).reshape(-1, 3)


def extract_residues_coordinates(
        structure_string: str,
        chain: str = "A",
        filetype: Literal["mmcif", "pdb"] = "mmcif",
        save_directory=None) -> Tuple[str, np.ndarray]:
    """Parse + extract in one call (reference ``bio_utils.py:282-302``)."""
    structure = load_structure(structure_string, filetype=filetype)
    return get_residues_coordinates(structure, chain=chain)


# ---------------------------------------------------------------------------
# Structure files on disk (the structure-directory database type).
# ---------------------------------------------------------------------------

# filename suffix → parser filetype; longest match wins.
STRUCTURE_SUFFIXES = (
    (".pdb.gz", "pdb"), (".pdb", "pdb"),
    (".mmcif.gz", "mmcif"), (".mmcif", "mmcif"),
    (".cif.gz", "mmcif"), (".cif", "mmcif"),
)


def structure_id_and_type(filename: str):
    """(structure_id, filetype) for a structure filename, (None, None) if
    the suffix is not a recognised structure format."""
    for suffix, ftype in STRUCTURE_SUFFIXES:
        if filename.endswith(suffix):
            return filename[: -len(suffix)], ftype
    return None, None


def read_structure_file(path) -> Tuple[str, str]:
    """(text, filetype) for a .pdb/.cif file, transparently gunzipping."""
    import gzip
    from pathlib import Path

    path = Path(path)
    _, ftype = structure_id_and_type(path.name)
    if ftype is None:
        raise ValueError(f"Not a recognised structure file: {path}")
    if path.name.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return f.read(), ftype
    with open(path, "r", encoding="utf-8") as f:
        return f.read(), ftype


ONE_TO_THREE = {one: three for three, one in THREE_TO_ONE.items()}


def write_ca_pdb(path, sequence: str, coords: np.ndarray,
                 chain: str = "A") -> None:
    """Write a minimal CA-trace PDB (one atom per residue).

    Round-trips exactly through :func:`_parse_pdb` /
    :func:`get_residues_coordinates`; used to materialise structure
    directories and by tests needing real on-disk structures.
    """
    coords = np.asarray(coords, dtype=np.float32)
    if coords.shape != (len(sequence), 3):
        raise ValueError(
            f"coords shape {coords.shape} != ({len(sequence)}, 3)")
    lines = []
    for i, (aa, (x, y, z)) in enumerate(zip(sequence, coords)):
        res3 = ONE_TO_THREE.get(aa, "UNK")
        lines.append(
            f"ATOM  {i + 1:>5d}  CA  {res3:>3s} {chain:1s}{i + 1:>4d}"
            f"    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C")
    lines.append("END")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
