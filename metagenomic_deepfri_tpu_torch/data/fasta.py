"""FASTA parsing, writing and random access.

A copy of ``metagenomic_deepfri_tpu/data/fasta.py`` (no package imports).

Replaces the reference's pysam-backed loaders (reference
``utils.py:279-340``: ``load_fasta_as_dict`` via FastxFile,
``retrieve_fasta_entries_as_dict`` via faidx) without the htslib dependency.
Plain and gzip-compressed files are supported transparently; random access
uses an in-memory byte-offset index built in one streaming pass (an ``.mfai``
sidecar caches it for plain files).
"""

from __future__ import annotations

import gzip
import io
import json
import os
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Tuple

GZIP_MAGIC = b"\x1f\x8b"


def _is_gzip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == GZIP_MAGIC


def _open_text(path):
    if _is_gzip(path):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def iter_fasta(path) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence). Name = first whitespace-delimited header token
    (pysam FastxFile ``entry.name`` semantics, reference mmseqs.py:571-573)."""
    name = None
    chunks: List[str] = []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def load_fasta_as_dict(fasta_file) -> Dict[str, str]:
    """Load a (possibly gzipped) FASTA file as {name: sequence}."""
    return {name: seq for name, seq in iter_fasta(fasta_file)}


def write_fasta(path, sequences: Dict[str, str], width: int = 0):
    """Write {name: seq} to FASTA; width=0 → one line per sequence."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        for name, seq in sequences.items():
            f.write(f">{name}\n")
            if width:
                for i in range(0, len(seq), width):
                    f.write(seq[i:i + width] + "\n")
            else:
                f.write(seq + "\n")


class FastaIndex:
    """Random access into a FASTA file by sequence name.

    For plain files a JSON offset index is cached as ``<path>.mfai``; gzipped
    files are indexed in memory per process (block-gzip random access is not
    assumed — unlike the reference we do not require bgzip recompression,
    reference ``utils.py:316-327``).
    """

    def __init__(self, path):
        self.path = Path(path)
        self.gzipped = _is_gzip(self.path)
        self._sequences: Dict[str, str] | None = None
        self._index: Dict[str, Tuple[int, int]] | None = None
        if self.gzipped:
            # one streaming pass; keep sequences in memory
            self._sequences = load_fasta_as_dict(self.path)
        else:
            self._index = self._load_or_build_index()

    def _load_or_build_index(self) -> Dict[str, Tuple[int, int]]:
        sidecar = Path(str(self.path) + ".mfai")
        if sidecar.exists() and (sidecar.stat().st_mtime
                                 >= self.path.stat().st_mtime):
            try:
                with open(sidecar, "r", encoding="utf-8") as f:
                    return {k: tuple(v) for k, v in json.load(f).items()}
            except (json.JSONDecodeError, OSError):
                pass
        index: Dict[str, Tuple[int, int]] = {}
        with open(self.path, "rb") as f:
            name = None
            start = 0
            pos = 0
            for line in f:
                if line.startswith(b">"):
                    if name is not None:
                        index[name] = (start, pos - start)
                    name = line[1:].split()[0].decode("utf-8")
                    start = pos + len(line)
                pos += len(line)
            if name is not None:
                index[name] = (start, pos - start)
        try:
            tmp = str(sidecar) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(index, f)
            os.replace(tmp, sidecar)
        except OSError:
            pass
        return index

    def names(self) -> List[str]:
        if self._sequences is not None:
            return list(self._sequences)
        return list(self._index)

    def fetch(self, name: str) -> str:
        if self._sequences is not None:
            try:
                return self._sequences[name]
            except KeyError:
                raise KeyError(
                    f"Sequence with ID {name} not found in {self.path}")
        if name not in self._index:
            raise KeyError(f"Sequence with ID {name} not found in {self.path}")
        start, length = self._index[name]
        with open(self.path, "rb") as f:
            f.seek(start)
            raw = f.read(length)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode("utf-8")

    def __contains__(self, name: str) -> bool:
        if self._sequences is not None:
            return name in self._sequences
        return name in self._index


def retrieve_fasta_entries_as_dict(fasta_file,
                                   entries: Iterable[str]) -> Dict[str, str]:
    """Fetch selected entries (reference ``utils.py:296-340`` semantics:
    raises ValueError naming the missing ID)."""
    idx = FastaIndex(fasta_file)
    out: Dict[str, str] = {}
    for name in entries:
        try:
            out[name] = idx.fetch(name)
        except KeyError:
            raise ValueError(
                f"Sequence with ID {name} not found in {fasta_file}")
    return out
