"""Multi-host catalogue sharding: deterministic input partition + merge.

A copy of ``metagenomic_deepfri_tpu/parallel/multihost.py`` (``:31-110``):
:func:`shard_of`, :func:`shard_fasta`, :func:`shard_fasta_for_process` and
:func:`merge_shard_results`. Each host runs the full pipeline on a
deterministic slice of the query FASTA (``--shard I/N``) and the per-host
output directories concatenate into catalogue-level results. Where the JAX
package reads its process index from ``jax.distributed``, the port reads
the rank of an initialised ``torch.distributed`` process group.
"""

from __future__ import annotations

import logging
import zlib
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Artifacts merged by simple header-checked concatenation, in the order the
# single-host pipeline writes them.
_MERGEABLE = ("alignment_summary.tsv", "results.tsv",
              "results_propagated.tsv")


def shard_of(query_id: str, host_count: int) -> int:
    """Stable shard index for a query id (crc32 — identical on every host,
    every run, every Python version; not hash(), which is salted)."""
    return zlib.crc32(query_id.encode("utf-8")) % host_count


def shard_fasta(input_fasta, output_fasta, host_index: int,
                host_count: int) -> Tuple[Path, int]:
    """Write this host's deterministic slice of a query FASTA.

    Every host runs the same call with its own ``host_index``; the slices
    partition the input exactly (each id lands on one host).
    """
    from metagenomic_deepfri_tpu_torch.data.fasta import (iter_fasta,
                                                          write_fasta)

    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} not in [0, {host_count})")
    shard = {qid: seq for qid, seq in iter_fasta(input_fasta)
             if shard_of(qid, host_count) == host_index}
    output_fasta = Path(output_fasta)
    write_fasta(output_fasta, shard)
    logger.info("Shard %d/%d: %d queries → %s",
                host_index, host_count, len(shard), output_fasta)
    return output_fasta, len(shard)


def shard_fasta_for_process(input_fasta, output_fasta) -> Tuple[Path, int]:
    """Shard by this process's rank in an initialised ``torch.distributed``
    process group (``get_rank()`` of ``get_world_size()``); without one,
    the process is shard 0 of 1, as ``jax.process_index()`` /
    ``process_count()`` are without ``jax.distributed``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    return shard_fasta(input_fasta, output_fasta, index, count)


def merge_shard_results(shard_dirs: Iterable, output_dir) -> List[Path]:
    """Concatenate per-host pipeline output directories into one.

    Merges every TSV artifact present in the shards (results,
    alignment summary, propagated results, per-mode prediction matrices)
    under a single header, validating that headers agree across shards.
    Returns the merged file paths.
    """
    shard_dirs = [Path(d) for d in shard_dirs]
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    names: List[str] = []
    for name in _MERGEABLE:
        if any((d / name).exists() for d in shard_dirs):
            names.append(name)
    matrix_names = sorted({f.name for d in shard_dirs
                           for f in d.glob("prediction_matrix_*.tsv")})
    names.extend(matrix_names)

    merged: List[Path] = []
    for name in names:
        out_path = output_dir / name
        header: Optional[str] = None
        rows = 0
        with open(out_path, "w", encoding="utf-8") as out:
            for d in shard_dirs:
                path = d / name
                if not path.exists():
                    continue
                with open(path, "r", encoding="utf-8") as f:
                    first = f.readline()
                    if header is None:
                        header = first
                        out.write(header)
                    elif first != header:
                        raise ValueError(
                            f"Shard {d} has a different {name} header")
                    for line in f:
                        out.write(line)
                        rows += 1
        logger.info("Merged %s: %d rows from %d shards.",
                    name, rows, len(shard_dirs))
        merged.append(out_path)
    return merged
