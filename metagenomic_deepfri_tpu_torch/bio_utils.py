"""Per-protein structure glue the pipeline maps over search hits.

Jax-free copies of ``metagenomic_deepfri_tpu/bio_utils.py:28-90``
(reference ``bio_utils.py:348-385``), host numpy only:

- :func:`build_align_projection` gathers a hit's CA coordinates through
  its alignment into query indexing (O(L)); the GCN builds the adjacency
  from them on the device (the fused B1/B2 kernels);
- :func:`build_align_contact_map` builds the dense aligned contact map on
  the host, for ``--save-cmaps``.

Both return ``(alignment, None)`` with a warning when the hit has no
coordinates or the alignment does not fit them, so the query can be
rescued by a later database or fall back to the CNN.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from metagenomic_deepfri_tpu_torch.align.pairwise import AlignmentResult
from metagenomic_deepfri_tpu_torch.ops.cmap_align import (
    align_contact_map, project_alignment_coords)
from metagenomic_deepfri_tpu_torch.ops.contact import calculate_contact_map

logger = logging.getLogger(__name__)


def build_align_contact_map(
        alignment: AlignmentResult,
        threshold: float = 6,
        generated_contacts: int = 2
) -> Tuple[AlignmentResult, Optional[np.ndarray]]:
    """Target coords → sparse cmap → remap onto query indexing."""
    idx = alignment.target_name.rsplit(".", 1)[0]
    coordinates = alignment.coords
    if coordinates is None:
        logger.warning("No coordinates found for %s.", alignment.target_name)
        return (alignment, None)
    cmap = calculate_contact_map(coordinates, threshold=threshold,
                                 mode="sparse")
    try:
        aligned_cmap = align_contact_map(alignment.gapped_sequence,
                                         alignment.gapped_target, cmap,
                                         generated_contacts)
    except (IndexError, ValueError):
        logger.warning(
            "Error aligning contact map for target %s against %s.",
            idx, alignment.query_name)
        aligned_cmap = None
    return (alignment, aligned_cmap)


def build_align_projection(
        alignment: AlignmentResult
) -> Tuple[AlignmentResult, Optional[tuple]]:
    """Target coords → query-indexed coordinate projection
    ``(proj (Q, 3) float32, insertion mask (Q,) bool)``."""
    idx = alignment.target_name.rsplit(".", 1)[0]
    coordinates = alignment.coords
    if coordinates is None:
        logger.warning("No coordinates found for %s.", alignment.target_name)
        return (alignment, None)
    try:
        proj, ins_mask, _ = project_alignment_coords(
            alignment.gapped_sequence, alignment.gapped_target, coordinates)
    except (IndexError, ValueError):
        logger.warning(
            "Error aligning contact map for target %s against %s.",
            idx, alignment.query_name)
        return (alignment, None)
    return (alignment, (proj, ins_mask))
