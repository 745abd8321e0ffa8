"""Alignment-projected coordinates (host) and the aligned adjacency (torch).

Counterpart of ``metagenomic_deepfri_tpu/ops/cmap_align.py``. The host half
gathers a target's CA coordinates through a gapped query↔target alignment
into query indexing (sentinel coordinates where the query residue has no
matched target residue); the device half thresholds their pairwise distances
and ORs in the identity diagonal and the insertion band.

Coordinates stay float32 throughout: the sentinels ``1e6 + 1e3·i`` do not
survive bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from metagenomic_deepfri_tpu_torch.ops.contact import \
    pairwise_sqeuclidean_device

GAP = "-"

# Sentinel coordinates for unmapped query positions: far from every real CA
# coordinate and from each other, so they produce no spurious contacts.
_SENTINEL_BASE = 1.0e6
_SENTINEL_SPACING = 1.0e3


def alignment_index_map(query_alignment: str, target_alignment: str,
                        generated_contacts: int = 2):
    """Decode a gapped alignment into index maps.

    Returns:
        target_to_query: (T_align,) int32 — query index for each consumed
            target residue, -1 where the query has a gap (deletion).
        insertion_positions: (K,) int32 — query indices aligned to target
            gaps (insertions).
        query_len: int — number of query residues consumed.
    """
    if len(query_alignment) != len(target_alignment):
        raise ValueError("Gapped query and target must have equal length")
    target_to_query = []
    insertions = []
    q = 0
    for qc, tc in zip(query_alignment, target_alignment):
        if qc == GAP:
            target_to_query.append(-1)
        else:
            if tc == GAP:
                insertions.append(q)
            else:
                target_to_query.append(q)
            q += 1
    return (np.asarray(target_to_query, dtype=np.int32),
            np.asarray(insertions, dtype=np.int32), q)


def align_contact_map(query_alignment: str,
                      target_alignment: str,
                      sparse_target_contact_map: np.ndarray,
                      generated_contacts: int = 2,
                      threads: int = 1) -> np.ndarray:
    """Dense (Q, Q) int32 aligned contact map on the host (numpy).

    A copy of the JAX package's host path (``cmap_align.py:64-102``,
    reference ``contact_map_utils.pyx:44-117``; ``threads`` is accepted for
    API parity): identity diagonal, ``generated_contacts`` neighbour
    contacts around each insertion, and the target's contacts mapped
    through the alignment, symmetrised.
    """
    del threads
    t2q, insertions, qlen = alignment_index_map(query_alignment,
                                                target_alignment)
    out = np.zeros((qlen, qlen), dtype=np.int32)
    np.fill_diagonal(out, 1)

    for q in insertions:
        for j in range(1, generated_contacts + 1):
            for p1, p2 in ((q + j, q), (q - j, q)):
                if 0 <= p1 < qlen and 0 <= p2 < qlen:
                    out[p1, p2] = 1
                    out[p2, p1] = 1

    contacts = np.asarray(sparse_target_contact_map, dtype=np.int64)
    if contacts.size:
        ti, tj = contacts[:, 0], contacts[:, 1]
        in_range = (ti < t2q.shape[0]) & (tj < t2q.shape[0])
        ti, tj = ti[in_range], tj[in_range]
        qi, qj = t2q[ti], t2q[tj]
        mapped = (qi >= 0) & (qj >= 0)
        out[qi[mapped], qj[mapped]] = 1
        out[qj[mapped], qi[mapped]] = 1
    return out


def project_alignment_coords(query_alignment: str, target_alignment: str,
                             target_coords: np.ndarray):
    """Gather target CA coords into query indexing (host, numpy).

    Returns:
        proj_coords: (Q, 3) float32 (sentinels where unmapped),
        insertion_mask: (Q,) bool, query_len: int.
    Raises:
        IndexError when the alignment addresses residues beyond the target.
    """
    t2q, insertions, qlen = alignment_index_map(query_alignment,
                                                target_alignment)
    target_coords = np.asarray(target_coords, dtype=np.float32)
    q_to_t = np.full(qlen, -1, dtype=np.int32)
    t_res = np.nonzero(t2q >= 0)[0]
    q_to_t[t2q[t_res]] = t_res
    mapped = q_to_t >= 0
    if np.any(q_to_t >= target_coords.shape[0]):
        raise IndexError("alignment addresses residues beyond target coords")
    proj = np.empty((qlen, 3), dtype=np.float32)
    proj[mapped] = target_coords[q_to_t[mapped]]
    unmapped_pos = np.nonzero(~mapped)[0]
    proj[~mapped, 0] = _SENTINEL_BASE + _SENTINEL_SPACING * unmapped_pos
    proj[~mapped, 1:] = 0.0
    ins_mask = np.zeros(qlen, dtype=bool)
    ins_mask[insertions] = True
    return proj, ins_mask, qlen


def aligned_contacts_from_coords(proj_coords: torch.Tensor,
                                 insertion_mask: torch.Tensor,
                                 lengths: torch.Tensor,
                                 threshold: float = 6.0,
                                 generated_contacts: int = 2) -> torch.Tensor:
    """Dense (B, Q, Q) float32 0/1 aligned adjacency from projected coords.

    An entry is 1 when ``(contact ∨ i=j ∨ insertion band) ∧ i<n ∧ j<n``;
    ``contact`` needs the squared distance below ``threshold²`` and both
    ends real (not sentinels). The plain reference of the fused kernels in
    :mod:`.graphconv`.
    """
    dist = pairwise_sqeuclidean_device(proj_coords)
    contacts = dist < threshold ** 2

    B, Q = insertion_mask.shape
    pos = torch.arange(Q, dtype=torch.int32, device=proj_coords.device)
    eye = pos[:, None] == pos[None, :]
    offset = (pos[:, None] - pos[None, :]).abs()
    band = (offset > 0) & (offset <= generated_contacts)
    ins = insertion_mask.to(torch.bool)
    ins_pairs = band[None] & (ins[:, :, None] | ins[:, None, :])

    real = ~(proj_coords[:, :, 0] >= _SENTINEL_BASE * 0.5)
    contacts = contacts & real[:, :, None] & real[:, None, :]

    out = contacts | eye[None] | ins_pairs
    valid = pos[None, :] < lengths.to(torch.int32)[:, None]
    mask2d = valid[:, :, None] & valid[:, None, :]
    return (out & mask2d).to(torch.float32)
