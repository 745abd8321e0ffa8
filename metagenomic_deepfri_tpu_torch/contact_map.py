"""Validating object API for contact maps (host, numpy).

Counterpart of ``metagenomic_deepfri_tpu/contact_map.py``:
CAlphaCoordinates → DistanceMap → ContactMap, each checking its input. The
pipeline uses the functional path (:mod:`.ops.contact`); this API is for
outside callers.
"""

from __future__ import annotations

import numpy as np

from metagenomic_deepfri_tpu_torch.ops.contact import pairwise_sqeuclidean


class CAlphaCoordinates:
    """(L, 3) CA coordinates for one structure."""

    def __init__(self, structure_id: str, coords: np.ndarray):
        self.structure_id = structure_id
        self.coords = coords
        if coords.shape[1] != 3:
            raise ValueError(
                f"expected (L, 3) CA coordinates, got shape {coords.shape}")

    def calculate_distance_map(self, distance: str = "sqeuclidean"):
        if distance != "sqeuclidean":
            raise NotImplementedError(
                f"unsupported distance metric {distance!r}; only "
                "'sqeuclidean' is available")
        return DistanceMap(pairwise_sqeuclidean(
            self.coords.astype(np.float32)))

    def calculate_contact_map(self, threshold: float = 6.0) -> "ContactMap":
        return self.calculate_distance_map().calculate_contacts(threshold ** 2)


class DistanceMap:
    """Validated dense distance matrix (non-negative, symmetric, 0 diagonal)."""

    def __init__(self, distance_map: np.ndarray):
        self.distance_map = distance_map
        if not np.all(distance_map >= 0):
            raise ValueError("distance matrix has negative entries")
        if not np.all(np.diag(distance_map) == 0):
            raise ValueError("distance matrix has a non-zero diagonal")
        if not np.allclose(distance_map, distance_map.T):
            raise ValueError("distance matrix is asymmetric")

    def calculate_contacts(self, threshold: float) -> "ContactMap":
        return ContactMap((self.distance_map < threshold).astype(np.int32))


class ContactMap:
    """Validated binary symmetric contact map."""

    def __init__(self, cmap: np.ndarray):
        self.cmap = cmap
        if not np.allclose(cmap, cmap.T):
            raise ValueError("contact map is asymmetric")
        if not np.all(np.isin(cmap, [0, 1])):
            raise ValueError("contact map entries must be binary (0/1)")

    def sparsify(self) -> np.ndarray:
        """(N, 2) int32 indices of the contacts."""
        return np.argwhere(self.cmap == 1).astype(np.int32)
