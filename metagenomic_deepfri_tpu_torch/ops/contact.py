"""Contact maps from C-alpha coordinates: host (numpy) and device (torch).

Counterpart of ``metagenomic_deepfri_tpu/ops/contact.py``:

- :func:`pairwise_sqeuclidean` and :func:`calculate_contact_map` are
  jax-free numpy copies of the host path (``contact.py:36-70``);
- :func:`pairwise_sqeuclidean_device` (``:77-90``) and
  :func:`batched_contact_maps` (``:92-115``) are the batched device path in
  plain PyTorch; :func:`batched_contact_maps` is the plain twin of B3;
- :func:`contact_map_fused` is the B3 wrapper. On a CPU tensor it runs the
  twin; on a CUDA tensor it launches the kernel in ``csrc/contact.cu``
  (counterpart of the Pallas ``_contact_map_fused_impl``, ``:126-199``) or
  raises. It counts its launches in ``contact_map_fused.launches``
  (:func:`count_launch`, safe from several threads).

The distance is the exact per-axis float32 difference form, summed x, y, z
in that order, everywhere. The Gram identity ‖a‖²+‖b‖²−2a·b would run on
tensor cores and flip contacts that sit near the threshold.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from metagenomic_deepfri_tpu_torch.ops import _build

_MAX_GRID_BATCH = 65535  # CUDA grid y/z limit; the batch is a grid axis
_launches_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock, so that host threads
    launching at once (one a card, say) lose no count."""
    with _launches_lock:
        wrapper.launches += 1


def _thr2(threshold: float) -> float:
    """threshold² as the float32 the reference compares against."""
    return float(np.float32(threshold * threshold))


def _route(coords: torch.Tensor, kernel: str) -> str:
    """"ref" (plain twin) for a CPU tensor, "cuda" (kernel) for a CUDA one."""
    if coords.device.type == "cpu":
        return "ref"
    if coords.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no {kernel} kernel for device {coords.device}")


# ---------------------------------------------------------------------------
# Host (numpy)
# ---------------------------------------------------------------------------


def pairwise_sqeuclidean(coords: np.ndarray) -> np.ndarray:
    """Dense (L, L) float32 squared-euclidean distance matrix.

    Accumulated axis by axis in float32 (diagonal exactly 0, symmetric).
    """
    coords = np.asarray(coords, dtype=np.float32)
    L = coords.shape[0]
    dist = np.zeros((L, L), dtype=np.float32)
    for k in range(coords.shape[1]):
        d = coords[:, None, k] - coords[None, :, k]
        dist += d * d
    return dist


def calculate_contact_map(coordinates: np.ndarray,
                          threshold: float = 6.0,
                          distance: str = "sqeuclidean",
                          mode: str = "matrix") -> np.ndarray:
    """Contact map from CA coordinates.

    ``mode='matrix'`` returns a dense (L, L) int32 0/1 map;
    ``mode='sparse'`` returns the (N, 2) int32 indices of contacts.
    The threshold compares squared distance against ``threshold**2``.
    """
    if distance != "sqeuclidean":
        raise ValueError(f"Unsupported distance: {distance}")
    dist = pairwise_sqeuclidean(coordinates)
    cmap = (dist < threshold ** 2).astype(np.int32)
    if mode == "sparse":
        return np.argwhere(cmap == 1).astype(np.int32)
    return cmap


# ---------------------------------------------------------------------------
# Device (torch)
# ---------------------------------------------------------------------------


def pairwise_sqeuclidean_device(coords: torch.Tensor) -> torch.Tensor:
    """(B, L, 3) float32 → (B, L, L) float32 squared distances."""
    dx = coords[:, :, None, 0] - coords[:, None, :, 0]
    dy = coords[:, :, None, 1] - coords[:, None, :, 1]
    dz = coords[:, :, None, 2] - coords[:, None, :, 2]
    return dx * dx + dy * dy + dz * dz


def batched_contact_maps(coords: torch.Tensor, lengths: torch.Tensor,
                         threshold: float = 6.0) -> torch.Tensor:
    """Contact maps for a padded batch: the plain twin of B3.

    Args:
        coords: (B, L, 3) float32, padded with arbitrary values beyond length.
        lengths: (B,) int32 true lengths.
        threshold: contact distance threshold in Å.

    Returns:
        (B, L, L) float32 0/1 adjacency with self-contacts on the valid
        diagonal (distance 0) and all padded rows/cols zeroed: the GCN's
        dense input contract.
    """
    dist = pairwise_sqeuclidean_device(coords.to(torch.float32))
    contacts = (dist < _thr2(threshold)).to(torch.float32)
    L = coords.shape[1]
    pos = torch.arange(L, dtype=torch.int32, device=coords.device)
    valid = pos[None, :] < lengths.to(torch.int32)[:, None]
    mask2d = valid[:, :, None] & valid[:, None, :]
    return contacts * mask2d.to(torch.float32)


def _check_kernel_inputs(coords: torch.Tensor, others) -> None:
    """Validate (B, L, 3) float32 ``coords`` and each ``(name, tensor,
    dtype, shape)`` of ``others`` for a CUDA kernel: device, dtype, shape
    and contiguity. Raises on what the kernels do not take."""
    if coords.dim() != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (B, L, 3), got {tuple(coords.shape)}")
    if coords.shape[0] > _MAX_GRID_BATCH:
        raise ValueError(f"batch {coords.shape[0]} exceeds the kernels' grid "
                         "limit")
    device = coords.device
    for name, t, dtype, shape in (
            ("coords", coords, torch.float32, coords.shape), *others):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, coords on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(device: torch.device, entry, *args) -> int:
    """Call the C entry point ``entry(*args, stream)`` on ``device``'s
    current stream, with ``device`` current; returns its CUDA error code.

    The stream is read as a raw ``cudaStream_t`` and a device guard is
    entered only when another device is current: building a
    ``torch.cuda.Stream`` and entering ``torch.cuda.device`` on every call
    cost more host time than a short kernel runs (``chip_smoke.py``
    reports each kernel's host time per launch).
    """
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return entry(*args, stream)
    with torch.cuda.device(device):
        return entry(*args, stream)


def contact_map_fused(coords: torch.Tensor, lengths: torch.Tensor,
                      threshold: float = 6.0) -> torch.Tensor:
    """Dense (B, L, L) float32 0/1 contact map by kernel B3.

    The output equals :func:`batched_contact_maps`, its plain twin.

    Args:
        coords: (B, L, 3) float32 CA coordinates, any L (no padding needed).
        lengths: (B,) int32 true lengths.
        threshold: contact distance threshold in Å; compared as the float32
            ``threshold²``.
    """
    if _route(coords, "contact-map") == "ref":
        return batched_contact_maps(coords, lengths, threshold)
    _check_kernel_inputs(coords, [("lengths", lengths, torch.int32,
                                   (coords.shape[0],))])
    B, L, _ = coords.shape
    out = torch.empty((B, L, L), dtype=torch.float32, device=coords.device)
    if B == 0 or L == 0:
        return out
    lib = _build.load_library()
    code = _launch(coords.device, lib.mdf_contact_map, coords.data_ptr(),
                   lengths.data_ptr(), out.data_ptr(), B, L, _thr2(threshold))
    _build.check(lib, code, "contact_map_fused")
    count_launch(contact_map_fused)
    return out


contact_map_fused.launches = 0
