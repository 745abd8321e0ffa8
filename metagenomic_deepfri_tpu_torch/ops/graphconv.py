"""Fused GraphConv aggregation: coords → masked adjacency → Â·X.

Counterpart of ``metagenomic_deepfri_tpu/ops/graphconv_pallas.py:143-325``.
The (B, L, L) adjacency never exists in device memory: the CUDA kernels in
``csrc/graphconv.cu`` rebuild each tile from the projected CA coordinates
and contract it at once.

Each wrapper routes by the device of its inputs. On a CPU tensor it runs its
plain PyTorch twin (``*_ref``, built on the dense
:func:`.cmap_align.aligned_contacts_from_coords`); on a CUDA tensor it
launches the kernel or raises. There is no fallback from one to the other.
Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``.

Normalisation identity used by :func:`normalized_aggregate`:
``D^{-1/2} A D^{-1/2} X = D^{-1/2} · aggregate(coords, D^{-1/2} ⊙ X)``.
"""

from __future__ import annotations

import numpy as np
import torch

from metagenomic_deepfri_tpu_torch.ops import _build
from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
    aligned_contacts_from_coords

_COMPUTE_DTYPES = ("float32", "bfloat16")
_MAX_GRID_BATCH = 65535  # CUDA grid y/z limit; the batch is a grid axis


def _thr2(threshold: float) -> float:
    """threshold² as the float32 the reference compares against."""
    return float(np.float32(threshold * threshold))


def _check_inputs(coords, ins_mask, lengths, xs=None):
    """Validate device, dtype, shape and contiguity for the CUDA kernels."""
    if coords.dim() != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (B, L, 3), got {tuple(coords.shape)}")
    B, L, _ = coords.shape
    if B > _MAX_GRID_BATCH:
        raise ValueError(f"batch {B} exceeds the kernels' grid limit")
    named = [("coords", coords, torch.float32, (B, L, 3)),
             ("ins_mask", ins_mask, torch.bool, (B, L)),
             ("lengths", lengths, torch.int32, (B,))]
    if xs is not None:
        named.append(("xs", xs, torch.float32, (B, L, xs.shape[-1])))
    for name, t, dtype, shape in named:
        if t.device != coords.device:
            raise ValueError(f"{name} is on {t.device}, coords on "
                             f"{coords.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _route(coords: torch.Tensor) -> str:
    if coords.device.type == "cpu":
        return "ref"
    if coords.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no GraphConv kernel for device {coords.device}")


def contact_degrees_ref(coords, ins_mask, lengths, threshold: float = 6.0,
                        generated_contacts: int = 2) -> torch.Tensor:
    """Plain twin of :func:`contact_degrees`: row sums of the dense map."""
    adj = aligned_contacts_from_coords(coords, ins_mask, lengths,
                                       threshold=threshold,
                                       generated_contacts=generated_contacts)
    return adj.sum(dim=-1)


def graphconv_aggregate_ref(coords, ins_mask, lengths, xs,
                            threshold: float = 6.0,
                            generated_contacts: int = 2,
                            compute_dtype: str = "float32") -> torch.Tensor:
    """Plain twin of :func:`graphconv_aggregate`: dense adjacency and bmm.

    For bfloat16 compute, xs is rounded to bfloat16 and the product taken in
    float32: the {0,1} adjacency is exact, so this is bf16 products with f32
    sums, as in the kernel.
    """
    adj = aligned_contacts_from_coords(coords, ins_mask, lengths,
                                       threshold=threshold,
                                       generated_contacts=generated_contacts)
    xs = xs.to(torch.float32)
    if compute_dtype == "bfloat16":
        xs = xs.to(torch.bfloat16).to(torch.float32)
    return torch.bmm(adj, xs)


def contact_degrees(coords: torch.Tensor, ins_mask: torch.Tensor,
                    lengths: torch.Tensor, threshold: float = 6.0,
                    generated_contacts: int = 2) -> torch.Tensor:
    """Row degrees of the masked aligned adjacency: (B, L) float32.

    Args:
        coords: (B, L, 3) float32 projected CA coords (sentinels unmapped).
        ins_mask: (B, L) bool insertion positions.
        lengths: (B,) int32 true lengths.
    """
    if _route(coords) == "ref":
        return contact_degrees_ref(coords, ins_mask, lengths, threshold,
                                   generated_contacts)
    _check_inputs(coords, ins_mask, lengths)
    B, L, _ = coords.shape
    deg = torch.empty((B, L), dtype=torch.float32, device=coords.device)
    if B == 0 or L == 0:
        return deg
    lib = _build.load_library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        code = lib.mdf_contact_degrees(
            coords.data_ptr(), ins_mask.data_ptr(), lengths.data_ptr(),
            deg.data_ptr(), B, L, _thr2(threshold), int(generated_contacts),
            stream)
    _build.check(lib, code, "contact_degrees")
    contact_degrees.launches += 1
    return deg


def graphconv_aggregate(coords: torch.Tensor, ins_mask: torch.Tensor,
                        lengths: torch.Tensor, xs: torch.Tensor,
                        threshold: float = 6.0, generated_contacts: int = 2,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """out[b, i, :] = Σ_j Â[b, i, j] · xs[b, j, :], Â rebuilt per tile.

    Args:
        coords, ins_mask, lengths: as for :func:`contact_degrees`.
        xs: (B, L, D) float32 node features (already degree-scaled by the
            caller for symmetric normalisation). Any L and D.
        compute_dtype: "float32", or "bfloat16" to round xs to bf16 before
            the (exact) products; sums are float32 either way.

    Returns:
        (B, L, D) float32; rows at or beyond each length are zero.
    """
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    if _route(coords) == "ref":
        return graphconv_aggregate_ref(coords, ins_mask, lengths, xs,
                                       threshold, generated_contacts,
                                       compute_dtype)
    _check_inputs(coords, ins_mask, lengths, xs)
    B, L, _ = coords.shape
    D = xs.shape[-1]
    out = torch.empty((B, L, D), dtype=torch.float32, device=coords.device)
    if B == 0 or L == 0 or D == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        code = lib.mdf_graphconv_aggregate(
            coords.data_ptr(), ins_mask.data_ptr(), lengths.data_ptr(),
            xs.data_ptr(), out.data_ptr(), B, L, D, _thr2(threshold),
            int(generated_contacts), int(compute_dtype == "bfloat16"),
            stream)
    _build.check(lib, code, "graphconv_aggregate")
    graphconv_aggregate.launches += 1
    return out


contact_degrees.launches = 0
graphconv_aggregate.launches = 0


def reset_launch_counts() -> None:
    """Set both kernels' launch counters to 0."""
    contact_degrees.launches = 0
    graphconv_aggregate.launches = 0


def normalized_aggregate(coords, ins_mask, lengths, x,
                         threshold: float = 6.0, generated_contacts: int = 2,
                         adj_norm: str = "sym",
                         degrees: torch.Tensor | None = None,
                         compute_dtype: str = "float32"):
    """Â·x with degree normalisation, fused (no adjacency in device memory).

    ``degrees`` may be passed in to share the degree pass across the
    GraphConv stack (the adjacency is layer-invariant). Semantics match
    ``normalize_adjacency(aligned_contacts_from_coords(...)) @ x``.

    Returns ``(aggregated (B, L, D) float32, degrees (B, L))``.
    """
    if adj_norm not in ("sym", "row", "none"):
        raise ValueError(f"Unknown adjacency normalisation: {adj_norm}")
    if degrees is None:
        degrees = contact_degrees(coords, ins_mask, lengths, threshold,
                                  generated_contacts)

    def agg(v):
        return graphconv_aggregate(coords, ins_mask, lengths, v, threshold,
                                   generated_contacts, compute_dtype)

    if adj_norm == "none":
        return agg(x), degrees
    if adj_norm == "sym":
        inv_sqrt = torch.where(degrees > 0,
                               torch.rsqrt(degrees.clamp_min(1e-12)),
                               torch.zeros_like(degrees))
        y = agg(x * inv_sqrt[:, :, None])
        return y * inv_sqrt[:, :, None], degrees
    inv = torch.where(degrees > 0, 1.0 / degrees.clamp_min(1e-12),
                      torch.zeros_like(degrees))
    return agg(x) * inv[:, :, None], degrees
