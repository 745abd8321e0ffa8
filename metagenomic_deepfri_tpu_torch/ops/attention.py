"""Float32-exact attention on the tensor cores for the transformer trunks.

``softmax(q·kᵀ + bias)·v`` over each row's valid keys, for ESM-2 (heads of
64, ``q`` already scaled and rotated, no bias; :mod:`..models.esm2`) and
ProtT5 (heads of 128, no scale, T5's relative-position bias;
:mod:`..models.prott5`). The CUDA kernel E2 (``csrc/attention.cu``)
replaces no TPU kernel, as the JAX package has no transformer trunk: it
replaces PyTorch's fused attention call (SDPA), whose float32 path ran
on the CUDA cores over every padded pair of a batch.

Every float32 operand is split exactly into three bfloat16 planes and six
of the nine plane products are summed in float32, as E1
(:mod:`.esm_gemm`) does; the tensor cores sum at most 64 of k at a time.
The kernel reads q, k and v through their strides, takes each row's valid
token count in place of an additive mask, computes only the 64-key tiles
that hold valid keys and the 64-query tiles that hold valid queries
(zeros elsewhere), and makes ProtT5's bias from the (buckets, H) table and
an int8 table of each distance's bucket (:func:`..models.prott5.
distance_buckets`). It writes (B, T, H·D), the layout the output projection
reads.

:func:`attention` launches the kernel on CUDA tensors or raises; its plain
twin is :func:`attention_ref`. Whether a call takes the kernel is
:func:`attention_active`'s call, made on what the call can observe, and
:func:`attend` makes it for a trunk's layer. Launches are counted in
``attention.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from metagenomic_deepfri_tpu_torch.ops import _build
from metagenomic_deepfri_tpu_torch.ops.contact import _launch, count_launch
from metagenomic_deepfri_tpu_torch.precision import \
    highest_f32_precision_active
from metagenomic_deepfri_tpu_torch.profiling import (count, device_span,
                                                      recording)

HEAD_DIMS = (64, 128)   # the kernel's instances
TILE = 64               # queries and keys a tile
# The longest sequence whose bias the kernel gathers into shared memory
# (beside 193 KB of planes at heads of 128).
MAX_BIAS_T = 8192


def attention_active(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias=None) -> bool:
    """Whether the attention takes E2: q, k and v float32 on a CUDA device
    with heads of 64 or 128, float32 matmuls in full precision (TF32 off,
    precision "highest"), no gradient to track (the kernel has no
    backward), and a bias only up to :data:`MAX_BIAS_T` positions."""
    return (q.device.type == "cuda"
            and all(t.dtype == torch.float32 for t in (q, k, v))
            and q.shape[-1] in HEAD_DIMS
            and (bias is None or q.shape[2] <= MAX_BIAS_T)
            and highest_f32_precision_active()
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (q, k, v))))


def _bias_of(bias, T: int, dtype) -> torch.Tensor:
    """(H, T, T) ``R[bucket(j − i), h]`` from ``bias = (R, buckets)``."""
    rel, buckets = bias
    pos = torch.arange(T, device=rel.device)
    at = buckets.to(rel.device, torch.int64)[pos[None, :] - pos[:, None]
                                             + T - 1]
    return rel.to(dtype)[at].permute(2, 0, 1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, bias=None) -> torch.Tensor:
    """Plain twin of :func:`attention`, in the working dtype: q·kᵀ, plus
    the gathered bias, keys at or past each row's valid count at −inf, the
    softmax, then ·v, every query row computed; (B, T, H·D)."""
    B, H, T, D = q.shape
    s = q @ k.transpose(-1, -2)
    if bias is not None:
        s = s + _bias_of(bias, T, s.dtype)
    keys = (torch.arange(T, device=q.device)[None, :]
            < valid.to(q.device, torch.int64)[:, None])
    s = s.masked_fill(~keys[:, None, None, :], float("-inf"))
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, T,
                                                                  H * D)


def _ready(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads it: the last dimension contiguous, 16-byte
    aligned rows; a copy only where the view is not."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor, bias=None) -> torch.Tensor:
    """(B, T, H·D) float32 attention by E2, every tensor on q's CUDA
    device. Rows at or past a row's valid count hold finite values (zeros
    in a 64-query tile that starts there), which no valid row reads.

    Args:
        q, k, v: (B, H, T, D) float32, D 64 or 128, any strides with the
            last dimension contiguous (views of a fused projection's
            output are read in place).
        valid: (B,) integer valid token counts (keys and queries below it
            count).
        bias: None, or ``(R, buckets)``: R (n_buckets, H) float32 and
            ``buckets`` (2T − 1,) int8, the bucket of distance j − i at
            j − i + T − 1.
    """
    B, H, T, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or valid.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and valid {tuple(valid.shape)} "
                         "do not fit")
    if D not in HEAD_DIMS:
        raise ValueError(f"no attention kernel for heads of {D}")
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    rel = buckets = None
    if bias is not None:
        rel, buckets = bias
        if rel.dim() != 2 or rel.shape[1] != H or buckets.shape != (2 * T - 1,):
            raise ValueError(f"bias table {tuple(rel.shape)} and buckets "
                             f"{tuple(buckets.shape)} do not fit H {H}, T {T}")
        if buckets.dtype != torch.int8:
            raise TypeError(f"buckets must be int8, got {buckets.dtype}")
        if T > MAX_BIAS_T:
            raise ValueError(f"a bias takes at most {MAX_BIAS_T} positions")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid),
                    ("rel", rel), ("buckets", buckets)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("rel", rel)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    q, k, v = _ready(q), _ready(k), _ready(v)
    valid = valid.to(torch.int32).contiguous()
    if rel is not None:
        rel, buckets = rel.contiguous(), buckets.contiguous()
    out = torch.empty((B, T, H * D), dtype=torch.float32, device=q.device)
    if B == 0 or H == 0:
        return out
    strides = (ctypes.c_longlong * 9)(
        *(s for t in (q, k, v) for s in (t.stride(0), t.stride(1),
                                         t.stride(2))))
    lib = _build.load_library()
    code = _launch(q.device, lib.mdf_attention, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), valid.data_ptr(),
                   0 if rel is None else rel.data_ptr(),
                   0 if buckets is None else buckets.data_ptr(), strides,
                   B, H, T, D)
    _build.check(lib, code, "attention")
    count_launch(attention)
    return out


attention.launches = 0


def tile_pairs(valid: list, T: int) -> int:
    """The query-key pairs E2 computes for each head over rows of these
    valid counts: (64·⌈n/64⌉)² a row (n at most T)."""
    return sum((TILE * -(-min(n, T) // TILE)) ** 2 for n in valid)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor, span: str, bias=None,
           counts: list | None = None) -> torch.Tensor:
    """A trunk layer's attention, (B, T, H·D), under the device span
    ``span`` with the counters ``split`` (1 where E2 ran,
    :func:`attention_active`; 0 where its twin did) and ``pairs`` (the
    query-key pairs a head computed: :func:`tile_pairs` of ``counts``, the
    host's copy of ``valid``, under E2; B·T² under the twin). ``counts``
    is needed only while spans are recorded."""
    split = attention_active(q, k, v, bias)
    with device_span(span, q.device):
        if recording():
            B, _, T, _ = q.shape
            count(split=int(split),
                  pairs=tile_pairs(counts, T) if split else B * T * T)
        if split:
            return attention(q, k, v, valid, bias)
        return attention_ref(q, k, v, valid, bias)
