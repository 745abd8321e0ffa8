"""Float32-exact GEMM on the tensor cores for the transformer trunks'
projections.

``y = epilogue(x·W + b)``, or ``epilogue(x·W)`` without a bias, for
ESM-2's ``qkv``, ``out``, ``fc1`` and ``fc2`` (:mod:`..models.esm2`),
ProtT5's bias-free ``qkv``, ``o``, ``wi`` and ``wo``
(:mod:`..models.prott5`) and ESM C's bias-free ``qkv``, ``out``, ``fc1``
(gated: ``silu(a) ⊙ b`` of its two halves) and ``fc2``
(:mod:`..models.esmc`). The CUDA kernel (``csrc/esm_gemm.cu``) replaces
no TPU kernel: it exists because PyTorch runs a float32 matmul with TF32
off on the CUDA cores, where the trunks' GEMMs took ~80 % of an ESM-2
cell's device time.

Every float32 operand is split exactly into three bfloat16 planes, hi + mid
+ lo (:func:`.graphconv._split_bf16x3`, B1's split), and six of the nine
plane products are summed in float32: hi·hi, hi·mid, mid·hi, hi·lo,
mid·mid, lo·hi. Each dropped product is at most 2⁻²⁴·|x|·|w| a term,
float32's unit roundoff. W's planes are made once per kernel tensor and
kept while it lives (:func:`weight_planes`); x is split inside the kernel.
For the gated epilogue ``"swiglu"`` the planes hold W's gate and up columns
interleaved in blocks of 64 (:func:`interleave_swiglu`), so that each of the
kernel's 128-column tiles holds 64 gate columns and their 64 up columns and
writes 64 columns of ``silu(a) ⊙ b`` (:func:`swiglu_tiles` is that store in
plain PyTorch).

:func:`esm_gemm` launches the kernel on CUDA tensors or raises; its plain
twin is :func:`esm_gemm_ref` (the same planes, the same six products,
float32 sums). Whether a projection takes the kernel at all is
:func:`split_gemm_active`'s call, made on what the call can observe, and
:func:`project` makes it for a trunk's layer. It counts its launches in
``esm_gemm.launches``.
"""

from __future__ import annotations

import threading
import weakref

import torch
import torch.nn.functional as F

from metagenomic_deepfri_tpu_torch.ops import _build
from metagenomic_deepfri_tpu_torch.ops.contact import _launch, count_launch
from metagenomic_deepfri_tpu_torch.ops.graphconv import _split_bf16x3
from metagenomic_deepfri_tpu_torch.precision import \
    highest_f32_precision_active
from metagenomic_deepfri_tpu_torch.profiling import (count, device_span,
                                                      recording)

# The kernel's epilogues, as its C entry point numbers them ("bias": nothing
# after the product and its bias, if any; "swiglu": ``silu(a) ⊙ b`` of the
# product's halves ``[a | b]``, half as wide as the product).
EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2, "relu": 3, "swiglu": 4}
_PLANE_ALIGN = 8  # the planes' row length, in bf16 elements (16 bytes)
# Gate columns, and as many up columns, of each 128-column tile of the
# "swiglu" planes.
SWIGLU_BLOCK = 64


def split_gemm_active(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``x·w`` takes the split kernel: x on a CUDA device, both
    float32, float32 matmuls in full precision (TF32 off, precision
    "highest", :func:`..precision.highest_f32_precision_active`), and no
    gradient to track (the kernel has no backward)."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and w.dtype == torch.float32
            and highest_f32_precision_active()
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or w.requires_grad)))


def split_planes(w: torch.Tensor) -> torch.Tensor:
    """(K, N) float32 kernel → its (3, N, Kp) bfloat16 planes hi, mid, lo,
    K-major, each row zero-padded to Kp, K rounded up to a multiple of 8
    (a tensor map's rows are whole 16-byte units)."""
    K, N = w.shape
    Kp = -(-K // _PLANE_ALIGN) * _PLANE_ALIGN
    planes = torch.zeros((3, N, Kp), dtype=torch.bfloat16, device=w.device)
    for p, plane in zip(planes, _split_bf16x3(w.detach().t())):
        p[:, :K] = plane
    return planes


def interleave_swiglu(w: torch.Tensor) -> torch.Tensor:
    """(K, 2F) ``[gate | up]`` kernel → (K, 2·Fp), Fp = F rounded up to a
    multiple of :data:`SWIGLU_BLOCK`: 64 gate columns, then the same 64
    up columns, and so on, zeros past F."""
    K, N = w.shape
    if N % 2:
        raise ValueError(f"a gated kernel has an even width, got {N}")
    F_ = N // 2
    Fp = -(-F_ // SWIGLU_BLOCK) * SWIGLU_BLOCK
    gate, up = (F.pad(h, (0, Fp - F_)).view(K, Fp // SWIGLU_BLOCK, 1,
                                            SWIGLU_BLOCK)
                for h in (w[:, :F_], w[:, F_:]))
    return torch.cat([gate, up], dim=2).reshape(K, 2 * Fp)


def swiglu_tiles(y: torch.Tensor, width: int) -> torch.Tensor:
    """The gated epilogue on a product of :func:`interleave_swiglu`'s
    columns, (M, 2·Fp) → (M, ``width``), as the kernel stores it: each
    64 gate columns paired with the 64 up columns that follow them."""
    M = y.shape[0]
    blocks = y.view(M, -1, 2, SWIGLU_BLOCK)
    out = F.silu(blocks[:, :, 0]) * blocks[:, :, 1]
    return out.reshape(M, -1)[:, :width]


_planes: dict = {}
_planes_lock = threading.Lock()


def weight_planes(w: torch.Tensor, epilogue: str = "bias") -> torch.Tensor:
    """:func:`split_planes` of ``w`` (of :func:`interleave_swiglu`'s
    columns for the ``"swiglu"`` epilogue), made once per kernel tensor and
    layout: kept by the tensor's identity while it lives, and made anew if
    it was changed in place (its version counter moved; an inference
    tensor has none and cannot be changed in place)."""
    gated = epilogue == "swiglu"
    key = (id(w), gated)
    version = 0 if w.is_inference() else w._version
    with _planes_lock:
        got = _planes.get(key)
    if got is not None and got[0]() is w and got[1] == version:
        return got[2]
    planes = split_planes(interleave_swiglu(w.detach()) if gated else w)
    ref = weakref.ref(w, lambda _, key=key: _planes.pop(key, None))
    with _planes_lock:
        _planes[key] = (ref, version, planes)
    return planes


def _apply(y: torch.Tensor, epilogue: str,
           residual: torch.Tensor | None) -> torch.Tensor:
    """The epilogue after the product and its bias, as PyTorch computes
    it."""
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "relu":
        return torch.relu(y)
    if epilogue == "residual":
        return residual + y
    if epilogue == "swiglu":
        a, b = y.chunk(2, dim=-1)
        return F.silu(a) * b
    return y


def esm_gemm_ref(x: torch.Tensor, planes: torch.Tensor,
                 bias: torch.Tensor | None, epilogue: str = "bias",
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of :func:`esm_gemm`: x's planes and W's, the six products
    each a float32 matmul, summed in float32 smallest first, then the bias
    (if any) and the epilogue."""
    K = x.shape[-1]
    xs = [v.to(torch.float32) for v in _split_bf16x3(x)]
    ws = [v[:, :K].t().to(torch.float32) for v in planes]
    y = None
    for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        term = xs[i] @ ws[j]
        y = term if y is None else y + term
    if bias is not None:
        y = y + bias.to(torch.float32)
    return _apply(y, epilogue, residual)


def esm_gemm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
             epilogue: str = "bias",
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """(M, N) float32 ``epilogue(x·w + bias)`` (``epilogue(x·w)`` where
    ``bias`` is None; (M, N/2) for ``"swiglu"``) from the planes of ``w``,
    by the kernel; every tensor on x's CUDA device.

    Args:
        x: (M, K) float32, K ≥ 1.
        w: (K, N) float32 kernel, stored (in, out) as the port stores
            dense kernels; its planes come from :func:`weight_planes`.
        bias: (N,) float32, or None: the kernel instance without a bias
            then runs, and no zeros are read.
        epilogue: "bias" (nothing more), "gelu" (erf GELU after the bias,
            as ``F.gelu``), "relu" (``torch.relu``), "residual"
            (``residual + (x·w + bias)``) or "swiglu" (``F.silu(a) * b``
            of ``[a | b] = x·w``, w of an even width; no bias).
        residual: (M, N) float32, for the "residual" epilogue only.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {tuple(EPILOGUES)}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("a residual goes with the 'residual' epilogue only")
    gated = epilogue == "swiglu"
    if gated and (bias is not None or w.shape[1] % 2):
        raise ValueError("the 'swiglu' epilogue takes a kernel of an even "
                         "width and no bias")
    M, K = x.shape
    N = w.shape[1]
    if (w.shape[0] != K or K < 1
            or (bias is not None and bias.shape != (N,))):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and bias "
                         f"{None if bias is None else tuple(bias.shape)} do "
                         "not fit")
    if x.device.type != "cuda":
        raise ValueError(f"no split GEMM kernel for device {x.device}")
    for name, t in (("x", x), ("w", w), ("bias", bias),
                    ("residual", residual)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if residual is not None and residual.shape != (M, N):
        raise ValueError(f"residual must have shape {(M, N)}, got "
                         f"{tuple(residual.shape)}")
    planes = weight_planes(w, epilogue)
    # TMA reads rows of whole 16-byte units from a 16-byte aligned start.
    if K % 4 or not x.is_contiguous() or x.data_ptr() % 16:
        x = F.pad(x, (0, -K % 4)).contiguous()
    bias = None if bias is None else bias.contiguous()
    residual = None if residual is None else residual.contiguous()
    # The gated instance is told the width it writes, and reads its
    # planes' interleaved width from it.
    N = N // 2 if gated else N
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return y
    lib = _build.load_library()
    code = _launch(x.device, lib.mdf_esm_gemm, x.data_ptr(),
                   planes.data_ptr(), 0 if bias is None else bias.data_ptr(),
                   0 if residual is None else residual.data_ptr(),
                   y.data_ptr(), M, N, K, x.shape[1], planes.shape[2],
                   EPILOGUES[epilogue])
    _build.check(lib, code, "esm_gemm")
    count_launch(esm_gemm)
    return y


esm_gemm.launches = 0


def project(p: dict, x: torch.Tensor, dtype, span: str,
            epilogue: str = "bias",
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """One projection of a trunk's layer: ``x·W`` (+ ``p["bias"]`` where
    the layer has one), then the epilogue, under the device span ``span``
    with the counters ``rows``, ``k``, ``n`` and ``split``: 1 where the
    split kernel ran (:func:`split_gemm_active`), 0 where ``torch.addmm``
    (``torch.mm`` without a bias) and PyTorch's epilogue did."""
    w, b = p["kernel"], p.get("bias")
    x2 = x.reshape(-1, x.shape[-1])
    split = split_gemm_active(x2, w)
    with device_span(span, x.device):
        if recording():
            count(rows=x2.shape[0], k=x2.shape[1], n=w.shape[1],
                  split=int(split))
        res = None if residual is None else residual.reshape(-1, w.shape[1])
        if split:
            y = esm_gemm(x2, w, b, epilogue, res)
        elif b is None:
            y = _apply(torch.mm(x2, w.to(dtype)), epilogue, res)
        else:
            y = _apply(torch.addmm(b.to(dtype), x2, w.to(dtype)), epilogue,
                       res)
    return y.view(*x.shape[:-1], -1)
