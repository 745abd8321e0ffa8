"""ESM-2, the protein language model, as the GCN's residue-LM trunk.

ESM-2 (Lin et al., Science 379:1123, 2023; ``esm2_t33_650M_UR50D`` of
github.com/facebookresearch/esm, ``facebook/esm2_t33_650M_UR50D`` on the
Hugging Face hub) in place of DeepFRI's LSTM-LM: its last layer's residue
representation feeds the GCN's embedding merge, as the LSTM-LM's output
does (:func:`..deepfri._merge_embeddings`). The JAX package has no
counterpart.

For a protein of L residues in a bucket of B positions, on T = B + 2 token
positions:

- tokens ``[<cls>] + esm(seq) + [<eos>]``, right-padded with ``<pad>``,
  over the 33-token ESM-1b alphabet (:data:`ESM_ALPHABET`; the port's 26
  letters map through :data:`PORT_TO_ESM`);
- ``x = E[t] · 0.88``, zero at ``<pad>``: the inference-time token-dropout
  scale ``(1 − 0.15·0.8) / (1 − r)``, where r, the share of ``<mask>``
  among a row's tokens, is 0 because the port's alphabet has no ``<mask>``;
- each of the layers, pre-LayerNorm: ``h = LN₁(x)``; ``q = (hW_q + b_q) ·
  d_h^-½``, ``k = hW_k + b_k``, ``v = hW_v + b_v`` in heads of d_h; rotary
  positions 0…T−1 on q and k (``inv_freq = base^(−2i/d_h)``, the
  frequencies repeated, ``x·cos + rotate_half(x)·sin``); ``x +=
  softmax(qkᵀ)·v · W_o + b_o`` over each row's L + 2 valid keys, the
  softmax in float32; ``x += GELU_erf(LN₂(x)W_1 + b_1)W_2 + b_2``;
- ``LN_after(x)``, and the residue representation ``x[:, 1:B+1]``.

Every row keeps its ``<cls>`` and ``<eos>`` keys, an empty padding row of
the engine's batches too (L = 0), so no softmax row is fully masked and
every position stays finite: a NaN at a padded position would reach the
real ones through the dense route's ``0·NaN``.

The tree (dense kernels stored (in, out), as everywhere in the port)::

    {"embed": (33, d),
     "layers": [{"ln1": {"scale", "bias"},
                 "qkv": {"kernel": (d, 3d), "bias": (3d,)},   # [q | k | v]
                 "out": {"kernel": (d, d), "bias": (d,)},
                 "ln2": {"scale", "bias"},
                 "fc1": {"kernel": (d, F), "bias": (F,)},
                 "fc2": {"kernel": (F, d), "bias": (d,)}}, ...],
     "ln_after": {"scale", "bias"}}

:func:`..convert.esm2_from_hf_state_dict` builds it from the published
checkpoint's Hugging Face key layout. Each layer runs under the device
spans ``model/esm/attn`` (LN₁ through the residual add), ``model/esm/sdpa``
inside it (softmax(qkᵀ)v alone, :func:`..ops.attention.attend`) and
``model/esm/ffn``; each of its four projections under ``model/esm/gemm``
inside those (:func:`_linear`).

On a CUDA device in float32 with TF32 off, the projections run on the
tensor cores from three bf16 planes a float32 operand
(:mod:`..ops.esm_gemm`), with the bias, GELU and residual add in the
kernel's epilogue, and the attention on E2 (:mod:`..ops.attention`, the
same planes, only the 64-token tiles that hold valid tokens); elsewhere
``torch.addmm``, PyTorch's GELU and add, and E2's plain twin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from metagenomic_deepfri_tpu_torch.ops.attention import attend
from metagenomic_deepfri_tpu_torch.ops.esm_gemm import project
from metagenomic_deepfri_tpu_torch.ops.one_hot import ALPHABET
from metagenomic_deepfri_tpu_torch.profiling import device_span, recording

# The ESM-1b alphabet of ESM-2, ids 0-32.
ESM_ALPHABET = ("<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V",
                "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F", "Y",
                "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
                "<null_1>", "<mask>")
CLS, PAD, EOS = 0, 1, 2
# The ESM id of each of the port's 26 tokens (ops.one_hot.ALPHABET order).
PORT_TO_ESM = np.array([ESM_ALPHABET.index(c) for c in ALPHABET], np.int64)
# (1 − 0.15·0.8) / (1 − r) with r = 0: no token of the port is <mask>.
TOKEN_DROPOUT_SCALE = 1.0 - 0.15 * 0.8


@dataclass(frozen=True)
class ESM2Config:
    """The trunk's widths; the defaults are ``esm2_t33_650M_UR50D``'s."""
    layers: int = 33
    dim: int = 1280
    heads: int = 20
    ffn: int = 5120
    vocab: int = len(ESM_ALPHABET)
    rope_base: float = 10000.0
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def esm_tokens(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T = L + 2) int64 ESM ids of a right-padded (B, L) batch of the
    port's tokens: ``<cls>``, the residues, ``<eos>`` at ``length + 1``,
    ``<pad>`` after it."""
    B, L = tokens.shape
    table = torch.as_tensor(PORT_TO_ESM, device=tokens.device)
    pos = torch.arange(L, device=tokens.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    body = torch.where(pos < n, table[tokens.to(torch.int64)], PAD)
    ids = torch.full((B, L + 2), PAD, dtype=torch.int64, device=tokens.device)
    ids[:, 0] = CLS
    ids[:, 1:L + 1] = body
    ids.scatter_(1, n + 1, EOS)
    return ids


def _rotary(T: int, head_dim: int, base: float, device, dtype):
    """(cos, sin), each (T, head_dim): position t's angles, the
    frequencies repeated as ``cat(freqs, freqs)``."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, device=device,
                                            dtype=torch.float32) / head_dim))
    freqs = torch.outer(torch.arange(T, device=device, dtype=torch.float32),
                        inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """``x·cos + rotate_half(x)·sin`` over the last axis."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _linear(p: dict, x: torch.Tensor, dtype, epilogue: str = "bias",
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """``x·W + b``, then GELU (``epilogue="gelu"``) or ``residual +``
    (``"residual"``), under the device span ``model/esm/gemm``
    (:func:`..ops.esm_gemm.project`)."""
    return project(p, x, dtype, "model/esm/gemm", epilogue, residual)


def _norm(p: dict, x: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"].to(dtype),
                        p["bias"].to(dtype), eps)


def _layer(p: dict, x: torch.Tensor, config: ESM2Config,
           n: torch.Tensor, counts, cos, sin, dtype) -> torch.Tensor:
    B, T, _ = x.shape
    H, hd = config.heads, config.head_dim
    with device_span("model/esm/attn", x.device):
        h = _norm(p["ln1"], x, config.ln_eps, dtype)
        q, k, v = _linear(p["qkv"], h, dtype).view(B, T, 3, H, hd).permute(
            2, 0, 3, 1, 4)
        q = _rotate(q * hd ** -0.5, cos, sin)
        k = _rotate(k, cos, sin)
        a = attend(q, k, v, n, "model/esm/sdpa", counts=counts)
        x = _linear(p["out"], a, dtype, "residual", x)
    with device_span("model/esm/ffn", x.device):
        h = _norm(p["ln2"], x, config.ln_eps, dtype)
        h = _linear(p["fc1"], h, dtype, "gelu")
        x = _linear(p["fc2"], h, dtype, "residual", x)
    return x


def esm2_forward(params: dict, config: ESM2Config, tokens: torch.Tensor,
                 lengths: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L, d) residue representation of a right-padded (B, L) batch of
    the port's tokens, computed in ``dtype`` (float32, or float64 for the
    reference precision). Positions past a protein's length hold finite
    values that no real position depends on."""
    ids = esm_tokens(tokens, lengths)
    B, T = ids.shape
    n = lengths.to(torch.int32) + 2
    valid = torch.arange(T, device=ids.device)[None, :] < n[:, None]
    x = params["embed"].to(dtype)[ids] * TOKEN_DROPOUT_SCALE
    x = x * valid[:, :, None].to(dtype)
    counts = n.tolist() if recording() else None
    cos, sin = _rotary(T, config.head_dim, config.rope_base, ids.device,
                       dtype)
    for p in params["layers"]:
        x = _layer(p, x, config, n, counts, cos, sin, dtype)
    x = _norm(params["ln_after"], x, config.ln_eps, dtype)
    return x[:, 1:T - 1]


def trunk_counts(lengths: torch.Tensor, bucket: int) -> dict:
    """The counters of one batch over its real proteins (length > 0):
    ``tokens`` Σ(L+2), ``slots`` B·T (every row, T = bucket + 2) and
    ``attn_pairs`` Σ(L+2)²."""
    n = [int(v) + 2 for v in lengths.tolist() if v > 0]
    return {"tokens": sum(n), "slots": len(lengths) * (bucket + 2),
            "attn_pairs": sum(v * v for v in n)}


def init_esm2(config: ESM2Config, generator: torch.Generator,
              device) -> dict:
    """A random trunk: Glorot-uniform kernels, and biases and LayerNorm
    affines drawn away from 0 and 1 (so that a dropped bias or scale
    shows in a comparison)."""
    def u(shape, scale, offset=0.0):
        r = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        return ((r * 2.0 - 1.0) * scale + offset).to(device)

    def dense(i, o):
        return {"kernel": u((i, o), math.sqrt(6.0 / (i + o))),
                "bias": u((o,), 0.1)}

    def norm(n):
        return {"scale": u((n,), 0.2, 1.0), "bias": u((n,), 0.1)}

    d, f = config.dim, config.ffn
    return {"embed": u((config.vocab, d), 1.0),
            "layers": [{"ln1": norm(d), "qkv": dense(d, 3 * d),
                        "out": dense(d, d), "ln2": norm(d),
                        "fc1": dense(d, f), "fc2": dense(f, d)}
                       for _ in range(config.layers)],
            "ln_after": norm(d)}
