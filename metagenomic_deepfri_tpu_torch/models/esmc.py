"""ESM C (ESM Cambrian) as the GCN's residue-LM trunk.

ESM C 600M (EvolutionaryScale, "ESM Cambrian: Revealing the mysteries of
proteins with unsupervised learning", 2024; ``esmc_600m_2024_12``,
``EvolutionaryScale/esmc-600m-2024-12`` on the Hugging Face hub; the
``esm`` package's ``ESMC(d_model=1152, n_heads=18, n_layers=36)``) in place
of DeepFRI's LSTM-LM: its last layer's residue representation feeds the
GCN's embedding merge, as the LSTM-LM's output does
(:func:`..deepfri._merge_embeddings`). The JAX package has no counterpart.
The equations are the ``esm`` package's (``esm/models/esmc.py``,
``esm/layers/transformer_stack.py``, ``blocks.py``, ``attention.py``,
``rotary.py``). For a protein of n residues in a bucket of B positions, on
T = B + 2 token positions:

- tokens ``[<cls>] + esm(seq) + [<eos>]``, right-padded with ``<pad>``:
  ESM-2's ids (:func:`.esm2.esm_tokens`), which ESM C's sequence tokenizer
  keeps (its 64-row embedding has room to spare);
- ``x = E[t]``: no token-dropout scale and no √d;
- each layer, with the residual scale s = √(layers / 36) (1 at 36 layers,
  where nothing is divided): ``h = LN_qkv(x)`` (scale and shift);
  ``[q | k | v] = h·W_qkv``; ``q = LN_q(q)``, ``k = LN_k(k)``, each over the
  full width d before the split into heads, a scale and no shift; rotary
  positions 0…T−1 on q and k in heads of d_h (ESM-2's convention:
  :func:`.esm2._rotary`, :func:`.esm2._rotate`); ``x += softmax(q·kᵀ /
  √d_h)·v·W_o / s`` over each row's n + 2 valid keys, the softmax in
  float32; ``h = LN_ffn(x)`` (scale and shift); ``[a | b] = h·W_1``;
  ``x += (silu(a) ⊙ b)·W_2 / s``; no bias in any projection;
- ``LN_final(x)`` (a scale, no shift), and the residue representation
  ``x[:, 1:B+1]``.

Every row keeps its ``<cls>`` and ``<eos>`` keys, an empty padding row of
the engine's batches too (n = 0), so no softmax row is fully masked and
every position stays finite. The batch's counters are ESM-2's
(:func:`.esm2.trunk_counts`: n + 2 tokens a protein).

The tree (kernels stored (in, out), as everywhere in the port)::

    {"embed": (vocab, d),
     "layers": [{"ln_qkv": {"scale", "bias"},
                 "qkv": {"kernel": (d, 3d)},     # [q | k | v]
                 "q_ln": {"scale"}, "k_ln": {"scale"},
                 "out": {"kernel": (d, d)},
                 "ln_ffn": {"scale", "bias"},
                 "fc1": {"kernel": (d, 2F)},     # [gate | up]
                 "fc2": {"kernel": (F, d)}}, ...],
     "ln_final": {"scale"}}

:func:`..convert.esmc_from_state_dict` builds it from the ``esm`` package's
key layout. Device spans: a layer's ``model/esmc/attn`` (LN_qkv through the
residual add), inside it ``model/esmc/qkln`` (q's and k's LayerNorms,
rotary and q's scale, counting ``tokens``) and ``model/esmc/sdpa`` (the
attention core alone, :func:`..ops.attention.attend`), and
``model/esmc/ffn``; each of the four projections under ``model/esmc/gemm``
inside those. On a CUDA device in float32 with TF32 off the projections run
on E1 (:mod:`..ops.esm_gemm`: its bias-free instances, the residual add and
SwiGLU in its epilogue) and the attention on E2 (:mod:`..ops.attention`,
ESM-2's instance at heads of 64); elsewhere ``torch.mm``, PyTorch's SiLU
and E2's plain twin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from metagenomic_deepfri_tpu_torch.models.esm2 import (_rotary, _rotate,
                                                       esm_tokens)
from metagenomic_deepfri_tpu_torch.ops.attention import attend
from metagenomic_deepfri_tpu_torch.ops.esm_gemm import project
from metagenomic_deepfri_tpu_torch.profiling import (count, device_span,
                                                      recording)

# The span of each projection (:func:`..ops.esm_gemm.project`).
GEMM_SPAN = "model/esmc/gemm"


@dataclass(frozen=True)
class ESMCConfig:
    """The trunk's widths; the defaults are ESM C 600M's
    (``ESMC(d_model=1152, n_heads=18, n_layers=36)``, SwiGLU width
    ⌈(8/3·d)/256⌉·256)."""
    layers: int = 36
    dim: int = 1152
    heads: int = 18
    ffn: int = 3072
    vocab: int = 64
    rope_base: float = 10000.0
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def residual_scale(self) -> float:
        """s = √(layers / 36), by which each residual branch is divided."""
        return math.sqrt(self.layers / 36)


def _norm(p: dict, x: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    """LayerNorm over the last axis, with the shift where ``p`` has one."""
    bias = p.get("bias")
    return F.layer_norm(x, x.shape[-1:], p["scale"].to(dtype),
                        None if bias is None else bias.to(dtype), eps)


def _qk(p: dict, q: torch.Tensor, k: torch.Tensor, config: ESMCConfig,
        cos, sin, tokens, dtype) -> tuple:
    """q's and k's LayerNorms over the full width, rotary in heads and q's
    1/√d_h, under ``model/esmc/qkln``; each (B, H, T, d_h)."""
    B, T, _ = q.shape
    H, hd = config.heads, config.head_dim
    with device_span("model/esmc/qkln", q.device):
        if tokens is not None:
            count(tokens=tokens)

        def heads(t, ln):
            t = _norm(p[ln], t, config.ln_eps, dtype)
            return t.view(B, T, H, hd).transpose(1, 2)

        q = _rotate(heads(q, "q_ln"), cos, sin) * hd ** -0.5
        k = _rotate(heads(k, "k_ln"), cos, sin)
    return q, k


def _residual(p: dict, h: torch.Tensor, x: torch.Tensor, s: float,
              dtype) -> torch.Tensor:
    """``x + h·W / s``: the residual add in E1's epilogue where s is 1."""
    if s == 1.0:
        return project(p, h, dtype, GEMM_SPAN, "residual", x)
    return x + project(p, h, dtype, GEMM_SPAN) / s


def _layer(p: dict, x: torch.Tensor, config: ESMCConfig, n: torch.Tensor,
           counts, tokens, cos, sin, dtype) -> torch.Tensor:
    B, T, d = x.shape
    H, hd = config.heads, config.head_dim
    s = config.residual_scale
    with device_span("model/esmc/attn", x.device):
        h = _norm(p["ln_qkv"], x, config.ln_eps, dtype)
        q, k, v = project(p["qkv"], h, dtype, GEMM_SPAN).split(d, dim=-1)
        q, k = _qk(p, q, k, config, cos, sin, tokens, dtype)
        v = v.view(B, T, H, hd).transpose(1, 2)
        a = attend(q, k, v, n, "model/esmc/sdpa", counts=counts)
        x = _residual(p["out"], a, x, s, dtype)
    with device_span("model/esmc/ffn", x.device):
        h = _norm(p["ln_ffn"], x, config.ln_eps, dtype)
        h = project(p["fc1"], h, dtype, GEMM_SPAN, "swiglu")
        x = _residual(p["fc2"], h, x, s, dtype)
    return x


def esmc_forward(params: dict, config: ESMCConfig, tokens: torch.Tensor,
                 lengths: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L, d) residue representation of a right-padded (B, L) batch of
    the port's tokens, computed in ``dtype`` (float32, or float64 for the
    reference precision). Positions past a protein's length hold finite
    values that no real position depends on."""
    ids = esm_tokens(tokens, lengths)
    T = ids.shape[1]
    n = lengths.to(torch.int32) + 2
    x = params["embed"].to(dtype)[ids]
    counts = real = None
    if recording():
        counts = n.tolist()
        real = sum(c for c in counts if c > 2)
    cos, sin = _rotary(T, config.head_dim, config.rope_base, ids.device,
                       dtype)
    for p in params["layers"]:
        x = _layer(p, x, config, n, counts, real, cos, sin, dtype)
    x = _norm(params["ln_final"], x, config.ln_eps, dtype)
    return x[:, 1:T - 1]


def init_esmc(config: ESMCConfig, generator: torch.Generator,
              device) -> dict:
    """A random trunk: Glorot-uniform kernels, the embedding uniform in
    (−1, 1), LayerNorm scales in (0.8, 1.2) and shifts in ±0.1 (so that a
    dropped one shows in a comparison). With q and k normalised, a head's
    logits have σ ≈ 1 whatever the kernels' scale."""
    def u(shape, scale, offset=0.0):
        r = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        return ((r * 2.0 - 1.0) * scale + offset).to(device)

    def dense(i, o):
        return {"kernel": u((i, o), math.sqrt(6.0 / (i + o)))}

    def norm(shift=True):
        p = {"scale": u((config.dim,), 0.2, 1.0)}
        if shift:
            p["bias"] = u((config.dim,), 0.1)
        return p

    d, f = config.dim, config.ffn
    return {"embed": u((config.vocab, d), 1.0),
            "layers": [{"ln_qkv": norm(), "qkv": dense(d, 3 * d),
                        "q_ln": norm(False), "k_ln": norm(False),
                        "out": dense(d, d), "ln_ffn": norm(),
                        "fc1": dense(d, 2 * f), "fc2": dense(f, d)}
                       for _ in range(config.layers)],
            "ln_final": norm(False)}
