"""ProtT5-XL-UniRef50's encoder as the GCN's residue-LM trunk.

ProtT5-XL-UniRef50 (Elnaggar et al., "ProtTrans", IEEE TPAMI 44:7112,
2022; ``Rostlab/prot_t5_xl_uniref50`` on the Hugging Face hub), encoder
only, in place of DeepFRI's LSTM-LM: its last layer's residue
representation feeds the GCN's embedding merge, as the LSTM-LM's output
does (:func:`..deepfri._merge_embeddings`). The JAX package has no
counterpart. The equations are T5 v1.0's, as ``transformers.T5EncoderModel``
computes them. For a protein of n residues in a bucket of B positions, on
T = B + 1 token positions:

- tokens: the residues over ProtT5's vocabulary (the port's 26 letters map
  through :data:`PORT_TO_T5`; U, Z, O and B as X, as the ProtTrans README
  prepares sequences), ``</s>`` at n, right-padded with ``<pad>``; no
  start token;
- ``x = E[t]``, no scale;
- the relative-position bias ``bias[h, i, j] = R[bucket(j − i), h]``,
  one for all layers (R is layer 0's): T5's bidirectional buckets
  (:func:`relative_position_bucket`), exact below 8, log-spaced to 128;
- each layer: ``h = RMS₁(x)`` (``w · x / sqrt(mean(x²) + eps)``, no mean
  subtracted, no shift); ``q, k, v = h·W_q, h·W_k, h·W_v`` in heads of
  ``d_kv`` (the inner width H·d_kv is not d); ``x += softmax(q·kᵀ + bias,
  padded keys at −inf)·v·W_o`` with no 1/√d_kv scale and the softmax in
  float32; ``x += relu(RMS₂(x)·W_i)·W_o'``; no bias anywhere;
- ``RMS_final(x)``, and the residue representation ``x[:, :n]`` (``</s>``
  dropped).

Every row keeps its ``</s>`` key, an empty padding row of the engine's
batches too (n = 0), so no softmax row is fully masked and every position
stays finite.

The tree (kernels stored (in, out), as everywhere in the port)::

    {"embed": (vocab, d),
     "rel_bias": (buckets, H),
     "layers": [{"ln1": {"scale"},
                 "qkv": {"kernel": (d, 3·H·d_kv)},   # [q | k | v]
                 "o": {"kernel": (H·d_kv, d)},
                 "ln2": {"scale"},
                 "wi": {"kernel": (d, F)},
                 "wo": {"kernel": (F, d)}}, ...],
     "ln_final": {"scale"}}

:func:`..convert.prott5_from_hf_state_dict` builds it from the
``T5EncoderModel`` key layout. Device spans: ``model/t5/bias`` (the
bias's tables, once a batch: :func:`distance_buckets`), and a layer's
``model/t5/attn`` (RMS₁ through the residual add) with ``model/t5/sdpa``
inside it (the attention core alone, :func:`..ops.attention.attend`), and
``model/t5/ffn``; each of the four projections under ``model/t5/gemm``
inside those. On a CUDA device in float32 with TF32 off the projections
run on E1 (:mod:`..ops.esm_gemm`, its bias-free instances, ReLU and the
residual add in its epilogue) and the attention on E2
(:mod:`..ops.attention`), which makes the bias from R and the bucket of
each distance in the kernel; elsewhere ``torch.mm`` and E2's plain twin,
which gathers the (H, T, T) bias from the same two tables.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from metagenomic_deepfri_tpu_torch.ops.attention import attend
from metagenomic_deepfri_tpu_torch.ops.esm_gemm import project
from metagenomic_deepfri_tpu_torch.ops.one_hot import ALPHABET
from metagenomic_deepfri_tpu_torch.profiling import device_span, recording

# ProtT5's SentencePiece pieces of ids 0-27 (ids 28-127 are the unused
# <extra_id_*> sentinels). The residue ids are the tokenizer layout of
# ``Rostlab/prot_t5_xl_uniref50``, assumed here: with random weights only
# the layout matters, and a converter of the published weights checks
# them.
T5_VOCAB = ("<pad>", "</s>", "<unk>", "A", "L", "G", "V", "S", "R", "E",
            "D", "T", "I", "P", "K", "F", "Q", "N", "Y", "M", "H", "W", "C",
            "X", "B", "O", "U", "Z")
PAD, EOS = 0, 1
# The ProtT5 id of each of the port's 26 tokens (ops.one_hot.ALPHABET
# order): U, Z, O and B as X, the gap '-' as <unk>.
_AS = {"U": "X", "Z": "X", "O": "X", "B": "X", "-": "<unk>"}
PORT_TO_T5 = np.array([T5_VOCAB.index(_AS.get(c, c)) for c in ALPHABET],
                      np.int64)
# The span of each projection (:func:`..ops.esm_gemm.project`).
GEMM_SPAN = "model/t5/gemm"


@dataclass(frozen=True)
class ProtT5Config:
    """The encoder's widths; the defaults are ProtT5-XL-UniRef50's."""
    layers: int = 24
    dim: int = 1024
    heads: int = 32
    d_kv: int = 128
    ffn: int = 16384
    buckets: int = 32
    max_distance: int = 128
    eps: float = 1e-6
    vocab: int = 128

    @property
    def inner(self) -> int:
        """The attention's inner width, H·d_kv."""
        return self.heads * self.d_kv


def prott5_tokens(tokens: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """(B, T = L + 1) int64 ProtT5 ids of a right-padded (B, L) batch of
    the port's tokens: the residues, ``</s>`` at ``length``, ``<pad>``
    after it."""
    B, L = tokens.shape
    table = torch.as_tensor(PORT_TO_T5, device=tokens.device)
    pos = torch.arange(L, device=tokens.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    ids = torch.full((B, L + 1), PAD, dtype=torch.int64, device=tokens.device)
    ids[:, :L] = torch.where(pos < n, table[tokens.to(torch.int64)], PAD)
    ids.scatter_(1, n, EOS)
    return ids


def relative_position_bucket(relative: torch.Tensor, buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional bucket of each key-minus-query distance: half the
    buckets a sign, exact below half of those, log-spaced up to
    ``max_distance``, the last one beyond it; the log in float32, cut
    toward zero (``T5Attention._relative_position_bucket``)."""
    half = buckets // 2
    out = (relative > 0).to(torch.int64) * half
    dist = relative.abs()
    exact = half // 2
    large = exact + (torch.log(dist.float() / exact)
                     / math.log(max_distance / exact)
                     * (half - exact)).to(torch.int64)
    large = torch.minimum(large, torch.full_like(large, half - 1))
    return out + torch.where(dist < exact, dist, large)


@functools.lru_cache(maxsize=None)
def _buckets(T: int, buckets: int, max_distance: int,
             device: torch.device) -> torch.Tensor:
    rel = torch.arange(1 - T, T)
    return relative_position_bucket(rel, buckets, max_distance).to(
        torch.int8).to(device)


def distance_buckets(config: ProtT5Config, T: int,
                     device) -> torch.Tensor:
    """(2T − 1,) int8 T5 bucket of each key-minus-query distance d from
    −(T − 1) to T − 1, at d + T − 1: the whole position bias of a length
    but for R, so ``R[table[j − i + T − 1], h]`` is ``bias[h, i, j]``. The
    buckets are computed on the host, as the published model computes them
    on the CPU, and the table is made once for each length and device."""
    return _buckets(T, config.buckets, config.max_distance,
                    torch.device(device))


def _attn_bias(rel_bias: torch.Tensor, config: ProtT5Config,
               T: int) -> tuple:
    """The attention's bias as ``(R, buckets)`` (:func:`..ops.attention.
    attention`), once a batch, under ``model/t5/bias``: no (B, H, T, T)
    tensor is made."""
    with device_span("model/t5/bias", rel_bias.device):
        return rel_bias, distance_buckets(config, T, rel_bias.device)


def _rms(p: dict, x: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    """``w · x / sqrt(mean(x²) + eps)``: T5's LayerNorm."""
    var = x.pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * p["scale"].to(dtype)


def _attend(q, k, v, n, bias, counts) -> torch.Tensor:
    """softmax(q·kᵀ + bias)·v over the n valid keys of each row, with no
    scale (T5's), under ``model/t5/sdpa``; (B, T, H·d_kv)."""
    return attend(q, k, v, n, "model/t5/sdpa", bias, counts)


def _layer(p: dict, x: torch.Tensor, config: ProtT5Config, n, bias,
           counts, dtype) -> torch.Tensor:
    B, T, _ = x.shape
    H, dk = config.heads, config.d_kv
    with device_span("model/t5/attn", x.device):
        h = _rms(p["ln1"], x, config.eps, dtype)
        q, k, v = project(p["qkv"], h, dtype, GEMM_SPAN).view(
            B, T, 3, H, dk).permute(2, 0, 3, 1, 4)
        a = _attend(q, k, v, n, bias, counts)
        x = project(p["o"], a, dtype, GEMM_SPAN, "residual", x)
    with device_span("model/t5/ffn", x.device):
        h = _rms(p["ln2"], x, config.eps, dtype)
        h = project(p["wi"], h, dtype, GEMM_SPAN, "relu")
        x = project(p["wo"], h, dtype, GEMM_SPAN, "residual", x)
    return x


def prott5_forward(params: dict, config: ProtT5Config, tokens: torch.Tensor,
                   lengths: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L, d) residue representation of a right-padded (B, L) batch of
    the port's tokens, computed in ``dtype`` (float32, or float64 for the
    reference precision). Positions past a protein's length hold finite
    values that no real position depends on."""
    ids = prott5_tokens(tokens, lengths)
    T = ids.shape[1]
    n = lengths.to(torch.int32) + 1
    x = params["embed"].to(dtype)[ids]
    bias = _attn_bias(params["rel_bias"], config, T)
    counts = n.tolist() if recording() else None
    for p in params["layers"]:
        x = _layer(p, x, config, n, bias, counts, dtype)
    x = _rms(params["ln_final"], x, config.eps, dtype)
    return x[:, :T - 1]


def trunk_counts(lengths: torch.Tensor, bucket: int) -> dict:
    """The counters of one batch over its real proteins (length > 0):
    ``tokens`` Σ(n+1), ``slots`` B·T (every row, T = bucket + 1) and
    ``attn_pairs`` Σ(n+1)²."""
    n = [int(v) + 1 for v in lengths.tolist() if v > 0]
    return {"tokens": sum(n), "slots": len(lengths) * (bucket + 1),
            "attn_pairs": sum(v * v for v in n)}


def init_prott5(config: ProtT5Config, generator: torch.Generator,
                device) -> dict:
    """A random encoder at T5's initialisation scales
    (``T5PreTrainedModel._init_weights``, normal): q (d·d_kv)^-½, k and v
    d^-½, o (H·d_kv)^-½, wi d^-½, wo F^-½, the embedding 1, R d^-½; the RMS
    scales uniform in (0.8, 1.2), so that a dropped scale shows in a
    comparison."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * std).to(device)

    def norm():
        r = torch.rand((config.dim,), generator=generator,
                       dtype=torch.float32, device=generator.device)
        return {"scale": (0.8 + 0.4 * r).to(device)}

    d, f, inner = config.dim, config.ffn, config.inner

    def layer():
        qkv = torch.cat([normal((d, inner), (d * config.d_kv) ** -0.5),
                         normal((d, inner), d ** -0.5),
                         normal((d, inner), d ** -0.5)], dim=1)
        return {"ln1": norm(), "qkv": {"kernel": qkv},
                "o": {"kernel": normal((inner, d), inner ** -0.5)},
                "ln2": norm(), "wi": {"kernel": normal((d, f), d ** -0.5)},
                "wo": {"kernel": normal((f, d), f ** -0.5)}}

    return {"embed": normal((config.vocab, d), 1.0),
            "rel_bias": normal((config.buckets, config.heads), d ** -0.5),
            "layers": [layer() for _ in range(config.layers)],
            "ln_final": norm()}
