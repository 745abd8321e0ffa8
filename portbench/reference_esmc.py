"""The plain reference of ESM C and of the DeepFRI GCN tails it feeds:
float32 PyTorch, no kernels.

Written from the ``esm`` package's modules (github.com/evolutionaryscale/esm:
``esm/models/esmc.py``, ``esm/layers/transformer_stack.py``, ``blocks.py``
(``UnifiedTransformerBlock``, ``swiglu_ln_ffn``), ``attention.py``
(``MultiHeadAttention``), ``rotary.py``), independent of the port: it imports
nothing of ``metagenomic_deepfri_tpu_torch`` or of the JAX package, and takes
only the weights (in the layout of ``weights_esmc.py``) and the inputs that
the benchmark made. The modules are named as the ``esm`` package names them
(:data:`STATE_KEYS`), so that a published checkpoint's trunk loads into
:class:`ESMC` with ``strict=True``. For a protein of n residues:

- tokens ``<cls>``, the residues over ESM's sequence vocabulary, ``<eos>``;
  padded to the block's longest with ``<pad>``, which every key mask leaves
  out;
- ``x = E[t]``, no scale;
- each block, with s = √(layers / 36): ``[q k v] = LayerNorm(x)·W_qkv``;
  ``q = LN_q(q)``, ``k = LN_k(k)`` over the full width (a scale, no shift);
  rotary on q and k in heads of d_h (the frequencies repeated,
  ``rotate_half``); ``x += softmax(q·kᵀ/√d_h, padded keys at −inf)·v·W_o /
  s`` (the softmax in float32); ``x += (silu(a) ⊙ b)·W_2 / s`` of ``[a | b]
  = LayerNorm(x)·W_1``; no bias in any projection; then ``LN_final`` (a
  scale, no shift);
- the residue representation (``<cls>`` and ``<eos>`` left out) into
  DeepFRI's additive merge ``relu(r·W_lm + onehot·W_aa + b_aa)``, and each
  mode's GraphConv stack, pool, FC stack and head as ``reference.py``
  computes them.

The ``esm`` package pairs a padded query with the padded keys; here every
query sees the real keys. No real position depends on a padded one either
way. ``rnd`` rounds every matmul operand, the attention's included
(:func:`reference.exact`, or :func:`reference.tf32` for the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench import reference

# ESM's sequence vocabulary (EsmSequenceTokenizer), ids 0-32 of the
# embedding's 64 rows.
ESM_VOCAB = ("<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V", "S",
             "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F", "Y", "M", "H",
             "W", "C", "X", "B", "U", "Z", "O", ".", "-", "|", "<mask>")
_ID = {c: i for i, c in enumerate(ESM_VOCAB)}


def state_keys(layers: int) -> list:
    """The state dict's keys of an :class:`ESMC` of ``layers`` blocks."""
    keys = ["embed.weight"]
    for i in range(layers):
        b = f"transformer.blocks.{i}."
        keys += [b + k for k in (
            "attn.layernorm_qkv.0.weight", "attn.layernorm_qkv.0.bias",
            "attn.layernorm_qkv.1.weight", "attn.out_proj.weight",
            "attn.q_ln.weight", "attn.k_ln.weight", "ffn.0.weight",
            "ffn.0.bias", "ffn.1.weight", "ffn.3.weight")]
    return keys + ["transformer.norm.weight"]


def swiglu_width(d_model: int, expansion_ratio: float = 8 / 3) -> int:
    """``swiglu_correction_fn``: the SwiGLU hidden width, 8/3·d rounded up
    to a multiple of 256."""
    return int(((expansion_ratio * d_model) + 255) // 256 * 256)


def _linear(lin: nn.Linear, x: torch.Tensor, rnd) -> torch.Tensor:
    return reference._mm(x, lin.weight.t(), rnd)


def rotary(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """x (…, T, d_h) rotated at positions 0…T−1: ``x·cos + rotate_half(x)
    ·sin``, the angles of frequency pair i at ``base^(−2i/d_h)`` repeated
    over both halves (``RotaryEmbedding``, not interleaved)."""
    T, dh = x.shape[-2], x.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                            device=x.device) / dh))
    t = torch.arange(T, dtype=torch.float32, device=x.device)
    freqs = torch.outer(t, inv_freq)
    cos = torch.cat([freqs.cos(), freqs.cos()], dim=-1).to(x.dtype)
    sin = torch.cat([freqs.sin(), freqs.sin()], dim=-1).to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class SwiGLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = x.chunk(2, dim=-1)
        return F.silu(a) * b


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.layernorm_qkv = nn.Sequential(
            nn.LayerNorm(d_model), nn.Linear(d_model, 3 * d_model,
                                             bias=False))
        self.out_proj = nn.Linear(d_model, d_model, bias=False)
        self.q_ln = nn.LayerNorm(d_model, bias=False)
        self.k_ln = nn.LayerNorm(d_model, bias=False)

    def forward(self, x: torch.Tensor, real: torch.Tensor,
                rnd) -> torch.Tensor:
        B, T, d = x.shape
        H = self.n_heads
        dh = d // H
        qkv = _linear(self.layernorm_qkv[1], self.layernorm_qkv[0](x), rnd)
        q, k, v = qkv.chunk(3, dim=-1)
        q, k = self.q_ln(q), self.k_ln(k)
        q, k, v = (t.reshape(B, T, H, dh).transpose(1, 2) for t in (q, k, v))
        q, k = rotary(q), rotary(k)
        s = reference._mm(q.reshape(B * H, T, dh),
                          k.reshape(B * H, T, dh).transpose(1, 2), rnd)
        s = (s.view(B, H, T, T) / math.sqrt(dh)).masked_fill(
            ~real[:, None, None, :], float("-inf"))
        w = torch.softmax(s, dim=-1)
        a = reference._mm(w.reshape(B * H, T, T), v.reshape(B * H, T, dh),
                          rnd)
        a = a.view(B, H, T, dh).transpose(1, 2).reshape(B, T, d)
        return _linear(self.out_proj, a, rnd)


class UnifiedTransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, ffn: int,
                 residue_scaling_factor: float):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, n_heads)
        self.ffn = nn.Sequential(
            nn.LayerNorm(d_model), nn.Linear(d_model, 2 * ffn, bias=False),
            SwiGLU(), nn.Linear(ffn, d_model, bias=False))
        self.scaling_factor = residue_scaling_factor

    def forward(self, x: torch.Tensor, real: torch.Tensor,
                rnd) -> torch.Tensor:
        x = x + self.attn(x, real, rnd) / self.scaling_factor
        h = self.ffn[2](_linear(self.ffn[1], self.ffn[0](x), rnd))
        return x + _linear(self.ffn[3], h, rnd) / self.scaling_factor


class TransformerStack(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_layers: int, ffn: int):
        super().__init__()
        scale = math.sqrt(n_layers / 36)
        self.blocks = nn.ModuleList(
            UnifiedTransformerBlock(d_model, n_heads, ffn, scale)
            for _ in range(n_layers))
        self.norm = nn.LayerNorm(d_model, bias=False)

    def forward(self, x: torch.Tensor, real: torch.Tensor,
                rnd) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, real, rnd)
        return self.norm(x)


class ESMC(nn.Module):
    """ESM C's trunk without its ``sequence_head``: (B, T) ids and the
    (B, T) mask of real tokens → (B, T, d), after the final LayerNorm."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int,
                 ffn: int | None = None, vocab: int = 64):
        super().__init__()
        self.embed = nn.Embedding(vocab, d_model)
        self.transformer = TransformerStack(
            d_model, n_heads, n_layers, ffn or swiglu_width(d_model))

    def forward(self, ids: torch.Tensor, real: torch.Tensor,
                rnd=reference.exact) -> torch.Tensor:
        return self.transformer(self.embed(ids), real, rnd)


def state_dict_of(lm: dict) -> dict:
    """The ``esm`` package's state dict of a trunk tree of
    ``weights_esmc.py``'s layout: kernels (in, out) as ``nn.Linear``
    weights (out, in), views of the tree's tensors."""
    state = {"embed.weight": lm["embed"],
             "transformer.norm.weight": lm["ln_final"]["scale"]}
    for i, p in enumerate(lm["layers"]):
        b = f"transformer.blocks.{i}."
        state.update({
            b + "attn.layernorm_qkv.0.weight": p["ln_qkv"]["scale"],
            b + "attn.layernorm_qkv.0.bias": p["ln_qkv"]["bias"],
            b + "attn.layernorm_qkv.1.weight": p["qkv"]["kernel"].t(),
            b + "attn.out_proj.weight": p["out"]["kernel"].t(),
            b + "attn.q_ln.weight": p["q_ln"]["scale"],
            b + "attn.k_ln.weight": p["k_ln"]["scale"],
            b + "ffn.0.weight": p["ln_ffn"]["scale"],
            b + "ffn.0.bias": p["ln_ffn"]["bias"],
            b + "ffn.1.weight": p["fc1"]["kernel"].t(),
            b + "ffn.3.weight": p["fc2"]["kernel"].t()})
    return state


def model_of(lm: dict, esmc: dict) -> ESMC:
    """An :class:`ESMC` of the configuration's ``esmc`` widths holding the
    tree's tensors (no copy)."""
    with torch.device("meta"):
        model = ESMC(esmc["dim"], esmc["heads"], esmc["layers"],
                     esmc["ffn"], esmc["vocab"])
    model.requires_grad_(False)
    model.load_state_dict(state_dict_of(lm), strict=True, assign=True)
    return model.eval()


def _tokens(seqs: list, device):
    """(B, T) ids padded with ``<pad>`` and the (B, T) mask of real tokens
    (``<cls>``, the residues and ``<eos>``)."""
    T = max(len(s) for s in seqs) + 2
    ids = torch.full((len(seqs), T), _ID["<pad>"], dtype=torch.int64)
    for b, s in enumerate(seqs):
        ids[b, :len(s) + 2] = torch.tensor(
            [_ID["<cls>"]] + [_ID[c] for c in s] + [_ID["<eos>"]])
    real = torch.arange(T)[None, :] < torch.tensor(
        [len(s) + 2 for s in seqs])[:, None]
    return ids.to(device), real.to(device)


def trunk(lm: dict, esmc: dict, seqs: list, device, rnd) -> torch.Tensor:
    """(B, n_max, d) residue representation of a block of sequences."""
    ids, real = _tokens(seqs, device)
    x = model_of(lm, esmc)(ids, real, rnd)
    return x[:, 1:ids.shape[1] - 1]


def gcn_block(trees: dict, config: dict, proteins: list, device,
              rnd=reference.exact) -> dict:
    """{mode: (B, terms) scores} of one block of (sequence, coordinates,
    insertion) proteins; modes whose trees share their trunk compute it
    once."""
    seqs = [p[0] for p in proteins]
    L = max(len(s) for s in seqs)
    onehot, valid = reference._onehot(seqs, L, device)
    adj = reference.adjacency(proteins, L, config["contact_threshold"],
                              config["generated_contacts"], device)
    if config["adj_norm"] != "sym":
        raise ValueError("the reference normalises symmetrically only")
    deg = adj.sum(-1)
    inv = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(),
                      torch.zeros_like(deg))
    adj = adj * inv[:, :, None] * inv[:, None, :]
    cache: dict = {}
    out = {}
    for mode, p in trees.items():
        key = id(p["lm"]["embed"])
        if key not in cache:
            r = trunk(p["lm"], config["esmc"], seqs, device, rnd)
            cache[key] = torch.relu(
                reference._mm(r, p["lm_embed"]["kernel"], rnd)
                + reference._mm(onehot, p["aa_embed"]["kernel"], rnd)
                + p["aa_embed"]["bias"])
        x = cache[key]
        layers = []
        for g in p["gc"]:
            x = torch.relu(reference._mm(reference._mm(adj, x, rnd),
                                         g["kernel"], rnd))
            layers.append(x)
        pooled = (torch.cat(layers, -1) * valid[:, :, None]).sum(1)
        out[mode] = reference._head(
            p["head"], reference._dense_stack(p["fc"], pooled, rnd), rnd)
    return out
