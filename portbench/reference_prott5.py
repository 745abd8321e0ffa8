"""The plain reference of ProtT5-XL-UniRef50's encoder and of the DeepFRI
GCN tails it feeds: float32 PyTorch, no kernels.

Written from T5 v1.0's published description as ProtTrans uses it
(Elnaggar et al., IEEE TPAMI 44:7112, 2022; Raffel et al., JMLR 21:140,
2020; the ``transformers`` T5 encoder), independent of the port: it imports
nothing of ``metagenomic_deepfri_tpu_torch`` or of the JAX package, and
takes only the weights (in the layout of ``weights_prott5.py``) and the
inputs that the benchmark made. For a protein of n residues:

- tokens: the residues over ProtT5's vocabulary (U, Z, O and B as X), then
  ``</s>``; padded to the block's longest with ``<pad>``, which every key
  mask leaves out; no start token;
- ``x = E[t]``, no scale;
- a relative-position bias ``R[bucket(j − i), h]`` from layer 0's table R,
  the same in every layer: 16 buckets a sign (the later key's above), the
  distance itself below 8, then ``8 + ⌊log(dist/8) / log(128/8) · 8⌋`` in
  float32, at most 15;
- each layer: ``h = RMS₁(x)`` (``w · x / sqrt(mean(x²) + eps)``),
  ``[q k v] = h·W_qkv`` in heads of ``d_kv``, ``x += softmax(q·kᵀ + bias,
  padded keys at −inf)·v·W_o`` (no 1/√d_kv scale; the softmax in float32),
  ``x += relu(RMS₂(x)·W_i)·W_o'``; no bias in any projection; then
  ``RMS_final``;
- the residue representation (``</s>`` left out) into DeepFRI's additive
  merge ``relu(r·W_lm + onehot·W_aa + b_aa)``, and each mode's GraphConv
  stack, pool, FC stack and head as ``reference.py`` computes them.

``rnd`` rounds every matmul operand, the attention's included
(:func:`reference.exact`, or :func:`reference.tf32` for the control).
"""

from __future__ import annotations

import math

import torch

from portbench import reference

T5_VOCAB = ("<pad>", "</s>", "<unk>", "A", "L", "G", "V", "S", "R", "E",
            "D", "T", "I", "P", "K", "F", "Q", "N", "Y", "M", "H", "W", "C",
            "X", "B", "O", "U", "Z")
_AS_X = {"U", "Z", "O", "B"}
_ID = {c: i for i, c in enumerate(T5_VOCAB)}


def _tokens(seqs: list, device):
    """(B, T) ids padded with ``<pad>`` and the (B, T) mask of real
    tokens (the residues and ``</s>``)."""
    T = max(len(s) for s in seqs) + 1
    ids = torch.full((len(seqs), T), _ID["<pad>"], dtype=torch.int64)
    for b, s in enumerate(seqs):
        ids[b, :len(s) + 1] = torch.tensor(
            [_ID["X" if c in _AS_X else c] for c in s] + [_ID["</s>"]])
    real = torch.arange(T)[None, :] <= torch.tensor(
        [len(s) for s in seqs])[:, None]
    return ids.to(device), real.to(device)


def bucket(rel: torch.Tensor, buckets: int, max_distance: int):
    """The bias table's row of each key-minus-query distance."""
    half = buckets // 2
    exact = half // 2
    dist = rel.abs()
    scaled = (torch.log(dist.float() / exact)
              / math.log(max_distance / exact) * (half - exact))
    far = (exact + scaled.to(torch.int64)).clamp(max=half - 1)
    return (rel > 0).to(torch.int64) * half + torch.where(dist < exact, dist,
                                                           far)


def _rms(p, x, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * p["scale"]


def trunk(lm: dict, t5: dict, seqs: list, device, rnd) -> torch.Tensor:
    """(B, n_max, d) residue representation of a block of sequences."""
    ids, real = _tokens(seqs, device)
    B, T = ids.shape
    H, dk = t5["heads"], t5["d_kv"]
    inner, eps = H * dk, t5["eps"]
    x = lm["embed"][ids]
    pos = torch.arange(T)
    rows = bucket(pos[None, :] - pos[:, None], t5["buckets"],
                  t5["max_distance"])
    bias = lm["rel_bias"][rows.to(device)].permute(2, 0, 1)[None]
    bias = bias + torch.zeros((B, 1, 1, T), device=device).masked_fill(
        ~real[:, None, None, :], float("-inf"))

    def heads(t):
        return t.reshape(B, T, H, dk).transpose(1, 2).reshape(B * H, T, dk)

    for p in lm["layers"]:
        qkv = reference._mm(_rms(p["ln1"], x, eps), p["qkv"]["kernel"], rnd)
        q, k, v = (heads(qkv[..., i * inner:(i + 1) * inner])
                   for i in range(3))
        s = reference._mm(q, k.transpose(1, 2), rnd)
        w = torch.softmax(s.view(B, H, T, T) + bias, dim=-1)
        a = reference._mm(w.reshape(B * H, T, T), v, rnd)
        a = a.view(B, H, T, dk).transpose(1, 2).reshape(B, T, inner)
        x = x + reference._mm(a, p["o"]["kernel"], rnd)
        h = torch.relu(reference._mm(_rms(p["ln2"], x, eps),
                                     p["wi"]["kernel"], rnd))
        x = x + reference._mm(h, p["wo"]["kernel"], rnd)
    x = _rms(lm["ln_final"], x, eps)
    return x[:, :T - 1]


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
            r = trunk(p["lm"], config["t5"], seqs, device, rnd)
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
