"""The plain reference of ESM-2 and of the DeepFRI GCN tails it feeds:
float32 PyTorch, no kernels.

Written from ESM-2's published description (Lin et al., Science 379:1123,
2023; ``esm2_t33_650M_UR50D``; the ``fair-esm`` forward), independent of
the port: it imports nothing of ``metagenomic_deepfri_tpu_torch`` or of the
JAX package, and takes only the weights (in the layout of
``weights_esm2.py``) and the inputs that the benchmark made. For a protein
of n residues:

- tokens ``<cls>``, the residues over the ESM-1b alphabet, ``<eos>``;
  padded to the block's longest with ``<pad>``, which every key mask and
  the embedding leave out;
- ``x = E[t] · (1 − 0.15·0.8)`` (ESM-2's inference-time token-dropout
  scale; no ``<mask>`` token is given);
- each layer: ``h = LN₁(x)``, ``[q k v] = h·W_qkv + b``, ``q ·= 64^-½``,
  rotary positions on q and k (``base^(−2i/64)``, the frequencies repeated,
  ``x·cos + rotate_half(x)·sin``), ``x += softmax(q·kᵀ, padded keys at
  −inf)·v·W_o + b_o`` with the softmax in float32, ``x += GELU_erf(LN₂(x)·W₁
  + b₁)·W₂ + b₂``; then ``LN_after``;
- the residue representation (``<cls>`` and ``<eos>`` left out) into
  DeepFRI's additive merge ``relu(r·W_lm + onehot·W_aa + b_aa)``, and each
  mode's GraphConv stack, pool, FC stack and head as ``reference.py``
  computes them.

``rnd`` rounds every matmul operand, the attention's included
(:func:`reference.exact`, or :func:`reference.tf32` for the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import reference

ESM_ALPHABET = ("<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V",
                "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F", "Y",
                "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
                "<null_1>", "<mask>")
_ID = {c: i for i, c in enumerate(ESM_ALPHABET)}


def _tokens(seqs: list, device):
    """(B, T) ids padded with ``<pad>`` and the (B, T) mask of real
    tokens."""
    T = max(len(s) for s in seqs) + 2
    ids = torch.full((len(seqs), T), _ID["<pad>"], dtype=torch.int64)
    for b, s in enumerate(seqs):
        ids[b, :len(s) + 2] = torch.tensor(
            [_ID["<cls>"]] + [_ID[c] for c in s] + [_ID["<eos>"]])
    ids = ids.to(device)
    return ids, ids != _ID["<pad>"]


def _norm(p, x, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _lin(p, x, rnd):
    return reference._mm(x, p["kernel"], rnd) + p["bias"]


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def trunk(lm: dict, esm: dict, seqs: list, device, rnd) -> torch.Tensor:
    """(B, n_max, d) residue representation of a block of sequences."""
    ids, real = _tokens(seqs, device)
    B, T = ids.shape
    d, H = esm["dim"], esm["heads"]
    hd = d // H
    x = lm["embed"][ids] * (1.0 - 0.15 * 0.8) * real[..., None]
    inv = 1.0 / (esm["rope_base"] ** (
        torch.arange(0, hd, 2, device=device, dtype=torch.float32) / hd))
    ang = torch.arange(T, device=device, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos(), ang.sin()
    bias = torch.zeros((B, 1, 1, T), device=device).masked_fill(
        ~real[:, None, None, :], float("-inf"))
    eps = esm["ln_eps"]
    for p in lm["layers"]:
        qkv = _lin(p["qkv"], _norm(p["ln1"], x, eps), rnd)
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(B, T, H, hd)
                   .transpose(1, 2) for i in range(3))
        q = _rope(q / math.sqrt(hd), cos, sin)
        k = _rope(k, cos, sin)
        s = reference._mm(q.reshape(B * H, T, hd),
                          k.reshape(B * H, T, hd).transpose(1, 2), rnd)
        w = torch.softmax(s.view(B, H, T, T) + bias, dim=-1)
        a = reference._mm(w.reshape(B * H, T, T), v.reshape(B * H, T, hd),
                          rnd)
        a = a.view(B, H, T, hd).transpose(1, 2).reshape(B, T, d)
        x = x + _lin(p["out"], a, rnd)
        h = _lin(p["fc1"], _norm(p["ln2"], x, eps), rnd)
        h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
        x = x + _lin(p["fc2"], h, rnd)
    x = _norm(lm["ln_after"], x, eps)
    return x[:, 1:T - 1]


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
            r = trunk(p["lm"], config["esm"], seqs, device, rnd)
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
