"""A plain reference of ESM-2 and of the DeepFRI GCN tail it feeds, for
the CPU tests of ``test_torch_esm2.py``.

Written from the published equations (Lin et al., Science 379:1123, 2023;
the ``fair-esm`` and Hugging Face ``EsmModel`` forwards) and DeepFRI's
(Gligorijević et al., Nat Commun 12:3168, 2021), with plain ``torch``
operations one protein at a time: no batch, no padding, no mask, an
explicit softmax for the attention. It imports nothing of the port. Trees
are in the port's layout (``metagenomic_deepfri_tpu_torch/models/esm2.py``:
kernels (in, out), ``qkv`` = [q | k | v]).
"""

from __future__ import annotations

import math

import numpy as np
import torch

ESM_ALPHABET = ("<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V",
                "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F", "Y",
                "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
                "<null_1>", "<mask>")
MASK = ESM_ALPHABET.index("<mask>")
DEEPFRI_ALPHABET = "-DGULNTKHYWCPVSOIEFXQABZRM"


def esm_ids(seq: str) -> torch.Tensor:
    """``<cls>``, the residues' ids, ``<eos>``."""
    return torch.tensor([0] + [ESM_ALPHABET.index(c) for c in seq] + [2])


def _lin(p, x):
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _ln(p, x, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"].to(x.dtype) \
        + p["bias"].to(x.dtype)


def trunk_ids(tree: dict, heads: int, ids: torch.Tensor,
              dtype=torch.float64, eps: float = 1e-5,
              base: float = 10000.0) -> torch.Tensor:
    """(T, d) last hidden states (after the final LayerNorm) of one
    unpadded row of ESM ids."""
    dev = tree["embed"].device
    ids = ids.to(dev)
    T = ids.shape[0]
    x = tree["embed"].to(dtype)[ids]
    x = x.masked_fill((ids == MASK)[:, None], 0.0)
    observed = float((ids == MASK).sum()) / T
    x = x * (1 - 0.15 * 0.8) / (1 - observed)
    d = x.shape[1]
    hd = d // heads
    # The angles in float32, as both published implementations make them.
    inv = 1.0 / base ** (torch.arange(0, hd, 2, device=dev).float() / hd)
    ang = torch.arange(T, device=dev).float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)

    def rope(t):
        half = hd // 2
        rot = torch.cat([-t[..., half:], t[..., :half]], -1)
        return t * cos + rot * sin

    for p in tree["layers"]:
        h = _ln(p["ln1"], x, eps)
        qkv = _lin(p["qkv"], h)
        q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(T, heads, hd)
                   .transpose(0, 1) for i in range(3))
        q = rope(q / math.sqrt(hd))
        k = rope(k)
        w = torch.softmax(q @ k.transpose(1, 2), dim=-1)
        a = (w @ v).transpose(0, 1).reshape(T, d)
        x = x + _lin(p["out"], a)
        h = _lin(p["fc1"], _ln(p["ln2"], x, eps))
        h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
        x = x + _lin(p["fc2"], h)
    return _ln(tree["ln_after"], x, eps)


def residues(tree: dict, heads: int, seq: str,
             dtype=torch.float64) -> torch.Tensor:
    """(L, d) residue representation of a protein."""
    return trunk_ids(tree, heads, esm_ids(seq), dtype)[1:-1]


def adjacency(coords, ins, threshold: float, band: int) -> torch.Tensor:
    """(L, L) float64 aligned adjacency, D^-1/2 A D^-1/2 normalised: two
    mapped residues closer than ``threshold``, the diagonal, and pairs
    within ``band`` of an insertion."""
    xyz = torch.as_tensor(np.asarray(coords, np.float32))
    ins = torch.as_tensor(np.asarray(ins, bool))
    n = xyz.shape[0]
    d = xyz[:, None, :] - xyz[None, :, :]
    sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    mapped = ~ins
    a = (sq < threshold * threshold) & mapped[:, None] & mapped[None, :]
    off = (torch.arange(n)[:, None] - torch.arange(n)[None, :]).abs()
    a |= off == 0
    a |= (off > 0) & (off <= band) & (ins[:, None] | ins[None, :])
    a = a.double()
    inv = a.sum(-1).rsqrt()
    return a * inv[:, None] * inv[None, :]


def gcn_scores(params: dict, heads: int, seq: str, coords=None, ins=None,
               threshold: float = 6.0, band: int = 2,
               adj: torch.Tensor | None = None) -> torch.Tensor:
    """(n_labels,) float64 scores of one protein through the ESM-2 trunk
    and one mode's tail: ``relu(r·W_lm + onehot·W_aa + b_aa)``, GraphConv
    ``relu(Â·x·W)`` a layer on the :func:`adjacency` of ``coords`` and
    ``ins`` (or on the normalised ``adj`` given), the layers concatenated
    and summed over residues, the FC stack, the two-way softmax's first
    class."""
    dt = torch.float64
    r = residues(params["lm"], heads, seq, dt)
    onehot = torch.zeros((len(seq), len(DEEPFRI_ALPHABET)), dtype=dt)
    onehot[torch.arange(len(seq)),
           torch.tensor([DEEPFRI_ALPHABET.index(c) for c in seq])] = 1.0

    def dense(p, x):
        y = x @ p["kernel"].to(dt)
        return y + p["bias"].to(dt) if "bias" in p else y

    x = torch.relu(dense(params["lm_embed"], r)
                   + dense(params["aa_embed"], onehot))
    if adj is None:
        adj = adjacency(coords, ins, threshold, band)
    outs = []
    for g in params["gc"]:
        x = torch.relu(dense(g, adj @ x))
        outs.append(x)
    h = torch.cat(outs, -1).sum(0)
    for f in params["fc"]:
        h = torch.relu(dense(f, h))
    logits = dense(params["head"], h).reshape(-1, 2)
    return torch.softmax(logits, -1)[:, 0]
