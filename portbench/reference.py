"""The plain reference of the DeepFRI GCN and CNN: float32 PyTorch, no kernels.

Written from the model's description (Gligorijević et al., Nat Commun 12:3168,
2021; mDeepFRI's ONNX graphs), independent of the port: it imports nothing
of ``metagenomic_deepfri_tpu_torch`` or of the JAX package, and takes only
the weights and inputs that the benchmark made. Per protein of length n:

- tokens over DeepFRI's 26-letter vocabulary, one-hot;
- a 2-layer LSTM language model (gates i, f, c, o; weights stored (in, 4H));
- x0 = relu(LM · W_lm + onehot · W_aa + b_aa);
- the aligned adjacency A: 1 where the projected CA atoms of two mapped
  residues lie closer than the threshold (squared distance summed x, y, z
  in float32), on the diagonal, and within ``generated_contacts`` of an
  insertion; normalised D^-1/2 A D^-1/2 (``adj_norm: sym``);
- three GraphConv layers x_{l+1} = relu(Â x_l W_l), their outputs
  concatenated and summed over the n residues;
- a ReLU dense layer and a head of 2·terms logits, a softmax over each pair,
  the first class's probability as the score.

The CNN: 'SAME' 1-D convolutions of the one-hot (low padding (w-1)//2),
ReLU, a max over the n residues, the dense stack and the same head.

Proteins run in blocks of similar length padded to the block's longest;
every sum and the pooling are masked to each protein's own length.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

ALPHABET = "-DGULNTKHYWCPVSOIEFXQABZRM"  # DeepFRI's order
_INDEX = {c: i for i, c in enumerate(ALPHABET)}


@contextlib.contextmanager
def full_precision():
    """float32 matmuls and convolutions without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits, to nearest, ties
    to even), as the tensor cores round matmul operands in TF32 mode: the
    control's precision, the same on a CPU and on the card."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0xFFF + ((bits >> 13) & 1)) >> 13) << 13
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _mm(a: torch.Tensor, b: torch.Tensor, rnd) -> torch.Tensor:
    """``a @ b`` of float32 operands rounded by ``rnd`` (exact or TF32)."""
    return (torch.bmm if a.dim() == 3 and b.dim() == 3 else torch.matmul)(
        rnd(a), rnd(b))


def _onehot(seqs: list, L: int, device):
    """(B, L, 26) one-hot zeroed past each length, (B, L) valid mask."""
    B = len(seqs)
    idx = torch.zeros((B, L), dtype=torch.int64)
    valid = torch.zeros((B, L), dtype=torch.float32)
    for b, s in enumerate(seqs):
        idx[b, :len(s)] = torch.tensor([_INDEX[c] for c in s])
        valid[b, :len(s)] = 1.0
    idx, valid = idx.to(device), valid.to(device)
    onehot = torch.nn.functional.one_hot(idx, len(ALPHABET)).float()
    return onehot * valid[:, :, None], valid


def _lstm(layers: list, x: torch.Tensor, rnd) -> torch.Tensor:
    for p in layers:
        H = p["recurrent"].shape[0]
        xw = _mm(x, p["kernel"], rnd) + p["bias"]
        h = x.new_zeros((x.shape[0], H))
        c = x.new_zeros((x.shape[0], H))
        out = []
        for t in range(x.shape[1]):
            g = xw[:, t] + _mm(h, p["recurrent"], rnd)
            i, f, cc, o = g.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        x = torch.stack(out, dim=1)
    return x


def adjacency(proteins: list, L: int, threshold: float, band: int,
              device) -> torch.Tensor:
    """(B, L, L) float32 aligned adjacency of (seq, coords, insertion)
    proteins, zero past each length."""
    B = len(proteins)
    adj = torch.zeros((B, L, L), dtype=torch.float32, device=device)
    thr2 = torch.tensor(threshold * threshold, dtype=torch.float32)
    for b, (seq, coords, ins) in enumerate(proteins):
        n = len(seq)
        xyz = torch.as_tensor(coords, dtype=torch.float32, device=device)
        ins_t = torch.as_tensor(ins, dtype=torch.bool, device=device)
        d = xyz[:, None, :] - xyz[None, :, :]
        sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        sq = sq + d[..., 2] * d[..., 2]
        mapped = ~ins_t
        a = (sq < thr2.to(device)) & mapped[:, None] & mapped[None, :]
        pos = torch.arange(n, device=device)
        off = (pos[:, None] - pos[None, :]).abs()
        a |= off == 0
        a |= (off > 0) & (off <= band) & (ins_t[:, None] | ins_t[None, :])
        adj[b, :n, :n] = a.float()
    return adj


def _head(p: dict, x: torch.Tensor, rnd) -> torch.Tensor:
    logits = _mm(x, p["kernel"], rnd) + p["bias"]
    pair = logits.reshape(x.shape[0], -1, 2)
    return torch.softmax(pair, dim=-1)[..., 0]


def _dense_stack(layers: list, x: torch.Tensor, rnd) -> torch.Tensor:
    for p in layers:
        x = torch.relu(_mm(x, p["kernel"], rnd) + p["bias"])
    return x


def gcn_block(trees: dict, config: dict, proteins: list, device,
              rnd=exact) -> dict:
    """{mode: (B, terms) scores} of one block of proteins; the modes'
    trees may share their LSTM-LM (computed once if they do). ``rnd``
    rounds every matmul operand (:func:`exact`, or :func:`tf32` for the
    control)."""
    L = max(len(p[0]) for p in proteins)
    onehot, valid = _onehot([p[0] for p in proteins], L, device)
    adj = adjacency(proteins, L, config["contact_threshold"],
                    config["generated_contacts"], device)
    if config["adj_norm"] != "sym":
        raise ValueError("the reference normalises symmetrically only")
    deg = adj.sum(-1)
    inv = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(),
                      torch.zeros_like(deg))
    adj = adj * inv[:, :, None] * inv[:, None, :]
    lm_cache: dict = {}
    out = {}
    for mode, p in trees.items():
        key = id(p["lm"][0]["kernel"])
        if key not in lm_cache:
            lm = _lstm(p["lm"], onehot, rnd)
            lm_cache[key] = torch.relu(
                _mm(lm, p["lm_embed"]["kernel"], rnd)
                + _mm(onehot, p["aa_embed"]["kernel"], rnd)
                + p["aa_embed"]["bias"])
        x = lm_cache[key]
        layers = []
        for g in p["gc"]:
            x = torch.relu(_mm(_mm(adj, x, rnd), g["kernel"], rnd))
            layers.append(x)
        pooled = (torch.cat(layers, -1) * valid[:, :, None]).sum(1)
        out[mode] = _head(p["head"], _dense_stack(p["fc"], pooled, rnd), rnd)
    return out


def cnn_block(trees: dict, proteins: list, device, rnd=exact) -> dict:
    """{mode: (B, terms) scores} of the CNNs on sequences alone."""
    L = max(len(p[0]) for p in proteins)
    onehot, valid = _onehot([p[0] for p in proteins], L, device)
    x = onehot.transpose(1, 2)
    out = {}
    for mode, p in trees.items():
        branches = []
        for c in p["conv"]:
            w = c["kernel"].shape[0]
            xp = torch.nn.functional.pad(x, ((w - 1) // 2, w // 2))
            y = torch.nn.functional.conv1d(
                rnd(xp), rnd(c["kernel"]).permute(2, 1, 0))
            branches.append(y.transpose(1, 2) + c["bias"])
        h = torch.relu(torch.cat(branches, -1))
        h = h.masked_fill(valid[:, :, None] == 0, float("-inf")).amax(1)
        out[mode] = _head(p["head"], _dense_stack(p["fc"], h, rnd), rnd)
    return out


def blocks(order: list, lengths: list, size: int) -> list:
    """``order`` (indices) in blocks of ``size`` by ascending length."""
    ranked = sorted(order, key=lambda i: lengths[i])
    return [ranked[i:i + size] for i in range(0, len(ranked), size)]


# -- re-alignment and projection ----------------------------------------------

_B62_ALPHABET = "ARNDCQEGHILKMFPSTWYV"
# BLOSUM62 (Henikoff & Henikoff 1992), the 20 standard residues.
_B62 = np.array([[int(v) for v in row.split()] for row in """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
""".strip().splitlines()], dtype=np.int64)
_NEG = -(2 ** 40)


def global_alignment(query: str, target: str, gap_open: int = 10,
                     gap_extend: int = 1) -> str:
    """Needleman-Wunsch with affine gaps (Gotoh) under BLOSUM62, a gap of k
    costing ``gap_open + (k - 1) * gap_extend``; the alignment as M (a
    pair), I (a gap in the query) and D (a gap in the target).

    Of co-optimal alignments it returns the one this tie rule gives: a cell
    takes the diagonal unless a gap scores strictly more (a gap in the
    query before one in the target), a gap opens unless extending scores
    strictly more, and the traceback runs from the last cell to the first.
    The matrices are filled an anti-diagonal at a time.
    """
    idx = {c: i for i, c in enumerate(_B62_ALPHABET)}
    q = np.array([idx[c] for c in query], np.int64)
    t = np.array([idx[c] for c in target], np.int64)
    n, m = len(q), len(t)
    H = np.full((n + 1, m + 1), _NEG, np.int64)
    E = np.full((n + 1, m + 1), _NEG, np.int64)
    F = np.full((n + 1, m + 1), _NEG, np.int64)
    src = np.zeros((n + 1, m + 1), np.int8)        # 0 diag, 1 E, 2 F
    e_ext = np.zeros((n + 1, m + 1), bool)
    f_ext = np.zeros((n + 1, m + 1), bool)
    H[0, 0] = 0
    j = np.arange(1, m + 1)
    H[0, 1:] = E[0, 1:] = -gap_open - (j - 1) * gap_extend
    src[0, 1:], e_ext[0, 2:] = 1, True
    i = np.arange(1, n + 1)
    H[1:, 0] = F[1:, 0] = -gap_open - (i - 1) * gap_extend
    src[1:, 0], f_ext[2:, 0] = 2, True
    for d in range(2, n + m + 1):
        ii = np.arange(max(1, d - m), min(n, d - 1) + 1)
        jj = d - ii
        eo, ee = H[ii, jj - 1] - gap_open, E[ii, jj - 1] - gap_extend
        fo, fe = H[ii - 1, jj] - gap_open, F[ii - 1, jj] - gap_extend
        e = np.where(ee > eo, ee, eo)
        f = np.where(fe > fo, fe, fo)
        diag = H[ii - 1, jj - 1] + _B62[q[ii - 1], t[jj - 1]]
        best = diag.copy()
        s = np.zeros(len(ii), np.int8)
        s[e > best] = 1
        best = np.maximum(best, e)
        s[f > best] = 2
        best = np.maximum(best, f)
        H[ii, jj], E[ii, jj], F[ii, jj] = best, e, f
        src[ii, jj], e_ext[ii, jj], f_ext[ii, jj] = s, ee > eo, fe > fo
    out = []
    a, b, state = n, m, 0
    while a > 0 or b > 0:
        if state == 0:
            state = 1 if a == 0 else 2 if b == 0 else int(src[a, b])
            if state == 0:
                out.append("M")
                a, b = a - 1, b - 1
                continue
        if state == 1:
            out.append("I")
            state = 1 if e_ext[a, b] else 0
            b -= 1
        else:
            out.append("D")
            state = 2 if f_ext[a, b] else 0
            a -= 1
    return "".join(reversed(out))


def project(alignment: str, target_coords: np.ndarray):
    """The target's CA coordinates in query order through an M/I/D
    alignment: ``(coords (n, 3) float32, insertion (n,) bool)``, an
    insertion (a query residue against a gap, D) carrying no coordinate
    (zeros; the reference never reads it)."""
    coords, ins = [], []
    t = 0
    for op in alignment:
        if op == "M":
            coords.append(target_coords[t])
            ins.append(False)
            t += 1
        elif op == "I":
            t += 1
        else:
            coords.append(np.zeros(3, np.float32))
            ins.append(True)
    return np.asarray(coords, np.float32).reshape(-1, 3), np.asarray(ins)
