"""Random weights of a configuration with an ESM-2 trunk, made on the
device from the seed.

As :mod:`portbench.weights`: one ``torch.rand`` call on the device's own
generator fills every weight at once, and each leaf is a scaled (and, for
LayerNorm scales, shifted) view of that buffer. The ESM-2 trunk's kernels
are Glorot-uniform, its biases uniform in (-0.1, 0.1), its LayerNorm
scales in (0.8, 1.2) and shifts in (-0.1, 0.1), its token embedding in
(-1, 1); the GCN tails as ``weights.py`` makes them (Glorot-uniform, biases
0, the head scaled by ``head_init_scale``). The trees have the layout the
port's engine takes (``models/esm2.py``: kernels (in, out), q, k and v side
by side in ``qkv``). Every mode's tree holds the one trunk and the one pair
of embeddings, as a model set that shares them is loaded.
"""

from __future__ import annotations

import math

import torch

from portbench.weights import _listed, _put


def _layout(config: dict) -> list:
    """(path, shape, scale, shift) of every uniform leaf, in generation
    order."""
    e = config["esm"]
    d, f, E = e["dim"], e["ffn"], config["embed_dim"]
    leaves = [(("lm", "embed"), (e["vocab"], d), 1.0, 0.0)]

    def dense(path, i, o, scale=1.0, bias=True):
        leaves.append((path + ("kernel",), (i, o),
                       scale * math.sqrt(6.0 / (i + o)), 0.0))
        if bias:
            leaves.append((path + ("bias",), (o,), 0.1, 0.0))

    def norm(path, n):
        leaves.append((path + ("scale",), (n,), 0.2, 1.0))
        leaves.append((path + ("bias",), (n,), 0.1, 0.0))

    for k in range(e["layers"]):
        p = ("lm", "layers", k)
        norm(p + ("ln1",), d)
        dense(p + ("qkv",), d, 3 * d)
        dense(p + ("out",), d, d)
        norm(p + ("ln2",), d)
        dense(p + ("fc1",), d, f)
        dense(p + ("fc2",), f, d)
    norm(("lm", "ln_after"), d)
    dense(("lm_embed",), d, E, bias=False)
    dense(("aa_embed",), config["vocab"], E, bias=False)
    for m, terms in config["modes"].items():
        i = E
        for k, o in enumerate(config["gc_dims"]):
            dense(("gcn", m, "gc", k), i, o, bias=False)
            i = o
        i = sum(config["gc_dims"])
        for k, o in enumerate(config["fc_dims"]):
            dense(("gcn", m, "fc", k), i, o, bias=False)
            i = o
        dense(("gcn", m, "head"), i, 2 * terms, config["head_init_scale"],
              bias=False)
    return leaves


def make(config: dict, seed: int, device) -> dict:
    """``{mode: tree}`` of float32 tensors on ``device``, from ``seed``."""
    device = torch.device(device)
    leaves = _layout(config)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    raw: dict = {}
    at = 0
    for path, shape, scale, shift in leaves:
        n = math.prod(shape)
        _put(raw, path, flat[at:at + n].view(shape).mul_(scale).add_(shift))
        at += n

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    lm = raw["lm"]
    lm["layers"] = _listed(lm["layers"])
    aa = {"kernel": raw["aa_embed"]["kernel"],
          "bias": zeros(config["embed_dim"])}
    out = {}
    for m in config["modes"]:
        src = raw["gcn"][m]
        out[m] = {
            "lm": lm, "lm_embed": raw["lm_embed"], "aa_embed": aa,
            "gc": [{"kernel": g["kernel"]} for g in _listed(src["gc"])],
            "fc": [{"kernel": f["kernel"], "bias": zeros(f["kernel"].shape[1])}
                   for f in _listed(src["fc"])],
            "head": {"kernel": src["head"]["kernel"],
                     "bias": zeros(src["head"]["kernel"].shape[1])}}
    return out
