"""Random weights of a configuration with a ProtT5 encoder trunk, made on
the device from the seed.

As :mod:`portbench.weights`: one ``torch.rand`` call on the device's own
generator fills every weight at once, and each leaf is a scaled (and, for
RMSNorm scales, shifted) view of that buffer. The encoder's leaves are
uniform at T5's initialisation standard deviations
(``T5PreTrainedModel._init_weights``; a uniform of half-width √3·σ):
q (d·d_kv)^-½, k and v d^-½ (q, k and v side by side in one ``qkv``
kernel, scaled by column block), o (H·d_kv)^-½, wi d^-½, wo d_ff^-½, the
token embedding 1 and the relative-position bias table d^-½; its RMSNorm
scales lie in (0.8, 1.2). The GCN tails as ``weights.py`` makes them
(Glorot-uniform, biases 0, the head scaled by ``head_init_scale``). The
trees have the layout the port's engine takes (``models/prott5.py``:
kernels (in, out), no biases in the encoder). Every mode's tree holds the
one encoder and the one pair of embeddings, as a model set that shares
them is loaded.
"""

from __future__ import annotations

import math

import torch

from portbench.weights import _listed, _put

_SQRT3 = math.sqrt(3.0)


def _layout(config: dict) -> list:
    """(path, shape, scale, shift) of every uniform leaf, in generation
    order; a tuple ``scale`` scales equal blocks of columns each by its
    own."""
    t = config["t5"]
    d, f, E = t["dim"], t["ffn"], config["embed_dim"]
    inner = t["heads"] * t["d_kv"]
    leaves = [(("lm", "embed"), (t["vocab"], d), _SQRT3, 0.0),
              (("lm", "rel_bias"), (t["buckets"], t["heads"]),
               _SQRT3 * d ** -0.5, 0.0)]

    def kernel(path, shape, std):
        leaves.append((path + ("kernel",), shape, std, 0.0))

    def norm(path):
        leaves.append((path + ("scale",), (d,), 0.2, 1.0))

    for k in range(t["layers"]):
        p = ("lm", "layers", k)
        norm(p + ("ln1",))
        kv = _SQRT3 * d ** -0.5
        kernel(p + ("qkv",), (d, 3 * inner),
               (_SQRT3 * (d * t["d_kv"]) ** -0.5, kv, kv))
        kernel(p + ("o",), (inner, d), _SQRT3 * inner ** -0.5)
        norm(p + ("ln2",))
        kernel(p + ("wi",), (d, f), _SQRT3 * d ** -0.5)
        kernel(p + ("wo",), (f, d), _SQRT3 * f ** -0.5)
    norm(("lm", "ln_final"))

    def glorot(path, i, o, scale=1.0):
        kernel(path, (i, o), scale * math.sqrt(6.0 / (i + o)))

    glorot(("lm_embed",), d, E)
    glorot(("aa_embed",), config["vocab"], E)
    for m, terms in config["modes"].items():
        i = E
        for k, o in enumerate(config["gc_dims"]):
            glorot(("gcn", m, "gc", k), i, o)
            i = o
        i = sum(config["gc_dims"])
        for k, o in enumerate(config["fc_dims"]):
            glorot(("gcn", m, "fc", k), i, o)
            i = o
        glorot(("gcn", m, "head"), i, 2 * terms, config["head_init_scale"])
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
        leaf = flat[at:at + n].view(shape)
        if isinstance(scale, tuple):
            w = shape[1] // len(scale)
            for j, s in enumerate(scale):
                leaf[:, j * w:(j + 1) * w].mul_(s)
        else:
            leaf.mul_(scale)
        _put(raw, path, leaf.add_(shift))
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
