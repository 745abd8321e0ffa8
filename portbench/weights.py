"""Random weights of a configuration, made on the device from the seed.

One ``torch.rand`` call on the device's own generator fills every weight of
every network at once; each leaf is then a scaled view of that buffer
(Glorot-uniform, as Keras initialises the published models' layers; LSTM
forget-gate biases 1, other biases 0). The trees have the layout the port's
engine takes (dense kernels stored (in, out), LSTM gates [i, f, c, o]).
GCN modes of a configuration with ``share_trunk`` share one LSTM-LM and its
two embeddings, as the published model set does.
"""

from __future__ import annotations

import math

import torch


def _layout(config: dict, modes: list, nets: tuple) -> list:
    """(path, shape, scale) of every uniform leaf, in generation order."""
    V, H, E = config["vocab"], config["lm_hidden"], config["embed_dim"]
    leaves = []

    def dense(path, i, o, scale=1.0):
        leaves.append((path + ("kernel",), (i, o),
                       scale * math.sqrt(6.0 / (i + o))))

    def trunk(prefix):
        d = V
        for k in range(config["lm_layers"]):
            leaves.append((prefix + ("lm", k, "kernel"), (d, 4 * H),
                           math.sqrt(6.0 / (d + 4 * H))))
            leaves.append((prefix + ("lm", k, "recurrent"), (H, 4 * H),
                           math.sqrt(6.0 / (5 * H))))
            d = H
        dense(prefix + ("lm_embed",), H, E)
        dense(prefix + ("aa_embed",), V, E)

    if "gcn" in nets:
        shared = config.get("share_trunk", False)
        if shared:
            trunk(("gcn_shared",))
        for m in modes:
            if not shared:
                trunk(("gcn", m))
            d = E
            for k, o in enumerate(config["gc_dims"]):
                dense(("gcn", m, "gc", k), d, o)
                d = o
            d = sum(config["gc_dims"])
            for k, o in enumerate(config["fc_dims"]):
                dense(("gcn", m, "fc", k), d, o)
                d = o
            dense(("gcn", m, "head"), d, 2 * config["modes"][m],
                  config["head_init_scale"])
    if "cnn" in nets:
        c = config["cnn"]
        F = c["conv_filters"]
        for m in modes:
            for k, w in enumerate(c["conv_kernels"]):
                leaves.append((("cnn", m, "conv", k, "kernel"), (w, V, F),
                               math.sqrt(6.0 / (w * V + F))))
            d = F * len(c["conv_kernels"])
            for k, o in enumerate(c["fc_dims"]):
                dense(("cnn", m, "fc", k), d, o)
                d = o
            dense(("cnn", m, "head"), d, 2 * config["modes"][m],
                  config["head_init_scale"])
    return leaves


def _put(tree: dict, path: tuple, value) -> None:
    """Set ``tree[p0][p1]...`` (integer keys for list positions)."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _listed(node: dict) -> list:
    """The values of a dict with keys 0..n-1, in order."""
    return [node[k] for k in range(len(node))]


def make(config: dict, seed: int, device, nets=("gcn",)) -> dict:
    """``{"gcn": {mode: tree}, "cnn": {mode: tree}}`` of float32 tensors on
    ``device``, from ``seed``; the modes are the configuration's."""
    device = torch.device(device)
    modes = list(config["modes"])
    leaves = _layout(config, modes, tuple(nets))
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    raw: dict = {}
    at = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        _put(raw, path, flat[at:at + n].view(shape).mul_(scale))
        at += n

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    out = {"gcn": {}, "cnn": {}}
    H = config["lm_hidden"]
    trunk_src = raw.get("gcn_shared")
    for m in modes if "gcn" in nets else ():
        src = raw["gcn"][m]
        t = trunk_src if trunk_src is not None else src
        if "lm_tree" not in t:
            lm = []
            for layer in _listed(t["lm"]):
                bias = zeros(4 * H)
                bias[H:2 * H] = 1.0
                lm.append({**layer, "bias": bias})
            t["lm_tree"] = (lm, {"kernel": t["lm_embed"]["kernel"]},
                            {"kernel": t["aa_embed"]["kernel"],
                             "bias": zeros(config["embed_dim"])})
        lm, lm_embed, aa_embed = t["lm_tree"]
        out["gcn"][m] = {
            "lm": lm, "lm_embed": lm_embed, "aa_embed": aa_embed,
            "gc": [{"kernel": g["kernel"]} for g in _listed(src["gc"])],
            "fc": [{"kernel": f["kernel"], "bias": zeros(f["kernel"].shape[1])}
                   for f in _listed(src["fc"])],
            "head": {"kernel": src["head"]["kernel"],
                     "bias": zeros(src["head"]["kernel"].shape[1])}}
    for m in modes if "cnn" in nets else ():
        src = raw["cnn"][m]
        out["cnn"][m] = {
            "conv": [{"kernel": c["kernel"],
                      "bias": zeros(c["kernel"].shape[2])}
                     for c in _listed(src["conv"])],
            "fc": [{"kernel": f["kernel"], "bias": zeros(f["kernel"].shape[1])}
                   for f in _listed(src["fc"])],
            "head": {"kernel": src["head"]["kernel"],
                     "bias": zeros(src["head"]["kernel"].shape[1])}}
    return out
