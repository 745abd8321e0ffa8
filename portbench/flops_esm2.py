"""The arithmetic of a configuration with an ESM-2 trunk: its matmul
FLOPs at real lengths and the least time of its attention, for
``readers/esm2_mfu.py`` and ``readers/esm2_sdpa_roofline.py``.

Counted for the algorithm, over each protein's own n + 2 tokens (``<cls>``
and ``<eos>`` included, padding left out): a layer's projections and
feed-forward, 2·(3d² + d² + 2·d·F) a token, and its attention, 4·d a pair
of tokens of one protein (q·kᵀ and the weights times v, over every head).
"""

from __future__ import annotations

from portbench import flops


def trunk_flops(esm: dict, tokens: int, pairs: int) -> float:
    """ESM-2's matmul FLOPs over ``tokens`` tokens and ``pairs`` pairs of
    tokens (Σ(n+2) and Σ(n+2)² of the proteins)."""
    d, f = esm["dim"], esm["ffn"]
    return esm["layers"] * (2.0 * (4 * d * d + 2 * d * f) * tokens
                            + 4.0 * d * pairs)


def junction_flops(config: dict, n: int) -> float:
    """The embedding merge of one protein of n residues: the trunk's
    output and the one-hot into ``embed_dim``."""
    E = config["embed_dim"]
    return 2.0 * n * (config["esm"]["dim"] + config["vocab"]) * E


def tails_flops(config: dict, n: int, modes) -> float:
    """Every mode's GraphConv stack, FC stack and head at length n."""
    return sum(flops.gcn_mode_flops(config, n, config["modes"][m])
               for m in modes)


def attention_bound_s(esm: dict, tokens: int, pairs: int,
                      chip: dict) -> float:
    """Least seconds of one layer's softmax(q·kᵀ)·v over a batch: the
    larger of its operations (4·d a pair) at the peak rate and its bytes
    (float32 q, k and v read and the output written, 16·d a token) at the
    memory rate."""
    d = esm["dim"]
    return max(4.0 * d * pairs / chip["flops"],
               16.0 * d * tokens / chip["bytes_per_s"])
