"""The arithmetic of a configuration with a ProtT5 encoder trunk: its matmul
FLOPs at real lengths and the least time of its attention, for
``readers/t5_mfu.py`` and ``readers/t5_sdpa_roofline.py``.

Counted for the algorithm, over each protein's own n + 1 tokens (``</s>``
included, padding left out), with the attention's inner width
I = heads·d_kv (4,096 in ProtT5-XL, not d): a layer's projections and
feed-forward, 2·(4·d·I + 2·d·F) a token, and its attention, 4·I a pair of
tokens of one protein (q·kᵀ and the weights times v, over every head).
"""

from __future__ import annotations

from portbench import flops


def _inner(t5: dict) -> int:
    return t5["heads"] * t5["d_kv"]


def trunk_flops(t5: dict, tokens: int, pairs: int) -> float:
    """The encoder's matmul FLOPs over ``tokens`` tokens and ``pairs``
    pairs of tokens (Σ(n+1) and Σ(n+1)² of the proteins)."""
    d, f, inner = t5["dim"], t5["ffn"], _inner(t5)
    return t5["layers"] * (2.0 * (4 * d * inner + 2 * d * f) * tokens
                           + 4.0 * inner * pairs)


def junction_flops(config: dict, n: int) -> float:
    """The embedding merge of one protein of n residues: the encoder's
    output and the one-hot into ``embed_dim``."""
    E = config["embed_dim"]
    return 2.0 * n * (config["t5"]["dim"] + config["vocab"]) * E


def tails_flops(config: dict, n: int, modes) -> float:
    """Every mode's GraphConv stack, FC stack and head at length n."""
    return sum(flops.gcn_mode_flops(config, n, config["modes"][m])
               for m in modes)


def attention_bound_s(t5: dict, tokens: int, pairs: int,
                      chip: dict) -> float:
    """Least seconds of one layer's softmax(q·kᵀ + bias)·v over a batch:
    the larger of its operations (4·I a pair) at the peak rate and its
    bytes (float32 q, k and v read and the output written, 16·I a token)
    at the memory rate."""
    inner = _inner(t5)
    return max(4.0 * inner * pairs / chip["flops"],
               16.0 * inner * tokens / chip["bytes_per_s"])
