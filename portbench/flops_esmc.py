"""The arithmetic of a configuration with an ESM C trunk: its matmul FLOPs
at real lengths and the least time of its attention and of its q and k
LayerNorms, for ``readers/trunk_mfu.py``, ``readers/trunk_sdpa_roofline.py``
and ``readers/esmc_qkln_roofline.py``.

Counted for the algorithm, over each protein's own n + 2 tokens (``<cls>``
and ``<eos>`` included, padding left out): a layer's projections and
gated feed-forward, 2·(3d² + d² + 2·d·F + F·d) = 2·(4d² + 3dF) a token
(``fc1`` computes 2F columns, of which SwiGLU keeps F), and its attention,
4·d a pair of tokens of one protein (q·kᵀ and the weights times v, over
every head).
"""

from __future__ import annotations

from portbench import flops


def trunk_flops(esmc: dict, tokens: int, pairs: int) -> float:
    """ESM C's matmul FLOPs over ``tokens`` tokens and ``pairs`` pairs of
    tokens (Σ(n+2) and Σ(n+2)² of the proteins)."""
    d, f = esmc["dim"], esmc["ffn"]
    return esmc["layers"] * (2.0 * (4 * d * d + 3 * d * f) * tokens
                             + 4.0 * d * pairs)


def junction_flops(config: dict, n: int) -> float:
    """The embedding merge of one protein of n residues: the trunk's
    output and the one-hot into ``embed_dim``."""
    E = config["embed_dim"]
    return 2.0 * n * (config["esmc"]["dim"] + config["vocab"]) * E


def tails_flops(config: dict, n: int, modes) -> float:
    """Every mode's GraphConv stack, FC stack and head at length n."""
    return sum(flops.gcn_mode_flops(config, n, config["modes"][m])
               for m in modes)


def attention_bound_s(esmc: dict, tokens: int, pairs: int,
                      chip: dict) -> float:
    """Least seconds of one layer's softmax(q·kᵀ/√d_h)·v over a batch: the
    larger of its operations (4·d a pair) at the peak rate and its bytes
    (float32 q, k and v read and the output written, 16·d a token) at the
    memory rate."""
    d = esmc["dim"]
    return max(4.0 * d * pairs / chip["flops"],
               16.0 * d * tokens / chip["bytes_per_s"])


def qkln_bound_s(esmc: dict, tokens: int, chip: dict) -> float:
    """Least seconds of one layer's q and k LayerNorms, rotary and scale
    over a batch: float32 q and k read and written once, 16·d bytes a
    token, at the memory rate (a few operations an element: bound by the
    bytes)."""
    return 16.0 * esmc["dim"] * tokens / chip["bytes_per_s"]
