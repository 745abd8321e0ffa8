"""The yardstick's arithmetic: the chip's peaks, a model's matmul FLOPs at
real lengths, and the least time of the GraphConv aggregation.

Copied from the port's ``bench_utils.analytic_gcn_trunk_flops`` /
``analytic_gcn_matmul_flops`` / ``analytic_cnn_matmul_flops`` (counted here
at each protein's own length, not at its padded bucket) and
``chip_smoke.kernel_bound`` (bytes of each input read once and each output
written once; operations counted for the algorithm, 2·Σn²·D, not for one
implementation's bf16 planes).
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense, at its 700 W limit: the highest
# tensor-core rate without sparsity (bf16; no route or precision of the
# port exceeds it) and the HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes_per_s": 3.35e12},
}


def peak(kind: str) -> dict | None:
    return PEAKS.get(kind)


def gcn_trunk_flops(config: dict, n: int) -> float:
    """LSTM-LM and the two embedding projections of one protein of length
    ``n``: the part a shared-trunk step computes once for all modes."""
    V, H, E = config["vocab"], config["lm_hidden"], config["embed_dim"]
    f, d = 0.0, V
    for _ in range(config["lm_layers"]):
        f += n * 2.0 * d * 4 * H + n * 2.0 * H * 4 * H
        d = H
    return f + n * 2.0 * d * E + n * 2.0 * V * E


def _fc_head_flops(fc_dims, d: int, terms: int) -> float:
    f = 0.0
    for o in fc_dims:
        f += 2.0 * d * o
        d = o
    return f + 2.0 * d * 2 * terms


def gcn_mode_flops(config: dict, n: int, terms: int) -> float:
    """One mode's GraphConv stack (A·X and X·W), FC stack and head."""
    f, d = 0.0, config["embed_dim"]
    for o in config["gc_dims"]:
        f += 2.0 * n * n * d + 2.0 * n * d * o
        d = o
    return f + _fc_head_flops(config["fc_dims"], sum(config["gc_dims"]),
                              terms)


def gcn_flops(config: dict, n: int, modes) -> float:
    """All ``modes`` of one protein, the shared trunk counted once when the
    configuration shares it, once a mode otherwise."""
    trunks = 1 if config.get("share_trunk") else len(modes)
    return (trunks * gcn_trunk_flops(config, n)
            + sum(gcn_mode_flops(config, n, config["modes"][m])
                  for m in modes))


def cnn_flops(config: dict, n: int, modes) -> float:
    c = config["cnn"]
    conv = sum(n * 2.0 * k * config["vocab"] * c["conv_filters"]
               for k in c["conv_kernels"])
    d = c["conv_filters"] * len(c["conv_kernels"])
    return sum(conv + _fc_head_flops(c["fc_dims"], d, config["modes"][m])
               for m in modes)


def aggregation_bound_s(sum_n: int, sum_n2: int, B: int, D: int,
                        chip: dict) -> float:
    """Least seconds of one Â·X aggregation over a batch of B proteins with
    Σn and Σn² residues, D features: the larger of its operations
    (2·Σn²·D) at the peak rate and its bytes (float32 features in and out,
    float32 coordinates and an insertion flag a residue, a length a
    protein) at the memory rate."""
    ops = 2.0 * sum_n2 * D
    nbytes = 8.0 * sum_n * D + 13.0 * sum_n + 4.0 * B
    return max(ops / chip["flops"], nbytes / chip["bytes_per_s"])
