"""Driver ``stream_dp``: the ``stream`` driver's catalogue stream on the
port's data-parallel engine over the mix's ``devices`` cards of one host.

The weights are made on the first card, where the reference runs too; the
engine (``BatchedPredictor(device="cuda:0,…,cuda:N-1")``) places a replica
on every card, scales the steady batch by the card count and splits each
batch into one equal slice a card. Set-up warms every length bucket the
pool fills at that steady batch and at the smallest straggler batch; the
window and the check are ``stream_window.py``'s, the reference the
``stream`` driver's. Off a CUDA device (the CPU tests) every replica is a
CPU one.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench import stream_window, traffic, weights
from portbench.drivers.stream import _engine, _gaps


def _devices(ctx) -> list:
    n = int(ctx.traffic["devices"])
    if torch.device(ctx.device).type != "cuda":
        return [str(ctx.device)] * n
    return [f"cuda:{i}" for i in range(n)]


def run(ctx) -> dict:
    devices = _devices(ctx)
    trees = weights.make(ctx.config, ctx.seed, ctx.device,
                         nets=("gcn",))["gcn"]
    engine = _engine(SimpleNamespace(config=ctx.config,
                                     device=",".join(devices)), trees)
    pool = traffic.protein_pool(ctx.seed, ctx.traffic)

    def sync():
        for d in devices:
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)

    stream_window.warm(engine, list(ctx.config["modes"]), pool)
    sync()
    return stream_window.measure(
        ctx, engine, pool, sync,
        lambda offered, sample: _gaps(ctx, trees, pool, offered, sample))
