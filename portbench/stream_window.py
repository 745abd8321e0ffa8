"""The measured window and the check of a catalogue-stream cell, shared by
the ``stream_esm2`` and ``stream_dp`` drivers (the ``stream`` driver's own,
with the engine, the warm-up and the reference left to the caller).

The window feeds ``predict_stream(net="gcn_coords")`` from an iterator that
replays the pool in a fresh order from the seed and stops at the deadline,
closed loop, as ``predict-function`` feeds the engine; the stragglers are
flushed inside the window. Afterwards a sample of the finished proteins
drawn from the seed, with the longest among them, is judged by the
caller's ``gaps``: the run is correct when every protein offered came back
in every mode and the widest gap between a sampled score and the
reference's is within the configuration's limit.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import checks, traffic
from portbench.drivers.stream import _Collector, _bucket
from portbench.trace import DeviceTrace


def warm(engine, modes, pool) -> None:
    """One steady batch (the engine's own) and one smallest straggler
    batch of every bucket the pool fills."""
    by_bucket: dict = {}
    for i, (seq, _, _) in enumerate(pool):
        by_bucket.setdefault(_bucket(len(seq)), []).append(i)
    items = []
    for b, idx in sorted(by_bucket.items()):
        for k in range(engine._steady_batch(b) + 1):
            seq, coords, ins = pool[idx[k % len(idx)]]
            items.append((f"w{b}_{k}", seq, coords, ins))
    engine.predict_stream(iter(items), net="gcn_coords", modes=modes)


def measure(ctx, engine, pool, sync, gaps) -> dict:
    """Run the window on ``engine`` (``sync()`` waits for its devices),
    free the device's cached blocks, and check the sample with ``gaps(offered, sample)``, which
    returns the widest gap of the program's scores and, in a control run,
    of the control's (else None). Returns the run's record."""
    c, mix = ctx.config, ctx.traffic
    modes = list(c["modes"])
    pool_len = [len(p[0]) for p in pool]
    offered: list = []
    collect = _Collector(modes, lambda qid: pool_len[offered[int(qid[1:])]],
                         traffic.seed_rng(ctx.seed, 3), int(mix["sample"]))
    order = traffic.replay_order(ctx.seed, len(pool))

    def feed(deadline):
        for k, i in enumerate(order):
            if time.perf_counter() >= deadline:
                return
            offered.append(i)
            seq, coords, ins = pool[i]
            yield (f"q{k}", seq, coords, ins)

    tr = DeviceTrace()
    with tr.record(ctx.trace, ctx.device):
        t0 = ctx.started()
        engine.predict_stream(feed(t0 + ctx.seconds), net="gcn_coords",
                              modes=modes, result_cb=collect)
        sync()
        t1 = time.perf_counter()
    peak = checks.release(ctx.device)

    complete = min(collect.returned.values())
    sample = dict(collect.sample)
    if collect.longest[1] is not None:
        sample[collect.longest[1]] = collect.longest[2]
    program_gap, control_gap = gaps(offered, sample)
    compared = {
        "missing": {"value": len(offered) - complete, "limit": 0},
        "score_gap": {"value": (program_gap if control_gap is None
                                else control_gap),
                      "limit": float(c["limits"]["score_gap"])},
    }
    return {"window_s": t1 - t0, "attempted": len(offered),
            "failed": len(offered) - complete, "completed": complete,
            "lengths": np.asarray(collect.lengths, np.int64),
            "batches": collect.batches, "modes": modes, "config": c,
            "memory_peak_bytes": peak, "checks": compared,
            "trace": tr if ctx.trace else None,
            "sampled": len(sample), "program_gap": program_gap}
