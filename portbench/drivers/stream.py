"""Driver ``stream``: catalogue annotation through the engine's stream.

Set-up makes the configuration's weights on the device from the seed,
builds the port's ``BatchedPredictor`` on them, makes the mix's pool of
aligned proteins, and warms every length bucket the pool fills, at its
steady batch and at the smallest straggler batch. The window then feeds
``predict_stream(net="gcn_coords")`` from an iterator that replays the pool
in a fresh order from the seed and stops at the deadline, closed loop, as
``predict-function`` feeds the engine; the stragglers are flushed inside the
window. Every mode of the configuration scores every protein.

Afterwards a sample of the finished proteins drawn from the seed, with the
longest among them, goes through the plain reference; the run is correct
when every protein offered came back in every mode and the widest gap
between a sampled score and the reference's is within the configuration's
limit. In a control run the reference's scores in TF32 take the program's
place in that comparison.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import checks, reference, traffic, weights
from portbench.trace import DeviceTrace

BUCKETS = (128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    return next(b for b in BUCKETS if n <= b)


class _Collector:
    """Counts what each engine batch returned and keeps a reservoir sample
    (drawn from the seed) of finished proteins' scores, plus the longest."""

    def __init__(self, modes, lengths_of, rng, size: int):
        self.modes, self.lengths_of, self.rng = modes, lengths_of, rng
        self.size = size
        self.returned = {m: 0 for m in modes}
        self.seen = 0
        self.sample: dict = {}
        self.longest = (-1, None, None)
        self.batches: list = []
        self.lengths: list = []

    def __call__(self, emit: dict) -> None:
        first = emit[self.modes[0]]
        for m in self.modes:
            self.returned[m] += len(emit.get(m, ()))
        ns = [self.lengths_of(qid) for qid in first]
        n = np.asarray(ns, np.int64)
        self.batches.append((len(ns), int(n.sum()), int((n * n).sum())))
        self.lengths.extend(ns)
        for qid, length in zip(first, ns):
            if not all(qid in emit.get(m, {}) for m in self.modes):
                continue
            scores = {m: emit[m][qid] for m in self.modes}
            if length > self.longest[0]:
                self.longest = (length, qid, scores)
            self.seen += 1
            if len(self.sample) < self.size:
                self.sample[qid] = scores
            else:
                j = int(self.rng.integers(self.seen))
                if j < self.size:
                    victim = list(self.sample)[j]
                    del self.sample[victim]
                    self.sample[qid] = scores


def _engine(ctx, trees):
    from metagenomic_deepfri_tpu_torch.batching.engine import (
        BatchedPredictor, ModelHandle)
    from metagenomic_deepfri_tpu_torch.models.deepfri import GCNConfig

    c = ctx.config
    handles = {m: ModelHandle("gcn", m, GCNConfig(
        n_labels=terms, vocab=c["vocab"], lm_hidden=c["lm_hidden"],
        lm_layers=c["lm_layers"], embed_dim=c["embed_dim"],
        gc_dims=tuple(c["gc_dims"]), fc_dims=tuple(c["fc_dims"]),
        adj_norm=c["adj_norm"], pool="sum",
        compute_dtype=c["compute_dtype"]), trees[m])
        for m, terms in c["modes"].items()}
    return BatchedPredictor(gcn_models=handles, device=ctx.device,
                            contact_threshold=c["contact_threshold"],
                            generated_contacts=c["generated_contacts"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _warm(engine, modes, pool, ctx) -> None:
    """One steady batch and one smallest straggler batch of every bucket
    the pool fills (the engine's batch rule, ``gcn_batch_size``)."""
    from metagenomic_deepfri_tpu_torch.batching.buckets import gcn_batch_size

    by_bucket: dict = {}
    for i, (seq, _, _) in enumerate(pool):
        by_bucket.setdefault(_bucket(len(seq)), []).append(i)
    items = []
    for b, idx in sorted(by_bucket.items()):
        want = gcn_batch_size(b) + 1
        for k in range(want):
            seq, coords, ins = pool[idx[k % len(idx)]]
            items.append((f"w{b}_{k}", seq, coords, ins))
    engine.predict_stream(iter(items), net="gcn_coords", modes=modes)
    _sync(ctx.device)


def run(ctx) -> dict:
    c, mix = ctx.config, ctx.traffic
    modes = list(c["modes"])
    trees = weights.make(c, ctx.seed, ctx.device, nets=("gcn",))["gcn"]
    engine = _engine(ctx, trees)
    pool = traffic.protein_pool(ctx.seed, mix)
    pool_len = [len(p[0]) for p in pool]
    _warm(engine, modes, pool, ctx)

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
        _sync(ctx.device)
        t1 = time.perf_counter()
    del engine
    peak = checks.release(ctx.device)

    complete = min(collect.returned.values())
    sample = dict(collect.sample)
    if collect.longest[1] is not None:
        sample[collect.longest[1]] = collect.longest[2]
    program_gap, control_gap = _gaps(ctx, trees, pool, offered, sample)
    compared = {
        "missing": {"value": len(offered) - complete, "limit": 0},
        "score_gap": {"value": (program_gap if control_gap is None
                                else control_gap),
                      "limit": float(c["limits"]["score_gap"])},
    }
    record = {"window_s": t1 - t0, "attempted": len(offered),
              "failed": len(offered) - complete, "completed": complete,
              "lengths": np.asarray(collect.lengths, np.int64),
              "batches": collect.batches, "modes": modes, "config": c,
              "memory_peak_bytes": peak, "checks": compared,
              "trace": tr if ctx.trace else None,
              "sampled": len(sample), "program_gap": program_gap}
    return record


def _gaps(ctx, trees, pool, offered, sample) -> tuple:
    """The widest |score − reference score| over the sample, of the
    program's scores and, in a control run, of the reference's in TF32 put
    in the program's place (else None)."""
    rnds = checks.rounds(ctx.control)
    ref = checks.reference_scores(
        ctx, trees, [(q, pool[offered[int(q[1:])]]) for q in sample], "gcn",
        rnds, block=16)
    exact = ref[reference.exact]

    def widest(got):
        return max(checks.widest(got[q][m], exact[q][m])
                   for q in sample for m in sample[q])

    return widest(sample), (widest(ref[reference.tf32]) if ctx.control
                            else None)
