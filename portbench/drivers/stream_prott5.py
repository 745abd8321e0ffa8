"""Driver ``stream_prott5``: the catalogue stream of the ``stream`` driver
on a configuration whose GCN modes share a ProtT5 encoder trunk.

Set-up builds the port's ``BatchedPredictor`` on ``ProtT5GCNConfig``s (the
encoder's widths in ``t5``), on weights made on the device from the seed
(``weights_prott5.py``), makes the mix's pool of aligned proteins and
warms every length bucket the pool fills, at its steady batch and at the
smallest straggler batch. The engine batches a transformer trunk by
token slots; the mix's ``token_slots`` states the rule it runs under, and a run whose engine batches otherwise stops before it
measures. A program without a ProtT5 trunk stops at once, on its first
import. The window and the check are ``stream_window.py``'s: closed loop
through ``predict_stream(net="gcn_coords")``, every mode scoring every
protein, then the sample of finished proteins against the plain reference
(``reference_prott5.py``). In a control run the reference's scores with
every matmul operand in TF32 take the program's place in that comparison.
"""

from __future__ import annotations

import torch

from portbench import (checks, reference, reference_prott5, stream_window,
                       traffic, weights_prott5)
from portbench.drivers.stream import _bucket, _sync


def _handles(c: dict, trees: dict, config_cls, t5) -> dict:
    """``{mode: ModelHandle}`` of the configuration on ``trees``."""
    from metagenomic_deepfri_tpu_torch.batching.engine import ModelHandle

    return {m: ModelHandle("gcn", m, config_cls(
        n_labels=terms, vocab=c["vocab"], embed_dim=c["embed_dim"],
        gc_dims=tuple(c["gc_dims"]), fc_dims=tuple(c["fc_dims"]),
        adj_norm=c["adj_norm"], pool="sum", compute_dtype=c["compute_dtype"],
        t5=t5), trees[m])
        for m, terms in c["modes"].items()}


def _check_slots(engine, pool, slots: int) -> None:
    """Every bucket the pool fills batches ``slots`` token slots."""
    for b in sorted({_bucket(len(p[0])) for p in pool}):
        rows = engine._steady_batch(b)
        if rows * b != slots:
            raise ValueError(f"the engine batches {rows} rows at bucket {b}, "
                             f"not the mix's {slots} token slots")


def run(ctx) -> dict:
    from metagenomic_deepfri_tpu_torch.batching.engine import BatchedPredictor
    from metagenomic_deepfri_tpu_torch.models.deepfri import ProtT5GCNConfig
    from metagenomic_deepfri_tpu_torch.models.prott5 import ProtT5Config

    c = ctx.config
    pool = traffic.protein_pool(ctx.seed, ctx.traffic)
    trees = weights_prott5.make(c, ctx.seed, ctx.device)
    engine = BatchedPredictor(
        gcn_models=_handles(c, trees, ProtT5GCNConfig,
                            ProtT5Config(**c["t5"])),
        device=ctx.device, contact_threshold=c["contact_threshold"],
        generated_contacts=c["generated_contacts"])
    _check_slots(engine, pool, int(ctx.traffic["token_slots"]))
    stream_window.warm(engine, list(c["modes"]), pool)
    _sync(ctx.device)
    return stream_window.measure(
        ctx, engine, pool, lambda: _sync(ctx.device),
        lambda offered, sample: _gaps(ctx, trees, pool, offered, sample))


def _gaps(ctx, trees, pool, offered, sample) -> tuple:
    """The widest |score − reference score| over the sample, of the
    program's scores and, in a control run, of the reference's in TF32 put
    in the program's place (else None)."""
    rnds = checks.rounds(ctx.control)
    items = [(q, pool[offered[int(q[1:])]]) for q in sample]
    ref = {r: {q: {} for q in sample} for r in rnds}
    with reference.full_precision(), torch.inference_mode():
        for b in reference.blocks(list(range(len(items))),
                                  [len(p[0]) for _, p in items], 16):
            for rnd in rnds:
                got = reference_prott5.gcn_block(
                    trees, ctx.config, [items[i][1] for i in b], ctx.device,
                    rnd)
                for m, scores in got.items():
                    host = scores.double().cpu().numpy()
                    for k, i in enumerate(b):
                        ref[rnd][items[i][0]][m] = host[k]
    exact = ref[reference.exact]

    def widest(got):
        return max(checks.widest(got[q][m], exact[q][m])
                   for q in sample for m in sample[q])

    return widest(sample), (widest(ref[reference.tf32]) if ctx.control
                            else None)
