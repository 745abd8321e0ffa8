"""Driver ``stream_esmc``: the catalogue stream of the ``stream`` driver on
a configuration whose GCN modes share an ESM C trunk.

Set-up builds the port's ``BatchedPredictor`` on ``ESMCGCNConfig``s (the
trunk's widths in ``esmc``), on weights made on the device from the seed
(``weights_esmc.py``), makes the mix's pool of aligned proteins and warms
every length bucket the pool fills, at its steady batch and at the
smallest straggler batch. The engine batches a transformer trunk by token
slots; the mix's ``token_slots`` states the rule it runs under, and a run
whose engine batches otherwise stops before it measures. A program without
an ESM C trunk stops at once, on its first import. The window and the
check are ``stream_window.py``'s: closed loop through
``predict_stream(net="gcn_coords")``, every mode scoring every protein,
then the sample of finished proteins against the plain reference
(``reference_esmc.py``). In a control run the reference's scores with
every matmul operand in TF32 take the program's place in that comparison.
"""

from __future__ import annotations

import torch

from portbench import (checks, reference, reference_esmc, stream_window,
                       traffic, weights_esmc)
from portbench.drivers.stream import _sync
from portbench.drivers.stream_prott5 import _check_slots


def run(ctx) -> dict:
    from metagenomic_deepfri_tpu_torch.models.deepfri import ESMCGCNConfig
    from metagenomic_deepfri_tpu_torch.models.esmc import ESMCConfig
    from metagenomic_deepfri_tpu_torch.batching.engine import (
        BatchedPredictor, ModelHandle)

    c = ctx.config
    esmc = ESMCConfig(**c["esmc"])
    pool = traffic.protein_pool(ctx.seed, ctx.traffic)
    trees = weights_esmc.make(c, ctx.seed, ctx.device)
    handles = {m: ModelHandle("gcn", m, ESMCGCNConfig(
        n_labels=terms, vocab=c["vocab"], embed_dim=c["embed_dim"],
        gc_dims=tuple(c["gc_dims"]), fc_dims=tuple(c["fc_dims"]),
        adj_norm=c["adj_norm"], pool="sum", compute_dtype=c["compute_dtype"],
        esmc=esmc), trees[m])
        for m, terms in c["modes"].items()}
    engine = BatchedPredictor(
        gcn_models=handles, device=ctx.device,
        contact_threshold=c["contact_threshold"],
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
                got = reference_esmc.gcn_block(
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
