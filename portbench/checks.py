"""What the plain reference says a served query should get: the route (the
GCN on the structure the query was made from, or the CNN), and each mode's
scores, for the pipeline and server cells.

A hit query is re-aligned to its source structure's sequence by
:func:`reference.global_alignment`, the structure's CA coordinates (read
from the database file both sides read) are projected through that
alignment, and the GCN reference scores it; a query without a hit is
scored by the CNN reference. ``rnds`` are the roundings to score with:
:func:`reference.exact`, and :func:`reference.tf32` for the control.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import reference, traffic


def sample(seed: int, stream: int, queries: list, n_hits: int,
           n_others: int) -> list:
    """``(id, sequence, source)`` queries drawn from ``seed``: ``n_hits``
    with a hit, ``n_others`` without, and the longest hit query."""
    rng = traffic.seed_rng(seed, stream)
    hits = [q for q in queries if q[2] is not None]
    others = [q for q in queries if q[2] is None]
    pick = [hits[i] for i in rng.choice(len(hits), min(len(hits), n_hits),
                                        replace=False)]
    pick += [others[i] for i in rng.choice(
        len(others), min(len(others), n_others), replace=False)]
    if hits:
        longest = max(hits, key=lambda q: len(q[1]))
        if longest not in pick:
            pick.append(longest)
    return pick


def rounds(control: bool) -> list:
    """The roundings to score with: exact, and TF32 in a control run."""
    return [reference.exact] + ([reference.tf32] if control else [])


def release(device) -> int:
    """The device's memory peak so far; then the program's cached blocks
    are freed, so that the reference that runs next sets no peak."""
    gc.collect()
    if torch.device(device).type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return peak


def reference_scores(ctx, trees: dict, items: list, net: str, rnds,
                     block: int = 8) -> dict:
    """``{rnd: {id: {mode: float64 scores}}}`` of ``(id, protein)`` items
    (``(sequence, coords, insertion)``; coordinates unused by the CNN),
    run in blocks of similar length."""
    out = {r: {qid: {} for qid, _ in items} for r in rnds}
    lengths = [len(p[0]) for _, p in items]
    with reference.full_precision(), torch.inference_mode():
        for b in reference.blocks(list(range(len(items))), lengths, block):
            proteins = [items[i][1] for i in b]
            for rnd in rnds:
                ref = (reference.gcn_block(trees, ctx.config, proteins,
                                           ctx.device, rnd)
                       if net == "gcn" else reference.cnn_block(
                           trees, proteins, ctx.device, rnd))
                for m, scores in ref.items():
                    host = scores.double().cpu().numpy()
                    for k, i in enumerate(b):
                        out[rnd][items[i][0]][m] = host[k]
    return out


def expected(ctx, trees: dict, db: list, db_dir, queries: list,
             rnds=(reference.exact,)) -> dict:
    """``{id: (network, target id or None, {rnd: {mode: scores}})}`` of
    ``(id, sequence, source)`` queries."""
    mix = ctx.traffic
    items = {"gcn": [], "cnn": []}
    route = {}
    for qid, seq, source in queries:
        if source is None:
            items["cnn"].append((qid, (seq, None, None)))
            route[qid] = ("cnn", None)
            continue
        sid = db[source][0]
        t_seq, t_xyz = traffic.read_pdb((db_dir / f"{sid}.pdb").read_text())
        aln = reference.global_alignment(seq, t_seq, int(mix["gap_open"]),
                                         int(mix["gap_extend"]))
        items["gcn"].append((qid, (seq, *reference.project(aln, t_xyz))))
        route[qid] = ("gcn", sid)
    scores = {net: reference_scores(ctx, trees[net], its, net, rnds)
              for net, its in items.items()}
    return {qid: (net, sid, {r: scores[net][r][qid] for r in rnds})
            for qid, (net, sid) in route.items()}


def widest(a: np.ndarray, b: np.ndarray) -> float:
    d = float(np.max(np.abs(np.asarray(a, np.float64) - b)))
    return d if d == d else float("inf")
