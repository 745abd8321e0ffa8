"""Driver ``pipeline``: ``predict-function`` called on one chunk of queries
after another.

Set-up makes the configuration's GCNs and CNNs on the device from the seed
and writes them as a weights folder in the published format under
``TMPDIR``; writes the structure database (the configuration's scale, the
mix's lengths and seed) once per checkout, as CA traces, under
``portbench/cache/``; and runs one warm call with a hit and a
query without one in every length bucket. The window then calls the
command line's ``predict-function`` (search with the built-in engine,
re-alignment, coordinate projection, the GCNs for the queries with a hit
and the CNNs for the rest, the prediction matrices and ``results.tsv``) on
one call's queries after another; the call in flight at the deadline is
finished and counted.

Afterwards every call's outputs are read: every query has to have a row of
every mode. A sample of queries drawn from the seed, with the longest hit
among them, is checked against the plain reference: a hit query has to be
aligned to the structure it was made from and scored by the GCN on the
reference's own re-alignment and projection; a query without a hit has to
be unaligned and scored by the CNN. Then the calls' outputs are deleted.
In a control run the reference's scores in TF32 take the program's place
in the comparison of scores.
"""

from __future__ import annotations

import contextlib
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import checks, onnx_writer, reference, traffic, weights
from portbench.trace import DeviceTrace


def _call(queries: list, out: Path, weights_dir: Path, db_dir: Path,
          mix: dict, modes: list, device: str) -> None:
    from metagenomic_deepfri_tpu_torch import cli

    out.mkdir(parents=True)
    fasta = out / "queries.faa"
    fasta.write_text("".join(f">{q}\n{s}\n" for q, s, _ in queries))
    argv = ["predict-function", "-i", str(fasta), "-d", str(db_dir),
            "-w", str(weights_dir), "-o", str(out / "result"), "--skip-pdb",
            "-t", str(mix["threads"]), "--device", device,
            "--scoring-matrix", mix["scoring_matrix"]]
    for m in modes:
        argv += ["-p", m]
    # The command line logs to standard output; the benchmark keeps that
    # for its result line.
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(argv)
    if rc:
        raise RuntimeError(f"predict-function exited with {rc}")


def _read_call(out: Path, modes: list, want: set):
    """({qid: (aligned, target)}, {mode: ids with a row},
    {(qid, mode): (network, scores)} of the ids in ``want``)."""
    res = out / "result"
    summary = {}
    with open(res / "alignment_summary.tsv", encoding="utf-8") as f:
        next(f)
        for line in f:
            qid, aligned, target, *_ = line.rstrip("\n").split("\t")
            summary[qid] = (aligned == "True", target)
    present, rows = {}, {}
    for m in modes:
        ids = set()
        with open(res / f"prediction_matrix_{m}.tsv", encoding="utf-8") as f:
            next(f)
            for line in f:
                qid, net, rest = line.split("\t", 2)
                ids.add(qid)
                if qid in want:
                    rows[(qid, m)] = (net, np.array(rest.split("\t"),
                                                    np.float64))
        present[m] = ids
    return summary, present, rows


def run(ctx) -> dict:
    from metagenomic_deepfri_tpu_torch import profiling

    c = ctx.config
    mix = traffic.deployment(c, ctx.traffic)
    modes = list(c["modes"])
    db = traffic.structure_db(mix)
    db_dir = traffic.structure_dir(ctx.cell.root, mix, db)
    work = Path(tempfile.mkdtemp(prefix="portbench-pipeline-"))
    try:
        trees = weights.make(c, ctx.seed, ctx.device, nets=("gcn", "cnn"))
        weights_dir = onnx_writer.write_folder(work / "weights", c, trees)
        _call(traffic.warm_queries(mix, db), work / "warm", weights_dir,
              db_dir, mix, modes, ctx.device)
        calls = traffic.query_calls(ctx.seed, mix, db)
        profiling.reset()

        tr = DeviceTrace()
        done = []
        with tr.record(ctx.trace, ctx.device):
            t0 = ctx.started()
            while True:
                queries = next(calls)
                out = work / f"call{len(done)}"
                _call(queries, out, weights_dir, db_dir, mix, modes,
                      ctx.device)
                done.append((queries, out))
                if time.perf_counter() >= t0 + ctx.seconds:
                    break
            t1 = time.perf_counter()
        stages = profiling.report()
        peak = checks.release(ctx.device)
        record = _judge(ctx, trees, db, db_dir, done, modes)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = record["attempted"]
    record.update({
        "window_s": t1 - t0, "calls": len(done), "stages": stages,
        "modes": modes, "config": c, "memory_peak_bytes": peak,
        "trace": tr if ctx.trace else None,
        "search_s_per_kq": 1000.0 * sum(
            v["seconds"] for k, v in stages.items()
            if k.startswith("search/")) / n,
        "write_s_per_kq": 1000.0 * sum(
            v["seconds"] for k, v in stages.items()
            if k.startswith("write/")) / n})
    return record


def _judge(ctx, trees, db, db_dir, done, modes) -> dict:
    """Counts every call's rows, then holds a sample from the seed to the
    reference."""
    mix = ctx.traffic
    every = [q for queries, _ in done for q in queries]
    pick = checks.sample(ctx.seed, 5, every, int(mix["sample_hits"]),
                         int(mix["sample_others"]))
    want = {q[0] for q in pick}
    summary, rows, missing = {}, {}, 0
    gcn_lengths, cnn_lengths = [], []
    for queries, out in done:
        s, present, r = _read_call(out, modes, want)
        summary.update(s)
        rows.update(r)
        for qid, seq, _ in queries:
            if not all(qid in present[m] for m in modes):
                missing += 1
            elif s.get(qid, (False, ""))[0]:
                gcn_lengths.append(len(seq))
            else:
                cnn_lengths.append(len(seq))
        shutil.rmtree(out, ignore_errors=True)

    rnds = checks.rounds(ctx.control)
    want_of = checks.expected(ctx, trees, db, db_dir, pick, rnds)
    wrong, program_gap, control_gap = 0, 0.0, 0.0
    for qid, (net, target, ref) in want_of.items():
        aligned, got_target = summary.get(qid, (None, None))
        nets = {rows[(qid, m)][0] for m in modes if (qid, m) in rows}
        if (nets != {net} or aligned is not (net == "gcn")
                or (net == "gcn" and got_target != target)):
            wrong += 1
            continue
        exact = ref[reference.exact]
        for m in modes:
            program_gap = max(program_gap,
                              checks.widest(rows[(qid, m)][1], exact[m]))
            if ctx.control:
                control_gap = max(control_gap, checks.widest(
                    ref[reference.tf32][m], exact[m]))
    limit = float(ctx.config["limits"]["score_gap"])
    return {"attempted": len(every), "failed": missing,
            "completed": len(every) - missing, "lengths": gcn_lengths,
            "cnn_lengths": cnn_lengths, "sampled": len(pick),
            "checks": {"missing": {"value": missing, "limit": 0},
                       "wrong_route": {"value": wrong, "limit": 0},
                       "score_gap": {"value": (control_gap if ctx.control
                                               else program_gap),
                                     "limit": limit}},
            "program_gap": program_gap}
