"""Driver ``serve``: the resident annotation server under open-loop load.

Set-up makes the configuration's GCNs and CNNs on the device from the seed
and writes them as a weights folder under ``TMPDIR``, writes the structure
database (the configuration's scale, the mix's lengths and seed) once per
checkout under ``portbench/cache/``, builds the
port's ``AnnotationServer`` on both in this process (models on the device,
the database indexed, the engine's own warmup), serves its JSONL protocol
on a Unix socket under ``TMPDIR``, and sends one warm request with a hit
and a query without one in every length bucket.

The window: a client in a separate process (``serve_client.py``, standard
library only) sends the mix's schedule of requests, each at its due time on
a connection of its own, however many are still waiting, and waits for the
replies up to ``grace_s`` past the last due time. Each request's latency
runs from its due time to its full reply; a request that fails or gets no
reply counts as infinitely late.

Afterwards a sample of the proteins sent, drawn from the seed, with the
longest hit among them, is checked against the plain reference: the route
and hit of each, and every score the reply carries (those ≥ 0.1, rounded
to 4 places), and that no term the reference scores ≥ 0.1 is missing.
In a control run the reference's scores in TF32, kept and rounded as a
reply keeps them, take the program's place in the comparison of scores.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from portbench import checks, onnx_writer, reference, traffic, weights
from portbench.trace import DeviceTrace

HERE = Path(__file__).resolve().parent.parent
THRESHOLD = 0.1   # the replies keep scores at or above it


class _Passes:
    """Counts the server's annotation passes and the proteins in them."""

    def __init__(self, annotate):
        self.annotate, self.passes, self.proteins = annotate, 0, 0

    def __call__(self, proteins):
        self.passes += 1
        self.proteins += len(proteins)
        return self.annotate(proteins)


def _socket_path(work: Path) -> str:
    path = str(work / "s")
    if len(path.encode()) > 100:
        raise RuntimeError(f"socket path too long for AF_UNIX: {path}")
    return path


def run(ctx) -> dict:
    from metagenomic_deepfri_tpu_torch.serving import (AnnotationServer,
                                                       annotate_over_socket)

    c = ctx.config
    mix = traffic.deployment(c, ctx.traffic)
    modes = list(c["modes"])
    db = traffic.structure_db(mix)
    db_dir = traffic.structure_dir(ctx.cell.root, mix, db)
    work = Path(tempfile.mkdtemp(prefix="pb"))
    server = thread = None
    try:
        trees = weights.make(c, ctx.seed, ctx.device, nets=("gcn", "cnn"))
        weights_dir = onnx_writer.write_folder(work / "weights", c, trees)
        server = AnnotationServer(
            weights_dir, databases=[db_dir], processing_modes=modes,
            threads=int(mix["threads"]), device=ctx.device,
            scoring_matrix=mix["scoring_matrix"],
            gap_open=int(mix["gap_open"]), gap_extend=int(mix["gap_extend"]))
        sock = _socket_path(work)
        ready = threading.Event()
        thread = threading.Thread(target=server.serve_unix,
                                  args=(sock, ready), daemon=True)
        thread.start()
        ready.wait()
        warm = annotate_over_socket(
            sock, {q: s for q, s, _ in traffic.warm_queries(mix, db)})
        if "error" in warm:
            raise RuntimeError(f"warm request failed: {warm['error']}")

        schedule = traffic.serve_schedule(ctx.seed, mix, db, ctx.seconds)
        every = [p for _, _, ps in schedule for p in ps]
        pick = checks.sample(ctx.seed, 7, every, int(mix["sample_hits"]),
                             int(mix["sample_others"]))
        (work / "schedule.json").write_text(json.dumps({
            "requests": [[d, rid, {p: s for p, s, _ in ps}]
                         for d, rid, ps in schedule],
            "keep": [p[0] for p in pick]}))
        passes = _Passes(server.annotate)
        server.annotate = passes
        tr = DeviceTrace()
        batcher = next(t.ident for t in threading.enumerate()
                       if t.name == "annotation-batcher")
        client = None
        try:
            # The trace starts first: the client's due times count from a
            # start it is given, and starting the profiler takes seconds.
            with tr.record(ctx.trace, ctx.device, batcher):
                start = time.monotonic() + 1.0
                client = subprocess.Popen(
                    [sys.executable, str(HERE / "serve_client.py"), sock,
                     str(work / "schedule.json"), repr(start),
                     str(mix["grace_s"]), str(work / "replies.json")])
                time.sleep(max(start - time.monotonic(), 0.0))
                t0 = ctx.started()
                client.wait(timeout=ctx.seconds + float(mix["grace_s"]) + 60)
                t1 = time.perf_counter()
        finally:
            if client is not None and client.poll() is None:
                client.kill()
                client.wait()
        if client.returncode:
            raise RuntimeError(f"client exited with {client.returncode}")
        replies = json.loads((work / "replies.json").read_text())
        server.shutdown()
        thread.join(10)
        n_passes, n_proteins = passes.passes, passes.proteins
        server = None
        peak = checks.release(ctx.device)
        record = _judge(ctx, trees, db, db_dir, schedule, replies, pick,
                        modes)
    finally:
        if server is not None:
            server.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    record.update({"window_s": t1 - t0, "modes": modes, "config": c,
                   "memory_peak_bytes": peak,
                   "trace": tr if ctx.trace else None,
                   "proteins_per_pass": (n_proteins / n_passes
                                         if n_passes else None)})
    return record


def _gap(reply: list, ref: np.ndarray) -> float:
    """The widest gap between a reply's kept scores and the reference's: a
    kept term's |score − reference|, and for a term the reply lacks whose
    reference score is ≥ 0.1, at least its excess over 0.1."""
    got = {int(term[3:]): score for term, score, _ in reply}
    gap = max((abs(s - ref[i]) for i, s in got.items()), default=0.0)
    lack = [ref[i] - THRESHOLD for i in np.nonzero(ref >= THRESHOLD)[0]
            if int(i) not in got]
    return float(max([gap, *lack]))


def _reply(scores: np.ndarray) -> list:
    """Scores as a reply carries them: the terms at or above the
    threshold, rounded to 4 places."""
    return [(f"GO:{i}", round(float(scores[i]), 4), None)
            for i in np.nonzero(scores >= THRESHOLD)[0]]


def _judge(ctx, trees, db, db_dir, schedule, replies, pick, modes) -> dict:
    lat, late, failed = [], [], 0
    kept = {}
    for due, rid, _ in schedule:
        r = replies.get(rid)
        if r is None or not r["ok"] or r["done"] is None:
            failed += 1
            lat.append(float("inf"))
            continue
        lat.append(1000.0 * (r["done"] - due))
        late.append(1000.0 * (r["sent"] - due))
        kept.update(r.get("kept", {}))
    rnds = checks.rounds(ctx.control)
    want = checks.expected(ctx, trees, db, db_dir, pick, rnds)
    wrong, program_gap, control_gap = 0, 0.0, 0.0
    for pid, (net, target, ref) in want.items():
        entry = kept.get(pid)
        if entry is None:
            continue          # its request failed: counted above
        if entry["network"] != net or entry["aligned"] is not (
                net == "gcn") or (net == "gcn" and
                                  entry.get("target") != target):
            wrong += 1
            continue
        exact = ref[reference.exact]
        for m in modes:
            program_gap = max(program_gap,
                              _gap(entry["scores"].get(m, []), exact[m]))
            if ctx.control:
                control_gap = max(control_gap, _gap(
                    _reply(ref[reference.tf32][m]), exact[m]))
    limit = float(ctx.traffic.get("score_gap",
                                  ctx.config["limits"]["score_gap"]))
    out = {"attempted": len(schedule), "failed": failed,
           "completed": len(schedule) - failed, "latencies_ms": lat,
           "sampled": len(pick),
           "notes": {"client_late_max_ms": max(late, default=0.0)},
           "checks": {"missing": {"value": failed, "limit": 0},
                      "wrong_route": {"value": wrong, "limit": 0},
                      "score_gap": {"value": (control_gap if ctx.control
                                              else program_gap),
                                    "limit": limit}},
           "program_gap": program_gap}
    return out
