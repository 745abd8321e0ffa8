"""The port's spans and counters (``profiling``) on the CPU.

Off, nothing is recorded or allocated; on (inside a ``torch.profiler``
session, or turned on), spans carry their parents, threads and batch
numbers on the profiler's own clock. The engine's batches, the model step
and the built-in search record the spans the benchmark's per-layer metrics
read, and the stage registry keeps its keys under concurrent threads.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metagenomic_deepfri_tpu_torch import profiling
from metagenomic_deepfri_tpu_torch.batching.buckets import assign_bucket
from metagenomic_deepfri_tpu_torch.batching.engine import (BatchedPredictor,
                                                           ModelHandle)
from metagenomic_deepfri_tpu_torch.models.deepfri import GCNConfig, init_gcn
from metagenomic_deepfri_tpu_torch.search.engine import builtin_search
from metagenomic_deepfri_tpu_torch.synthetic import aligned_items

BUCKETS = (32, 64)
LABELS = {"bp": 7, "cc": 3, "mf": 5}
AAS = list("ACDEFGHIKLMNPQRSTVWY")


@pytest.fixture(autouse=True)
def clean():
    profiling.set_recording(None)
    profiling.reset()
    yield
    profiling.set_recording(None)
    profiling.reset()


def _handles(shared: bool) -> dict:
    """Three small GCN modes; with ``shared`` one LSTM-LM and embeddings
    for all (the shared-trunk step)."""
    gen = torch.Generator().manual_seed(3)
    out, base = {}, None
    for mode, n in LABELS.items():
        cfg = GCNConfig(n_labels=n, lm_hidden=8, lm_layers=1, embed_dim=16,
                        gc_dims=(8, 8), fc_dims=(16,))
        p = init_gcn(cfg, gen, "cpu")
        if shared:
            base = base or p
            for k in ("lm", "lm_embed", "aa_embed"):
                p[k] = base[k]
        out[mode] = ModelHandle("gcn", mode, cfg, p)
    return out


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_off_record_and_allocate_nothing(monkeypatch):
    """Off (no profiler session), every call site gets the one shared no-op
    and no record or CUDA event is made, through a whole engine stream."""
    assert not profiling.recording()

    def forbidden(*args, **kwargs):
        raise AssertionError("allocated while recording is off")

    monkeypatch.setattr(profiling, "Span", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    assert profiling.span("x", batch=1, rows=2) is profiling.NO_SPAN
    assert profiling.device_span("x", "cuda") is profiling.NO_SPAN
    with profiling.span("x") as got:
        profiling.count(rows=1)
    assert got is None
    engine = BatchedPredictor(_handles(False), device="cpu", buckets=BUCKETS,
                              batch_cap=4, spmm="fused")
    items = aligned_items(6, seed=1, min_len=12, max_len=60)
    assert engine.predict_stream(iter(items), modes=["mf"]) == 6
    with profiling.stage("search/db"):
        pass
    assert profiling.spans() == []
    assert list(profiling.report()) == ["search/db"]


def test_spans_on_inside_a_profiler_session():
    """Inside a CPU profiler session: parents on one thread's stack,
    another thread's spans apart, batch numbers inherited, counts added to
    the innermost span; an ``aten::mm`` lies inside the span around it on
    the profiler's clock."""
    a = torch.randn(128, 128)
    other = {}

    def worker():
        with profiling.span("worker/outer"):
            with profiling.span("worker/inner") as inner:
                other["inner"] = inner

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("engine/batch", batch=7, rows=3) as outer:
            with profiling.span("engine/pack") as pack:
                profiling.count(rows=1)
                profiling.count(rows=1, slots=4)
            with profiling.span("probe") as probe:
                (a @ a).sum()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert not profiling.recording()
    got = _by_name(profiling.spans())
    assert got["engine/batch"] == [outer]
    assert outer.parent is None and outer.counts == {"rows": 3}
    assert pack.parent == outer.id and pack.batch == 7
    assert pack.counts == {"rows": 2, "slots": 4}
    assert probe.parent == outer.id and probe.batch == 7
    assert outer.start_ns <= pack.start_ns <= pack.end_ns <= outer.end_ns
    (w_outer,) = got["worker/outer"]
    assert other["inner"].parent == w_outer.id and w_outer.parent is None
    assert w_outer.thread != outer.thread == threading.get_native_id()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert probe.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= probe.end_ns


@pytest.mark.parametrize("forced, under_profiler, want", [
    (True, False, True), (False, True, False), (None, True, True),
    (None, False, False)])
def test_recording_switch(forced, under_profiler, want):
    """``set_recording`` forces recording on or off whatever the profiler
    does; None follows the profiler."""
    profiling.set_recording(forced)
    session = (profile(activities=[ProfilerActivity.CPU]) if under_profiler
               else profiling.NO_SPAN)
    with session:
        with profiling.device_span("model/lm", "cpu"):
            pass
    got = profiling.spans()
    assert len(got) == int(want)
    if want:
        assert got[0].device_s == pytest.approx(got[0].host_s)


@pytest.mark.parametrize("value, want", [
    ("", None), ("1", True), ("on", True), ("0", False), ("off", False)])
def test_recording_from_environment(monkeypatch, value, want):
    monkeypatch.setenv("MDEEPFRI_TPU_SPANS", value)
    assert profiling._forced_from_env() is want


def _expected_batches(engine, items, net="gcn_coords"):
    """(rows, residues, slots) of each batch ``predict_stream`` dispatches:
    buckets in arrival order fill to the steady batch, then each bucket's
    rest as ``_chunks`` splits it, in bucket order."""
    out, buffers = [], {}
    for item in items:
        bucket = assign_bucket(len(item[1]), engine.buckets)
        buf = buffers.setdefault(bucket, [])
        buf.append(item)
        steady = engine._steady_batch(bucket, net)
        if len(buf) >= steady:
            out.append((buf, engine._padded(steady), bucket))
            buffers[bucket] = []
    for bucket in sorted(buffers):
        for chunk, batch in engine._chunks(bucket, net, buffers[bucket]):
            out.append((chunk, batch, bucket))
    return [(len(c), sum(len(it[1]) for it in c), b * bk)
            for c, b, bk in out]


@pytest.mark.parametrize("route", ["fused", "shared"])
def test_predict_stream_spans(route):
    """One ``engine/batch`` a dispatch with the arithmetic of ``_chunks``,
    its ``engine/pack``, ``engine/unpack`` and ``engine/emit`` children, and
    the ``model/*`` spans of every mode on both routes."""
    modes = ["mf", "cc"]
    engine = BatchedPredictor(
        _handles(route == "shared"), device="cpu", buckets=BUCKETS,
        batch_cap=4, spmm="fused" if route == "fused" else "auto")
    assert (engine._multi_key(modes) is not None) == (route == "shared")
    items = aligned_items(11, seed=7, min_len=12, max_len=64)
    with profile(activities=[ProfilerActivity.CPU]):
        assert engine.predict_stream(iter(items), modes=modes) == 11
    got = _by_name(profiling.spans())
    batches = got["engine/batch"]
    want = _expected_batches(engine, items)
    assert [(b.counts["rows"], b.counts["residues"], b.counts["slots"])
            for b in batches] == want
    assert [b.batch for b in batches] == list(range(1, len(want) + 1))
    assert all(b.counts["input_wait_s"] >= 0 for b in batches)
    for name in ("engine/pack", "engine/unpack", "engine/emit"):
        assert [s.parent for s in got[name]] == [b.id for b in batches]
        assert [s.batch for s in got[name]] == [b.batch for b in batches]
    n = len(batches)
    per_batch = {"model/lm": 1 if route == "shared" else len(modes),
                 "model/graph": (2 + len(modes) if route == "shared"
                                 else len(modes)),
                 "model/head": len(modes)}
    for name, k in per_batch.items():
        assert len(got[name]) == n * k, name
        assert all(s.device_s is not None and s.device_s >= 0
                   for s in got[name])
        assert sorted({s.batch for s in got[name]}) == list(range(1, n + 1))
        owner = {b.batch: b for b in batches}
        for s in got[name]:
            b = owner[s.batch]
            assert b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns


def test_input_wait_behind_a_slow_iterator():
    """The seconds ``predict_stream`` blocks in its iterator go to the batch
    each item joins, the wait for the iterator's end to the straggler
    batch; no span is made per item."""
    engine = BatchedPredictor(_handles(False), device="cpu", buckets=(64,),
                              batch_cap=4, spmm="fused")
    items = aligned_items(5, seed=2, min_len=12, max_len=60)
    pause = 0.03

    def slow():
        for item in items:
            time.sleep(pause)
            yield item
        time.sleep(2 * pause)

    with profile(activities=[ProfilerActivity.CPU]):
        engine.predict_stream(slow(), modes=["mf"])
    got = _by_name(profiling.spans())
    first, last = got["engine/batch"]
    assert (first.counts["rows"], last.counts["rows"]) == (4, 1)
    assert 4 * pause <= first.counts["input_wait_s"] < 4 * pause + 0.5
    assert 3 * pause <= last.counts["input_wait_s"] < 3 * pause + 0.5
    assert set(got) == {"engine/batch", "engine/pack", "engine/unpack",
                        "engine/emit", "model/lm", "model/graph",
                        "model/head"}


def test_input_wait_needs_recording_at_entry():
    """A call that started with recording off counts no input wait, though
    its batches are recorded once recording is on."""
    engine = BatchedPredictor(_handles(False), device="cpu", buckets=(64,),
                              batch_cap=4, spmm="fused")
    items = aligned_items(3, seed=2, min_len=12, max_len=60)

    def turning_on():
        yield from items
        profiling.set_recording(True)

    engine.predict_stream(turning_on(), modes=["mf"])
    (batch,) = _by_name(profiling.spans())["engine/batch"]
    assert batch.counts == {"rows": 3, "residues": sum(
        len(it[1]) for it in items), "slots": 4 * 64}


def test_builtin_search_spans():
    """One ``kmer/prefilter`` a search call, one ``nw/rescore`` and one
    ``nw/traceback`` (with its ``alignments``) a query with candidates, all
    under the stage's span; ``report()`` gains no key."""
    rng = np.random.default_rng(5)
    targets = {f"t{i}": "".join(rng.choice(AAS, size=int(n)))
               for i, n in enumerate(rng.integers(80, 160, size=12))}
    queries = {f"q{i}": targets[f"t{i}"][:70] for i in range(4)}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.stage("search/db", items=len(queries), log=False):
            rows = builtin_search(queries, targets, max_eval=1.0, threads=2,
                                  top_hits=3)
    assert len(rows) >= len(queries)
    got = _by_name(profiling.spans())
    (stage,) = got["search/db"]
    assert len(got["kmer/prefilter"]) == 1
    assert len(got["nw/rescore"]) == len(got["nw/traceback"]) == 4
    for name in ("kmer/prefilter", "nw/rescore", "nw/traceback"):
        assert all(s.parent == stage.id for s in got[name])
    assert all(1 <= s.counts["alignments"] <= 3
               for s in got["nw/traceback"])
    total = sum(s.host_s for n in ("kmer/prefilter", "nw/rescore",
                                   "nw/traceback") for s in got[n])
    assert total <= stage.host_s
    assert list(profiling.report()) == ["search/db"]


def test_report_keys_under_concurrent_threads():
    """Stages from many threads at once lose no call or item, and spans
    recorded meanwhile add no key to ``report()``."""
    n_threads, n_calls = 12, 300
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait(timeout=30)
        for _ in range(n_calls):
            with profiling.stage(f"align/db{i % 3}", items=2, log=False):
                with profiling.span("nw/rescore"):
                    pass
            profiling.add_items("inference/gcn", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiling.set_recording(True)
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rep = profiling.report()
    assert sorted(rep) == ["align/db0", "align/db1", "align/db2",
                           "inference/gcn"]
    for i in range(3):
        assert rep[f"align/db{i}"]["calls"] == n_threads // 3 * n_calls
        assert rep[f"align/db{i}"]["items"] == 2 * n_threads // 3 * n_calls
    assert rep["inference/gcn"]["items"] == n_threads * n_calls
    got = _by_name(profiling.spans())
    assert len(got["nw/rescore"]) == n_threads * n_calls
    parents = {s.id: s for n in ("align/db0", "align/db1", "align/db2")
               for s in got[n]}
    assert all(parents[s.parent].thread == s.thread
               for s in got["nw/rescore"])


def test_log_report_shows_spans(caplog):
    profiling.set_recording(True)
    with profiling.stage("search/db", log=False):
        with profiling.span("nw/traceback", alignments=3):
            pass
    with caplog.at_level("INFO", logger=profiling.__name__):
        profiling.log_report()
    lines = [r.getMessage() for r in caplog.records]
    assert any("total search/db" in line for line in lines)
    assert any("span  nw/traceback" in line and "alignments=3" in line
               for line in lines)
    assert not any("span  search/db" in line for line in lines)
