"""The stream driver runs a tiny cell on the CPU through the harness's own
code paths (the engine runs its kernels' plain twins there), and a run
with its output broken underneath comes out not correct."""

import json
import time

import numpy as np
import pytest

from conftest import tiny_config, tiny_mix, write_root
from portbench import harness

SEED = 2 ** 31 + 11


def _run(root, trace=False, control=False, cell="tiny.stream"):
    return harness.run_cell(root, cell, SEED, 0.5, trace, "cpu",
                            time.perf_counter(), control=control)


def test_tiny_cell_correct(tiny_root):
    out = _run(tiny_root)
    assert out["correct"], out["checks"]
    rec = out["record"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["completed"] == rec["attempted"] == len(rec["lengths"])
    assert set(out["metrics"]) == {"setup_s", "stream_proteins_per_s"}
    assert out["metrics"]["stream_proteins_per_s"]["value"] > 0
    assert list(out["checks"]) == ["missing", "score_gap"]
    assert out["checks"]["score_gap"]["value"] < 1e-5


def test_traced_run_reads_the_window(tiny_root):
    out = _run(tiny_root, trace=True)
    assert out["correct"], out["checks"]
    tr = out["record"]["trace"]
    assert tr.traced and tr.window_s() > 0
    # No device on the CPU: the idle share is read as all of the window,
    # the kernel and model readers find nothing.
    assert out["metrics"]["device_idle.stream"]["value"] == 100.0
    assert "model_mfu.stream" not in out["metrics"]
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(tr.window_s())
    assert gaps[0][0] != "no sample"


def test_new_cell_and_metric_as_files_alone(tmp_path):
    """A cell, a configuration, a mix and a per-layer metric with its own
    reader, all defined only in the root's files."""
    root = write_root(tmp_path, tiny_config("deepfri_gcn_mf"), tiny_mix(),
                      [("other.stream", "tiny", "tinystream")],
                      per_layer=[{"name": "batches.stream", "unit": "batches",
                                  "better": "lower", "source": "host_clock",
                                  "layer": "engine", "moves":
                                  "stream_proteins_per_s",
                                  "workloads": ["other.stream"]}])
    (root / "portbench" / "metrics").mkdir()
    (root / "portbench" / "readers").mkdir()
    (root / "portbench" / "metrics" / "batches.stream.json").write_text(
        json.dumps({"reader": "batch_count", "unit": "batches"}))
    (root / "portbench" / "readers" / "batch_count.py").write_text(
        "def read(record, spec):\n    return len(record['batches'])\n")
    out = _run(root, trace=True, cell="other.stream")
    assert out["correct"]
    assert out["metrics"]["batches.stream"]["value"] == len(
        out["record"]["batches"]) > 0


def test_control_fails(tiny_root):
    """The reference in TF32, put in the program's place, comes out not
    correct through the run's own checks; the program's gap of the same
    run is within the limit."""
    out = _run(tiny_root, control=True)
    limit = out["checks"]["score_gap"]["limit"]
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > limit
    assert out["checks"]["missing"]["value"] == 0
    assert out["record"]["program_gap"] < limit


@pytest.fixture
def broken_engine(monkeypatch):
    from metagenomic_deepfri_tpu_torch.batching import engine

    real = engine.BatchedPredictor._run_batch

    def install(fault):
        def run_batch(self, bucket, chunk, batch, modes, net="gcn_coords",
                      overflow_cb=None):
            emit = real(self, bucket, chunk, batch, modes, net, overflow_cb)
            if chunk and str(chunk[0][0]).startswith("q"):
                fault(emit)
            return emit
        monkeypatch.setattr(engine.BatchedPredictor, "_run_batch", run_batch)
    return install


def test_altered_answer_is_not_correct(tiny_root, broken_engine):
    def alter(emit):
        for scores in emit.values():
            for qid in scores:
                scores[qid] = np.asarray(scores[qid]) + np.float32(1e-3)

    broken_engine(alter)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > 1e-4
    assert out["checks"]["missing"]["value"] == 0


def test_half_batch_left_out_is_not_correct(tiny_root, broken_engine):
    def drop_half(emit):
        for scores in emit.values():
            for qid in list(scores)[len(scores) // 2:]:
                del scores[qid]

    broken_engine(drop_half)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["missing"]["value"] > 0
    assert out["record"]["failed"] == out["checks"]["missing"]["value"]
