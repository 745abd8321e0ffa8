"""The pipeline driver runs a tiny predict-function cell on the CPU, and a
run whose outputs are broken underneath comes out not correct."""

import json
import time

import numpy as np
import pytest

from conftest import REPO, tiny_config, write_root
from portbench import harness, reference, traffic

SEED = 2 ** 31 + 23


def _mix(**over):
    mix = json.loads((REPO / "portbench" / "traffic" / "pipeline.json")
                     .read_text())
    mix.update(sample_hits=4,
               sample_others=2, threads=2,
               lengths={"median": 90, "sigma": 0.4, "min": 40, "max": 200})
    mix.update(over)
    return mix


@pytest.fixture
def pipe_root(tmp_path):
    config = tiny_config("deepfri_set3", db_structures=40, queries_per_call=9,
                         cnn={"conv_filters": 8, "conv_kernels": [8, 16],
                              "fc_dims": [16]})
    root = write_root(tmp_path, config, {}, [("tiny.pipe", "tiny", "tp")],
                      like="set3.pipeline")
    (root / "portbench" / "traffic" / "tp.json").write_text(
        json.dumps(_mix()))
    return root


def _run(root, control=False, trace=False):
    return harness.run_cell(root, "tiny.pipe", SEED, 0.1, trace, "cpu",
                            time.perf_counter(), control=control)


def test_tiny_pipeline_correct(pipe_root):
    out = _run(pipe_root)
    assert out["correct"], out["checks"]
    rec = out["record"]
    assert rec["calls"] >= 1 and rec["attempted"] == 9 * rec["calls"]
    assert rec["failed"] == 0 and rec["lengths"] and rec["cnn_lengths"]
    assert set(out["metrics"]) == {"setup_s", "pipeline_queries_per_s"}
    assert out["checks"]["score_gap"]["value"] < 1e-5
    assert rec["program_gap"] == out["checks"]["score_gap"]["value"]
    assert rec["search_s_per_kq"] > 0 and rec["write_s_per_kq"] > 0
    assert not list((pipe_root / "portbench" / "cache" / "db").glob(
        "*/structures.part"))


def test_pipeline_control_fails(pipe_root):
    """The reference in TF32, put in the program's place, comes out not
    correct through the run's own checks."""
    out = _run(pipe_root, control=True)
    assert not out["correct"]
    c = out["checks"]
    assert c["score_gap"]["value"] > c["score_gap"]["limit"]
    assert c["missing"]["value"] == c["wrong_route"]["value"] == 0
    assert out["record"]["program_gap"] < 1e-5


def test_traced_pipeline_reports_its_layers(pipe_root):
    out = _run(pipe_root, trace=True)
    assert out["correct"], out["checks"]
    assert {"pipeline.search_s_per_kq", "pipeline.write_s_per_kq",
            "device_idle.pipeline"} <= set(out["metrics"])


def test_wrong_hit_is_not_correct(pipe_root, monkeypatch):
    """A query aligned to another structure than its source."""
    real = traffic.read_pdb

    def other(text):
        seq, xyz = real(text)
        return seq, xyz[::-1].copy()
    monkeypatch.setattr(traffic, "read_pdb", other)
    out = _run(pipe_root)
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > 1e-3


def test_altered_score_is_not_correct(pipe_root, monkeypatch):
    from metagenomic_deepfri_tpu_torch.batching import engine

    real = engine.BatchedPredictor.predict_cnn

    def shifted(self, *a, **k):
        out = real(self, *a, **k)
        for scores in out.values():
            for qid in scores:
                scores[qid] = scores[qid] + np.float32(1e-3)
        return out
    monkeypatch.setattr(engine.BatchedPredictor, "predict_cnn", shifted)
    out = _run(pipe_root)
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > 5e-4


def test_global_alignment_matches_the_port():
    from metagenomic_deepfri_tpu_torch.align.matrices import ScoringMatrix
    from metagenomic_deepfri_tpu_torch.ops.nw import nw_align

    rng = np.random.default_rng(7)
    sm = ScoringMatrix.from_name("BLOSUM62")
    for k in range(60):
        t = traffic.sequence(rng, int(rng.integers(20, 200)))
        q = (traffic.hit_query(rng, t, 0.05) if k % 2
             else traffic.sequence(rng, int(rng.integers(20, 200))))
        assert reference.global_alignment(q, t) == nw_align(q, t, sm)[1]
