"""The serve driver runs a tiny server cell on the CPU: the server in this
process, the client in another, over a Unix socket."""

import json
import time

import pytest

from conftest import REPO, tiny_config, write_root
from portbench import harness, traffic
from portbench.drivers import serve

SEED = 2 ** 31 + 31


def _mix(**over):
    mix = json.loads((REPO / "portbench" / "traffic" / "serve.json")
                     .read_text())
    mix.update(rate=6.0, sample_hits=4, sample_others=2,
               threads=2, grace_s=30,
               lengths={"median": 90, "sigma": 0.4, "min": 40, "max": 200})
    mix.update(over)
    return mix


@pytest.fixture
def serve_root(tmp_path):
    config = tiny_config("deepfri_set3", db_structures=40,
                         cnn={"conv_filters": 8, "conv_kernels": [8, 16],
                              "fc_dims": [16]})
    # The server's metrics have files but no cell in BENCHMARK.json: the
    # root lists them for its cell, as a later PR that adds one would.
    root = write_root(tmp_path, config, {}, [("tiny.serve", "tiny", "ts")],
                      like="", per_layer=[dict(_entry(m), workloads=["tiny.serve"])
                                 for m in ("serve.proteins_per_pass",
                                           "device_idle.serve")])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append(dict(_entry("serve_p95_ms"), bound=0.25,
                                    workloads=["tiny.serve"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "traffic" / "ts.json").write_text(
        json.dumps(_mix()))
    return root


def _entry(name: str) -> dict:
    spec = json.loads((REPO / "portbench" / "metrics" / f"{name}.json")
                      .read_text())
    return {"name": name, **{k: spec[k] for k in
                             ("unit", "better", "source", "layer", "moves")
                             if k in spec}}


def _run(root, control=False, trace=False):
    return harness.run_cell(root, "tiny.serve", SEED, 2.0, trace, "cpu",
                            time.perf_counter(), control=control)


def test_tiny_serve_correct(serve_root):
    out = _run(serve_root)
    assert out["correct"], out["checks"]
    rec = out["record"]
    assert rec["attempted"] == len(rec["latencies_ms"]) > 3
    assert rec["failed"] == 0 and rec["proteins_per_pass"] >= 1
    assert set(out["metrics"]) == {"setup_s", "serve_p95_ms"}
    assert out["metrics"]["serve_p95_ms"]["value"] > 0
    assert rec["program_gap"] == out["checks"]["score_gap"]["value"]


def test_serve_control_fails(serve_root):
    """The reference in TF32, kept and rounded as a reply keeps scores and
    put in the program's place, comes out not correct."""
    out = _run(serve_root, control=True)
    assert not out["correct"]
    c = out["checks"]
    assert c["score_gap"]["value"] > c["score_gap"]["limit"]
    assert c["missing"]["value"] == c["wrong_route"]["value"] == 0


def test_traced_serve_reports_its_layers(serve_root):
    out = _run(serve_root, trace=True)
    assert out["correct"], out["checks"]
    assert {"serve.proteins_per_pass", "device_idle.serve"} <= set(
        out["metrics"])


def test_schedule_keeps_sizes_and_arrivals():
    mix = _mix(db_structures=40)
    db = traffic.structure_db(mix)
    a = traffic.serve_schedule(1, mix, db, 20.0)
    b = traffic.serve_schedule(2, mix, db, 20.0)
    assert [(d, len(ps)) for d, _, ps in a] == [(d, len(ps))
                                                for d, _, ps in b]
    assert sorted(len(s) for _, _, ps in a for _, s, x in ps
                  if x is None) == sorted(len(s) for _, _, ps in b
                                          for _, s, x in ps if x is None)
    assert [p[1] for _, _, ps in a for p in ps] != [p[1] for _, _, ps in b
                                                   for p in ps]


def test_reply_gap():
    import numpy as np
    ref = np.array([0.5, 0.12, 0.05, 0.3])
    # GO:0000001 missing though the reference scores it 0.12
    reply = [["GO:0000000", 0.5001, ""], ["GO:0000003", 0.3, ""]]
    assert serve._gap(reply, ref) == pytest.approx(0.02)
    reply.append(["GO:0000001", 0.12, ""])
    assert serve._gap(reply, ref) == pytest.approx(1e-4)
