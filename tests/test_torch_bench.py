"""The port's benchmark harness (``bench_utils``) against the JAX package's.

Exact where the two compute the same thing (the random items, byte for
byte; the analytic FLOP counts; the items, batches, edges and FLOPs of the
GCN benchmark); the measured rates are only checked to be positive, since
a CPU run measures no device. The writers run at tiny sizes (the engine's
batch rule patched in the port's namespace) from the repository's root and
must leave its ``BENCH_*.json`` files, which the JAX package owns, as they
are.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from metagenomic_deepfri_tpu import bench_utils as jax_bench
from metagenomic_deepfri_tpu.models.deepfri import CNNConfig as JaxCNNConfig
from metagenomic_deepfri_tpu.models.deepfri import GCNConfig as JaxGCNConfig
from metagenomic_deepfri_tpu_torch import bench_utils
from metagenomic_deepfri_tpu_torch.models.deepfri import CNNConfig, GCNConfig

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def repo_root_untouched(monkeypatch):
    """Run from the repository's root; afterwards the root holds no new
    JSON file and every ``BENCH_*.json`` the same bytes."""
    monkeypatch.chdir(REPO)
    before = {p.name: p.read_bytes() for p in REPO.glob("BENCH_*.json")}
    names = {p.name for p in REPO.glob("*.json")}
    yield
    assert {p.name for p in REPO.glob("*.json")} == names
    assert {p.name: p.read_bytes()
            for p in REPO.glob("BENCH_*.json")} == before


@pytest.fixture
def tiny_batches(monkeypatch):
    monkeypatch.setattr(bench_utils, "gcn_batch_size", lambda bucket: 2)
    monkeypatch.setattr(bench_utils, "cnn_batch_size", lambda bucket: 4)


@pytest.mark.parametrize("form", ["dense", "coords"])
def test_make_random_items_matches_jax(form):
    ours = bench_utils.make_random_items(7, 20, 90, seed=3, form=form)
    theirs = jax_bench.make_random_items(7, 20, 90, seed=3, form=form)
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


_SMALL_GCN = dict(lm_hidden=24, lm_layers=3, lm_bidirectional=True,
                  embed_dim=40, gc_dims=(16, 8), fc_dims=(32, 12))
_SMALL_CNN = dict(conv_filters=24, conv_kernels=(3, 5, 9), fc_dims=(20,))


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("L", [32, 512])
def test_analytic_flops_match_jax(small, L):
    g = _SMALL_GCN if small else {}
    c = _SMALL_CNN if small else {}
    ours_g, theirs_g = GCNConfig(n_labels=77, **g), JaxGCNConfig(
        n_labels=77, **g)
    ours_c, theirs_c = CNNConfig(n_labels=77, **c), JaxCNNConfig(
        n_labels=77, **c)
    assert bench_utils.analytic_gcn_matmul_flops(ours_g, L) == \
        jax_bench.analytic_gcn_matmul_flops(theirs_g, L)
    assert bench_utils.analytic_gcn_trunk_flops(ours_g, L) == \
        jax_bench.analytic_gcn_trunk_flops(theirs_g, L)
    assert bench_utils.analytic_cnn_matmul_flops(ours_c, L) == \
        jax_bench.analytic_cnn_matmul_flops(theirs_c, L)


def test_gcn_benchmark_matches_jax(repo_root_untouched):
    kw = dict(bucket=32, batches=2, n_labels=8, batch_cap=2)
    theirs = json.loads(jax_bench.run_gcn_benchmark(
        **kw, with_device_loop=False, device_only_cache=None))
    ours = json.loads(bench_utils.run_gcn_benchmark(**kw, device="cpu"))
    for key in ("metric", "unit"):
        assert ours[key] == theirs[key]
    assert set(theirs["detail"]) <= set(ours["detail"])
    for key in ("n_proteins", "batch", "edges_per_protein",
                "flops_per_protein", "bucket", "n_labels", "compute_dtype",
                "path", "spmm"):
        assert ours["detail"][key] == theirs["detail"][key], key
    assert ours["value"] > 0 and ours["detail"]["device_only_pps"] > 0
    assert ours["detail"]["mfu"] is None
    assert ours["detail"]["device_only_mfu"] is None
    assert ours["detail"]["device"] == "cpu"
    assert ours["detail"]["spmm_route"] == "dense"  # "auto" off the card
    assert 0.0 <= ours["detail"]["link_share"] <= 1.0
    assert len(ours["detail"]["elapsed_passes_s"]) == 4


def test_gcn_benchmark_dense_path_matches_jax(repo_root_untouched):
    """``path="dense"`` times ``predict_gcn`` on each protein's dense
    contact map: the JAX line's keys and workload."""
    kw = dict(bucket=32, batches=2, n_labels=8, batch_cap=2, path="dense")
    theirs = json.loads(jax_bench.run_gcn_benchmark(
        **kw, with_device_loop=False, device_only_cache=None))
    ours = json.loads(bench_utils.run_gcn_benchmark(**kw, device="cpu"))
    assert set(theirs["detail"]) <= set(ours["detail"])
    for key in ("n_proteins", "batch", "edges_per_protein", "path",
                "flops_per_protein", "bucket", "n_labels", "spmm"):
        assert ours["detail"][key] == theirs["detail"][key], key
    assert ours["detail"]["path"] == "dense"
    assert ours["detail"]["spmm_route"] == "dense"
    assert ours["value"] > 0 and ours["detail"]["device_only_pps"] > 0
    with pytest.raises(ValueError, match="path"):
        bench_utils.run_gcn_benchmark(bucket=32, path="flat", device="cpu")


def test_peak_table_and_no_fallback(monkeypatch):
    assert bench_utils.device_peak_bf16_flops("cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_utils.device_only_gcn_pps(bucket=32, reps=1, batch_cap=1,
                                            device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_utils.run_gcn_benchmark(bucket=32, batches=1,
                                          device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", None),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None, name=name: name)
        assert bench_utils.device_peak_bf16_flops("cuda") == peak
        assert bench_utils.device_name("cuda:0") == name


def test_cnn_benchmark(tiny_batches, repo_root_untouched):
    line = json.loads(bench_utils.run_cnn_benchmark(
        bucket=32, batches=2, n_labels=8, device="cpu"))
    assert line["metric"] == "cnn_proteins_per_sec_per_chip"
    assert line["value"] > 0 and line["detail"]["n_proteins"] == 8
    assert line["detail"]["flops_per_protein"] == round(
        jax_bench.analytic_cnn_matmul_flops(JaxCNNConfig(n_labels=8), 32))
    assert line["detail"]["mfu"] is None


def test_multimode_benchmark(tiny_batches, repo_root_untouched, tmp_path):
    out = tmp_path / "multimode.json"
    line = json.loads(bench_utils.run_multimode_benchmark(
        bucket=32, batches=2, device="cpu", out_path=out))
    assert line["metric"] == "gcn_3mode_annotations_per_sec_per_chip"
    d = line["detail"]
    assert d["batch"] == 2 and d["n_proteins"] == 4
    assert min(d["per_mode_dispatch_aps"], d["shared_trunk_aps"],
               d["device_only_shared_aps"],
               d["device_only_per_mode_aps"]) > 0
    assert line["value"] == d["shared_trunk_aps"]
    assert "speedup_with_topk" not in d
    report = json.loads(out.read_text())
    assert report["modes"] == ["bp", "cc", "mf"]
    assert "shared_topk256" not in report
    assert report["mfu_device_only_shared"] is None
    cfgs = {m: JaxGCNConfig(n_labels=n)
            for m, n in (("bp", 3992), ("cc", 320), ("mf", 489))}
    want = (sum(jax_bench.analytic_gcn_matmul_flops(c, 32)
                for c in cfgs.values())
            - 2 * jax_bench.analytic_gcn_trunk_flops(cfgs["mf"], 32))
    assert report["flops_per_protein_all_modes"] == round(want)


def test_roofline_benchmark(tiny_batches, repo_root_untouched):
    line = json.loads(bench_utils.run_roofline_benchmark(
        bucket=32, n_labels=8, reps=2, device="cpu"))
    assert line["metric"] == "gcn_roofline_lm_share"
    stages = line["detail"]["stages"]
    assert list(stages) == ["adjacency", "lm_trunk", "graphconv", "fc_head"]
    assert abs(sum(stages.values()) - 1.0) < 0.01
    assert line["detail"]["fused_us_per_protein"] > 0
    assert line["detail"]["fused_spmm_route"] == "dense"
    assert line["detail"]["out_path"] is None


def test_spmm_matrix(tiny_batches, repo_root_untouched, tmp_path):
    out = tmp_path / "matrix.json"
    line = json.loads(bench_utils.run_spmm_matrix(
        buckets=(32,), reps=1, device="cpu", out_path=out))
    assert line["value"] == 4 and line["detail"]["errors"] == 0
    report = json.loads(out.read_text())
    assert {(c["dtype"], c["spmm"], c["spmm_route"])
            for c in report["cells"]} == {
        (d, s, s) for d in ("bfloat16", "float32")
        for s in ("dense", "fused")}
    assert set(report["winners"]) == set(report["auto_table"]) == {
        "32,bfloat16", "32,float32"}
    assert line["detail"]["auto_table"] == report["auto_table"]


def test_realvocab_benchmark(tiny_batches, repo_root_untouched):
    line = json.loads(bench_utils.run_realvocab_benchmark(
        device="cpu", bucket=32, batches=1))
    assert set(line["detail"]["points"]) == {"gcn/mf", "gcn/bp", "cnn/mf",
                                             "cnn/bp"}
    assert line["value"] == line["detail"]["points"]["gcn/bp"] > 0


@pytest.mark.parametrize("margin, spread, want", [
    (50.0, 10.0, "dense"),     # dense ahead by more than the spread
    (5.0, 10.0, "fused"),      # ahead, but within the spread
    (-50.0, 10.0, "fused"),    # behind
])
def test_auto_table_rule(margin, spread, want):
    def cell(spmm, pps, width):
        return {"bucket": 512, "dtype": "bfloat16", "spmm": spmm,
                "device_only_pps": pps,
                "passes_pps": [pps - width, pps - width / 2, pps]}

    cells = [cell("fused", 100.0, spread / 2),
             cell("dense", 100.0 + margin, spread),
             {"bucket": 1024, "dtype": "bfloat16", "spmm": "dense",
              "error": "OutOfMemoryError"}]
    assert bench_utils.auto_table(cells) == {"512,bfloat16": want}


def test_mesh_benchmark(repo_root_untouched, tmp_path):
    """``run_mesh_benchmark`` over two CPU devices at a tiny size: engine
    rows for 1 and 2 devices at the same work, ring rows for 1 and 2 ranks
    (gloo), written only to ``out_path``; no device rate is claimed on the
    CPU, only positive finite numbers named with the device."""
    cfg = GCNConfig(n_labels=9, lm_hidden=8, lm_layers=1, embed_dim=16,
                    gc_dims=(8, 8), fc_dims=(16,), compute_dtype="float32")
    out = tmp_path / "mesh.json"
    line = json.loads(bench_utils.run_mesh_benchmark(
        "cpu,cpu", out, config=cfg, bucket=32, n_proteins=12, ring_L=32,
        ring_D=8, passes=1, ring_reps=1))
    report = json.loads(out.read_text())
    dp = report["data_parallel_fixed_work"]["rows"]
    ring = report["graph_ring_fixed_L"]["rows"]
    assert [r["n_devices"] for r in dp] == [r["n_devices"] for r in ring] \
        == [1, 2]
    assert report["data_parallel_fixed_work"]["n_proteins"] == 12
    assert all(r["proteins_per_s"] > 0 for r in dp)
    assert all(np.isfinite(r[k]) and r[k] >= 0 for r in ring
               for k in ("aggregate_ms", "exchange_ms", "blocks_ms"))
    assert all(r["aggregate_ms"] > 0 for r in ring)
    assert report["peer_access"] is None  # CPU devices
    assert dp[0]["speedup"] == ring[0]["speedup"] == 1.0
    assert line["detail"]["device"] == "cpu" and line["detail"]["n_devices"] \
        == 2
    assert bench_utils._device_counts(6) == [1, 2, 4, 6]
    assert bench_utils._device_counts(6, L=64) == [1, 2, 4]
