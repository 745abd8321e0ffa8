"""Port engine (torch, CPU) against the JAX engine, and the port's isolation.

The port's ``BatchedPredictor(device="cpu", spmm="fused")`` (on CPU tensors
the GraphConv wrappers run their plain twins) is held to the JAX
``BatchedPredictor(spmm="xla")`` on identical weights and items: per-id score
rows at float32 atol 1e-5. The ``spmm="auto"`` policy
(:mod:`..batching.spmm_table`) is checked against its table.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from metagenomic_deepfri_tpu.batching.engine import \
    BatchedPredictor as JaxPredictor
from metagenomic_deepfri_tpu.batching.engine import \
    ModelHandle as JaxHandle
from metagenomic_deepfri_tpu.models.deepfri import GCNConfig as JaxGCNConfig
from metagenomic_deepfri_tpu.models.deepfri import init_gcn as jax_init_gcn
from metagenomic_deepfri_tpu_torch.batching import engine as engine_mod
from metagenomic_deepfri_tpu_torch.batching import spmm_table
from metagenomic_deepfri_tpu_torch.batching.engine import (BatchedPredictor,
                                                           ModelHandle)
from metagenomic_deepfri_tpu_torch.models.deepfri import GCNConfig
from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
from metagenomic_deepfri_tpu_torch.precision import \
    highest_f32_precision_active
from metagenomic_deepfri_tpu_torch.synthetic import aligned_items

REPO = Path(__file__).resolve().parent.parent
PKG = "metagenomic_deepfri_tpu_torch"
BUCKETS = (32, 64)
LABELS = {"bp": 7, "cc": 3, "mf": 5}


def _handles(shared_lm: bool):
    """Three modes with distinct n_labels; numpy trees for both engines."""
    jax_h, torch_h = {}, {}
    base = None
    for i, (mode, n) in enumerate(LABELS.items()):
        cfg = JaxGCNConfig(n_labels=n, lm_hidden=8, lm_layers=1,
                           embed_dim=16, gc_dims=(8, 8), fc_dims=(16,))
        p = jax.tree_util.tree_map(
            np.asarray, jax_init_gcn(jax.random.PRNGKey(10 + i), cfg))
        if shared_lm:
            base = base or p
            p["lm"] = base["lm"]
        jax_h[mode] = JaxHandle("gcn", mode, cfg, p)
        torch_h[mode] = ModelHandle("gcn", mode,
                                    GCNConfig(**cfg.__dict__), p)
    return jax_h, torch_h


def _items():
    # lengths across both buckets, with indels (sentinels and insertions)
    return aligned_items(10, seed=7, min_len=12, max_len=64)


@pytest.mark.parametrize("shared_lm", [False, True])
def test_engine_matches_jax(shared_lm):
    jax_h, torch_h = _handles(shared_lm)
    items = _items()
    ref = JaxPredictor(gcn_models=jax_h, buckets=BUCKETS, batch_cap=4,
                       spmm="xla").predict_gcn_from_coords(items)
    engine = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                              batch_cap=4, spmm="fused")
    assert highest_f32_precision_active()
    gc.reset_launch_counts()
    out = engine.predict_gcn_from_coords(items)
    assert gc.contact_degrees.launches == 0
    assert set(out) == set(LABELS)
    for mode, n_labels in LABELS.items():
        assert set(out[mode]) == {it[0] for it in items}
        for qid, row in out[mode].items():
            assert row.shape == (n_labels,) and row.dtype == np.float32
            np.testing.assert_allclose(row, ref[mode][qid], rtol=0,
                                       atol=1e-5)


def test_stream_matches_jax_stream():
    jax_h, torch_h = _handles(shared_lm=False)
    items = _items()
    ref = {m: {} for m in LABELS}
    JaxPredictor(gcn_models=jax_h, buckets=BUCKETS, batch_cap=4,
                 spmm="xla").predict_stream(
        iter(items), net="gcn_coords",
        result_cb=lambda p: [ref[m].update(p[m]) for m in p])
    engine = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                              batch_cap=4)
    got = {m: {} for m in LABELS}
    parts, progress = [], []

    def on_result(part):
        parts.append(part)
        for m in part:
            got[m].update(part[m])

    n = engine.predict_stream(iter(items), net="gcn_coords",
                              result_cb=on_result,
                              progress_cb=progress.append)
    assert n == len(items) == sum(progress)
    assert all(set(p) == set(LABELS) and len(p["bp"]) <= 4 for p in parts)
    for mode in LABELS:
        assert set(got[mode]) == set(ref[mode])
        for qid in ref[mode]:
            np.testing.assert_allclose(got[mode][qid], ref[mode][qid],
                                       rtol=0, atol=1e-5)


def test_dense_route_matches_fused():
    _, torch_h = _handles(shared_lm=False)
    items = _items()
    fused = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                             batch_cap=4, spmm="fused"
                             ).predict_gcn_from_coords(items)
    dense = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                             batch_cap=4, spmm="dense"
                             ).predict_gcn_from_coords(items, modes=["cc"])
    assert set(dense) == {"cc"}
    for qid, row in dense["cc"].items():
        np.testing.assert_allclose(row, fused["cc"][qid], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n, cap, want", [
    (11, 4, [4, 4, 4]),    # two steady batches, then 3 stragglers padded to 4
    (11, 16, [16]),        # stragglers: smallest power of two ≥ 11
    (3, None, [8]),        # at least 8
])
def test_stream_batch_sizes(monkeypatch, n, cap, want):
    _, torch_h = _handles(shared_lm=False)
    engine = BatchedPredictor(torch_h, device="cpu", buckets=(64,),
                              batch_cap=cap)
    seen = []
    real = engine._run_batch

    def spy(bucket, chunk, batch, *args):
        seen.append(batch)
        return real(bucket, chunk, batch, *args)

    monkeypatch.setattr(engine, "_run_batch", spy)
    items = aligned_items(n, seed=1, min_len=10, max_len=60)
    assert engine.predict_stream(iter(items), modes=["mf"]) == n
    assert seen == want


def test_engine_rejects_bad_arguments():
    _, torch_h = _handles(shared_lm=False)
    with pytest.raises(TypeError):
        BatchedPredictor(torch_h)  # no device: never picked silently
    with pytest.raises(ValueError, match="spmm"):
        BatchedPredictor(torch_h, device="cpu", spmm="xla")
    engine = BatchedPredictor(torch_h, device="cpu")
    with pytest.raises(ValueError, match="gcn_coords"):
        engine.predict_stream(iter([]), net="gcn")  # the dense-cmap API
    with pytest.raises(KeyError):
        engine.predict_stream(iter([]), modes=["ec"])
    with pytest.raises(KeyError, match="CNN"):
        engine.predict_stream(iter([]), net="cnn", modes=["mf"])
    assert engine.predict_gcn_from_coords([]) == {m: {} for m in LABELS}


def test_resolve_spmm_policy():
    table = spmm_table.AUTO_SPMM_TABLE
    assert {d for _, d in table} == {"bfloat16", "float32"}
    assert sorted({b for b, _ in table}) == [128, 256, 512, 1024, 2048]
    assert set(table.values()) <= {"fused", "dense"}
    cuda = torch.device("cuda")  # constructible without a card
    for (bucket, dtype), route in table.items():
        assert spmm_table.resolve_spmm("auto", bucket, dtype, cuda) == route
        for dev in ("cpu", torch.device("cpu")):  # "auto" off the card
            assert spmm_table.resolve_spmm("auto", bucket, dtype,
                                           dev) == "dense"
        for forced in ("fused", "dense"):
            for dev in ("cpu", "cuda:1"):
                assert spmm_table.resolve_spmm(forced, bucket, dtype,
                                               dev) == forced
    for bucket, nearest in ((1, 128), (100, 128), (300, 256), (700, 512),
                            (900, 1024), (1536, 1024), (1537, 2048),
                            (5000, 2048)):
        for dtype in ("bfloat16", "float32"):
            assert spmm_table.resolve_spmm("auto", bucket, dtype, "cuda:0") \
                == table[(nearest, dtype)]
    assert spmm_table.resolve_spmm("auto", 512, "float64", cuda) == "dense"
    with pytest.raises(ValueError, match="spmm"):
        spmm_table.resolve_spmm("pallas", 512, "float32", cuda)


@pytest.mark.parametrize("spmm", ["auto", "fused", "dense"])
def test_engine_routes_by_policy(monkeypatch, spmm):
    """Single-mode batches take the route ``resolve_spmm`` gives each mode
    (on the CPU "auto" is "dense"); the default policy is "auto"."""
    _, torch_h = _handles(shared_lm=False)
    engine = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                              batch_cap=4, **({} if spmm == "auto"
                                              else {"spmm": spmm}))
    assert engine.spmm == spmm
    want = "fused" if spmm == "fused" else "dense"
    assert {engine._mode_spmm(m, b) for m in LABELS
            for b in BUCKETS} == {want}
    calls = []
    for name in ("gcn_forward", "gcn_forward_fused"):
        real = getattr(engine_mod, name)
        monkeypatch.setattr(engine_mod, name, lambda *a, _n=name, _r=real,
                            **k: calls.append(_n) or _r(*a, **k))
    out = engine.predict_gcn_from_coords(_items())
    assert set(calls) == {"gcn_forward_fused" if want == "fused"
                          else "gcn_forward"}
    assert len(calls) == len(LABELS) * 3  # 1 batch at 32, 2 at 64
    assert all(len(out[m]) == 10 for m in LABELS)


@pytest.mark.parametrize("spmm, shared_lm", [("fused", False),
                                              ("auto", True)])
def test_engine_over_two_devices_matches_one_and_jax(spmm, shared_lm):
    """``device=["cpu", "cpu"]`` (two replicas, each batch split in two)
    against the one-device port (atol 1e-6) and the JAX engine over a
    2-device mesh (the engine tests' 1e-5)."""
    from metagenomic_deepfri_tpu.parallel.mesh import make_mesh

    jax_h, torch_h = _handles(shared_lm)
    items = _items()
    ref = JaxPredictor(gcn_models=jax_h, buckets=BUCKETS, batch_cap=4,
                       spmm="xla", mesh=make_mesh(n_devices=2)
                       ).predict_gcn_from_coords(items)
    one = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                           batch_cap=4, spmm=spmm
                           ).predict_gcn_from_coords(items)
    engine = BatchedPredictor(torch_h, device=["cpu", "cpu"],
                              buckets=BUCKETS, batch_cap=4, spmm=spmm)
    assert engine.devices == [torch.device("cpu")] * 2
    two = engine.predict_gcn_from_coords(items)
    for mode in LABELS:
        assert set(two[mode]) == {it[0] for it in items}
        for qid, row in two[mode].items():
            np.testing.assert_allclose(row, one[mode][qid], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(row, ref[mode][qid], rtol=0,
                                       atol=1e-5)


def test_two_device_batches_and_slices(monkeypatch):
    """The steady batch doubles (then the cap), every padded batch is even
    and splits into two equal contiguous slices, one a replica."""
    _, torch_h = _handles(shared_lm=False)
    engine = BatchedPredictor(torch_h, device="cpu,cpu", buckets=(64,),
                              batch_cap=None)
    assert engine._steady_batch(64) == 2 * BatchedPredictor(
        torch_h, device="cpu", buckets=(64,))._steady_batch(64)
    engine = BatchedPredictor(torch_h, device="cpu,cpu", buckets=(64,),
                              batch_cap=5)
    assert engine._steady_batch(64) == 5 and engine._padded(5) == 6
    seen, slices = [], []
    real_run, real_slice = engine._run_batch, engine._slice_outputs

    def run_spy(bucket, chunk, batch, *args):
        seen.append((len(chunk), batch))
        return real_run(bucket, chunk, batch, *args)

    def slice_spy(replica, net, arrays, modes, n_real):
        slices.append((replica, arrays[0].shape[0], n_real))
        return real_slice(replica, net, arrays, modes, n_real)

    monkeypatch.setattr(engine, "_run_batch", run_spy)
    monkeypatch.setattr(engine, "_slice_outputs", slice_spy)
    items = aligned_items(11, seed=1, min_len=10, max_len=60)
    assert engine.predict_stream(iter(items), modes=["mf"]) == 11
    # 5 + 5 steady, then 1 straggler (capped at 5): each padded to 6
    assert seen == [(5, 6), (5, 6), (1, 6)]
    assert slices == [(0, 3, 3), (1, 3, 2), (0, 3, 3), (1, 3, 2),
                      (0, 3, 1), (1, 3, 0)]
    with pytest.raises(ValueError, match="split over 2"):
        real_run(64, items[:3], 3, ["mf"])


def _port_modules():
    mods = []
    for path in sorted((REPO / PKG).rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def _run_python(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_imports_no_jax():
    mods = _port_modules()
    assert {f"{PKG}.{m}" for m in (
        "batching.engine", "ops._build", "ops.contact", "data.structures",
        "models.onnx_reader", "models.onnx_import", "models.registry",
        "models.tf2onnx_fixture", "parallel.train", "parity", "cli",
        "training", "utils", "pipeline", "checkpoint", "profiling",
        "bio_utils", "ops.nw", "ops.cmap_align", "native.build",
        "align.matrices", "align.pairwise", "data.fasta", "ontology.go",
        "parallel.multihost", "search.binaries", "search.database",
        "search.engine", "search.mmseqs", "search.pdb", "search.query",
        "search.results", "serving", "contact_map", "bench_utils",
        "batching.spmm_table", "parallel.mesh", "parallel.launch",
        "parallel.shard", "parallel.graph_shard")} <= set(mods)
    proc = _run_python(f"""
        import importlib, sys
        for name in {mods!r} + ["chip_smoke"]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "metagenomic_deepfri_tpu"
                     or m.startswith("metagenomic_deepfri_tpu."))
        print("BAD", bad)
    """)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_import_builds_nothing(tmp_path):
    """Importing every module of the port runs no compiler: neither nvcc
    (the kernels) nor the C++ compiler (the native NW and k-mer libraries),
    both replaced by scripts that leave a marker."""
    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    markers = []
    for tool in ("nvcc", "g++"):
        markers.append(tmp_path / f"{tool}_called")
        (fake_bin / tool).write_text(
            f"#!/bin/sh\ntouch {markers[-1]}\nexit 1\n")
        (fake_bin / tool).chmod(0o755)
    env = dict(os.environ, PATH=f"{fake_bin}{os.pathsep}{os.environ['PATH']}",
               CUDA_HOME=str(tmp_path))
    proc = _run_python(f"""
        import importlib
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        from {PKG}.ops import _build
        from {PKG}.native import build
        print("LIB", _build.library_path().exists())
        print("NATIVE", [build.library_path(n).exists() for n in build.NAMES])
        print("LOADED", build._LOADED)
    """, env=env)
    assert proc.returncode == 0, proc.stderr
    assert not any(m.exists() for m in markers)
    assert "LIB False" in proc.stdout
    # the libraries are keyed on the compiler's path: none for the fake
    assert "NATIVE [False, False]" in proc.stdout
    assert "LOADED {}" in proc.stdout


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    from metagenomic_deepfri_tpu_torch.ops import _build

    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    (fake_bin / "nvcc").write_text("#!/bin/sh\necho 'error: no sm_90a'\n"
                                   "exit 2\n")
    (fake_bin / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="no sm_90a"):
        _build.build_library()
    assert not list((tmp_path / "build").glob("*.so"))
