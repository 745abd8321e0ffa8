"""Port engine (torch, CPU) against the JAX engine, and the port's isolation.

The port's ``BatchedPredictor(device="cpu")`` (fused path; on CPU tensors
the GraphConv wrappers run their plain twins) is held to the JAX
``BatchedPredictor(spmm="xla")`` on identical weights and items: per-id score
rows at float32 atol 1e-5.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax

from metagenomic_deepfri_tpu.batching.engine import \
    BatchedPredictor as JaxPredictor
from metagenomic_deepfri_tpu.batching.engine import \
    ModelHandle as JaxHandle
from metagenomic_deepfri_tpu.models.deepfri import GCNConfig as JaxGCNConfig
from metagenomic_deepfri_tpu.models.deepfri import init_gcn as jax_init_gcn
from metagenomic_deepfri_tpu_torch.batching import engine as engine_mod
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
                              batch_cap=4)
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
                             batch_cap=4).predict_gcn_from_coords(items)
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
        "search.results")} <= set(mods)
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
