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
import threading
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
    (the kernels) nor the C++ compiler (the native NW, k-mer and TSV
    formatter libraries), both replaced by scripts that leave a marker."""
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
    assert "NATIVE [False, False, False]" in proc.stdout
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


# ---- predict_gcn: the precomputed-contact-map API ---------------------------

def _cmap_items():
    """(id, seq, cmap) items over both buckets, the cmaps given as bool,
    uint8 and 0/1 float32 in turn, and one cmap shorter than its sequence
    (it fills its own L × L corner)."""
    from metagenomic_deepfri_tpu_torch.bench_utils import make_random_items

    items = []
    for i, (qid, seq, cmap) in enumerate(
            make_random_items(10, 12, 64, seed=5, form="dense")):
        cmap = np.asarray(cmap) > 0
        if i == 3:
            cmap = cmap[:-3, :-3]
        items.append((qid, seq, cmap.astype((bool, np.uint8,
                                             np.float32)[i % 3])))
    return items


def _assert_rows(got, want, atol):
    assert set(got) == set(want)
    for mode in want:
        assert set(got[mode]) == set(want[mode])
        for qid, row in want[mode].items():
            assert got[mode][qid].dtype == np.float32
            np.testing.assert_allclose(got[mode][qid], row, rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("shared_lm", [False, True])
def test_predict_gcn_matches_jax(shared_lm):
    jax_h, torch_h = _handles(shared_lm)
    items = _cmap_items()
    ref = JaxPredictor(gcn_models=jax_h, buckets=BUCKETS, batch_cap=4,
                       spmm="xla").predict_gcn(items)
    engine = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                              batch_cap=4)
    assert (engine._multi_key(list(LABELS)) is not None) == shared_lm
    parts, progress = [], []
    out = engine.predict_gcn(items, result_cb=parts.append,
                             progress_cb=progress.append)
    _assert_rows(out, ref, 1e-5)
    assert sum(progress) == len(items) and len(parts) == len(progress)
    assert {q for p in parts for q in p["bp"]} == {it[0] for it in items}
    got = engine.predict_gcn(items, modes=["cc"])
    assert set(got) == {"cc"}
    _assert_rows(got, {"cc": ref["cc"]}, 1e-5)


def test_predict_gcn_empty_and_bad_arguments():
    jax_h, torch_h = _handles(shared_lm=False)
    engine = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS)
    want = JaxPredictor(gcn_models=jax_h, buckets=BUCKETS).predict_gcn([])
    assert engine.predict_gcn([]) == want == {m: {} for m in LABELS}
    with pytest.raises(KeyError):
        engine.predict_gcn([], modes=["ec"])


@pytest.mark.parametrize("spmm", ["fused", "dense"])
def test_predict_gcn_equals_coords_path(spmm):
    """Given ``aligned_contacts_from_coords``' own adjacency as the cmap,
    ``predict_gcn`` gives the scores of ``predict_gcn_from_coords``."""
    from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
        aligned_contacts_from_coords

    _, torch_h = _handles(shared_lm=False)
    engine = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                              batch_cap=4, spmm=spmm)
    items = _items()
    dense = []
    for qid, seq, proj, ins in items:
        adj = aligned_contacts_from_coords(
            torch.from_numpy(proj)[None], torch.from_numpy(ins)[None],
            torch.tensor([len(seq)], dtype=torch.int32),
            engine.contact_threshold, engine.generated_contacts)[0]
        dense.append((qid, seq, adj.numpy()))
    _assert_rows(engine.predict_gcn(dense),
                 engine.predict_gcn_from_coords(items), 1e-5)


@pytest.mark.parametrize("shared_lm", [False, True])
def test_predict_gcn_two_devices_match_one(monkeypatch, shared_lm):
    _, torch_h = _handles(shared_lm)
    items = _cmap_items()
    one = BatchedPredictor(torch_h, device="cpu", buckets=BUCKETS,
                           batch_cap=4).predict_gcn(items)
    engine = BatchedPredictor(torch_h, device=["cpu", "cpu"],
                              buckets=BUCKETS, batch_cap=4)
    slices = []
    real_slice = engine._slice_outputs

    def slice_spy(replica, net, arrays, modes, n_real):
        slices.append((replica, net, tuple(arrays[2].shape), n_real))
        return real_slice(replica, net, arrays, modes, n_real)

    monkeypatch.setattr(engine, "_slice_outputs", slice_spy)
    _assert_rows(engine.predict_gcn(items), one, 1e-6)
    assert {s[1] for s in slices} == {"gcn"}
    # each replica gets its half of the uint8 adjacency
    assert all(shape[0] == 2 and shape[1] == shape[2] in BUCKETS
               for _, _, shape, _ in slices)
    assert [s[0] for s in slices] == [0, 1] * (len(slices) // 2)


# ---- warmup -----------------------------------------------------------------

def _engine_with_cnn(device="cpu", batch_cap=4, dtype="float32",
                     shared_lm=False):
    from metagenomic_deepfri_tpu_torch.models.deepfri import (CNNConfig,
                                                              init_cnn)

    _, torch_h = _handles(shared_lm=shared_lm)
    for h in torch_h.values():
        h.config = GCNConfig(**{**h.config.__dict__, "compute_dtype": dtype})
    cnn = {}
    for i, (mode, n) in enumerate(LABELS.items()):
        cfg = CNNConfig(n_labels=n, conv_filters=8, conv_kernels=(3,),
                        fc_dims=(16,), compute_dtype=dtype)
        cnn[mode] = ModelHandle("cnn", mode, cfg, init_cnn(
            cfg, torch.Generator().manual_seed(30 + i), "cpu"))
    return BatchedPredictor(torch_h, cnn, device=device, buckets=BUCKETS,
                            batch_cap=batch_cap)


def _on_warm_thread() -> bool:
    return threading.current_thread().name.startswith("engine-warmup")


def _spy_routes(monkeypatch, engine):
    """Every batch the engine enqueues, as (on the warm thread, net,
    bucket, batch, proteins, the forwards it called in order)."""
    seen, local = [], threading.local()
    for name in ("gcn_forward", "gcn_forward_fused", "gcn_forward_multimode",
                 "cnn_forward"):
        def forward(*args, _real=getattr(engine_mod, name), _name=name,
                    **kwargs):
            local.calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(engine_mod, name, forward)
    real = engine._enqueue

    def spy(bucket, chunk, batch, modes, net):
        local.calls = []
        out = real(bucket, chunk, batch, modes, net)
        seen.append((_on_warm_thread(), net, bucket, batch, len(chunk),
                     tuple(local.calls)))
        return out

    monkeypatch.setattr(engine, "_enqueue", spy)
    return seen


@pytest.mark.parametrize("device, cap, expected, routes, warm_shapes", [
    # one dense route per mode on the CPU: one GCN and one CNN batch
    ("cpu", 4, {32: 5, 64: 9}, "auto",
     [("gcn_coords", 32, 4), ("cnn", 32, 4)]),
    # fused at bucket 32, dense at 64: a GCN batch at each
    ("cpu", 16, {32: 3, 64: 11}, "split",
     [("gcn_coords", 32, 8), ("gcn_coords", 64, 8), ("cnn", 32, 8)]),
    # the modes share the LM: one shared-trunk step
    ("cpu", 4, {64: 2}, "shared", [("gcn_coords", 64, 4), ("cnn", 64, 4)]),
    # a lone protein's batch, padded to the device count
    ("cpu,cpu", 5, {32: 1, 64: 12}, "auto",
     [("gcn_coords", 32, 6), ("cnn", 32, 6)]),
])
def test_warmup_plan_is_dispatch(monkeypatch, device, cap, expected, routes,
                                 warm_shapes):
    """``warmup(buckets)`` runs one batch of each route (the forwards a
    batch calls) that ``predict_stream`` (GCN) and ``predict_cnn`` (CNN)
    then take for a workload at those buckets, no more and no fewer, each
    at the smallest of those buckets that takes it and at the batch that
    dispatch gives a lone protein there: never larger than a real batch."""
    if routes == "split":
        monkeypatch.setattr(engine_mod, "resolve_spmm",
                            lambda policy, bucket, dtype, device:
                            "fused" if bucket == 32 else "dense")
    engine = _engine_with_cnn(device, cap, shared_lm=routes == "shared")
    seen = _spy_routes(monkeypatch, engine)
    report = engine.warmup(expected).result(timeout=120)
    assert report["shapes"] == warm_shapes and report["skipped"] == []
    warm = {(net, b, n): calls for w, net, b, n, k, calls in seen if w}
    assert list(warm) == warm_shapes
    assert all(k == n for w, _, _, n, k, _ in seen if w)  # every row filled
    seen.clear()
    rng = np.random.default_rng(3)
    gcn_items, cnn_items = [], []
    for bucket, count in expected.items():
        lo = 1 if bucket == min(BUCKETS) else bucket // 2 + 1
        for it in aligned_items(count, seed=int(rng.integers(1 << 30)),
                                min_len=max(lo, 8), max_len=bucket):
            gcn_items.append(it)
            cnn_items.append(it[:2])
    assert {engine_mod.assign_bucket(len(it[1]), BUCKETS)
            for it in gcn_items} == set(expected)
    engine.predict_stream(iter(gcn_items))
    engine.predict_cnn(cnn_items)
    assert not any(w for w, *_ in seen)
    for net in ("gcn_coords", "cnn"):
        real = [(b, n, calls) for _, nt, b, n, _, calls in seen if nt == net]
        mine = {(b, n): calls for (nt, b, n), calls in warm.items()
                if nt == net}
        assert sorted(set(mine.values())) == sorted({c for *_, c in real})
        for (b, n), calls in mine.items():
            assert b == min(bk for bk in expected
                            if engine._route(net, bk) ==
                            engine._route(net, b))
            assert [n] == [x for _, x in engine._chunks(b, net, [None])]
            assert n <= min(x for _, x, _ in real)


def test_warmup_leaves_scores_and_callbacks_alone(monkeypatch):
    """A finished background warmup changes no score, and no warm id
    reaches ``result_cb`` or ``progress_cb``; TF32 stays
    off (the warm thread never saves and restores the flags)."""
    from metagenomic_deepfri_tpu_torch import precision

    def forbidden():
        raise AssertionError("highest_f32_precision() entered")

    monkeypatch.setattr(precision, "highest_f32_precision", forbidden)
    items = _items()
    cold = _engine_with_cnn()
    want = cold.predict_gcn_from_coords(items)
    want_cnn = cold.predict_cnn([it[:2] for it in items])

    engine = _engine_with_cnn()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    assert highest_f32_precision_active()
    report = engine.warmup({32, 64}).result(timeout=120)
    assert report["seconds"] > 0 and report["shapes"] == [
        ("gcn_coords", 32, 4), ("cnn", 32, 4)]
    assert flags == (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
    assert highest_f32_precision_active()
    ids, progress = set(), []
    got = {m: {} for m in LABELS}

    def on_result(part):
        for m, rows in part.items():
            ids.update(rows)
            got[m].update(rows)

    engine.predict_stream(iter(items), result_cb=on_result,
                          progress_cb=progress.append)
    got_cnn = engine.predict_cnn([it[:2] for it in items],
                                 result_cb=lambda part: ids.update(
                                     q for rows in part.values()
                                     for q in rows),
                                 progress_cb=progress.append)
    assert ids == {it[0] for it in items} and sum(progress) == 2 * len(items)
    for mode in LABELS:
        for qid in want[mode]:
            assert np.array_equal(got[mode][qid], want[mode][qid])
            assert np.array_equal(got_cnn[mode][qid], want_cnn[mode][qid])


def test_real_dispatch_never_waits_for_warmup(monkeypatch):
    """A real batch runs to its end while a warm batch is held in flight,
    and no warm batch starts after it: the shapes left are reported as
    skipped."""
    engine = _engine_with_cnn()
    entered, release = threading.Event(), threading.Event()
    real_slice = engine._slice_outputs

    def gated(*args):
        if _on_warm_thread() and not entered.is_set():
            entered.set()
            assert release.wait(60)
        return real_slice(*args)

    monkeypatch.setattr(engine, "_slice_outputs", gated)
    future = engine.warmup({32, 64})
    assert entered.wait(60)
    try:
        out = engine.predict_gcn_from_coords(_items(), modes=["mf"])
        assert not future.done()  # the warm batch is still held
    finally:
        release.set()
    report = future.result(timeout=60)
    assert report["shapes"] == [("gcn_coords", 32, 4)]
    assert report["skipped"] == [("cnn", 32, 4)]
    assert len(out["mf"]) == 10


def test_warmup_failure_surfaces_through_the_future(monkeypatch):
    engine = _engine_with_cnn()
    real = engine._enqueue

    def failing(*args):
        if _on_warm_thread():
            raise RuntimeError("kernel failed to launch")
        return real(*args)

    monkeypatch.setattr(engine, "_enqueue", failing)
    future = engine.warmup({64})
    assert isinstance(future.exception(timeout=60), RuntimeError)
    with pytest.raises(RuntimeError, match="failed to launch"):
        future.result()
    # the engine still answers after a failed warmup
    assert len(engine.predict_gcn_from_coords(_items())["mf"]) == 10
