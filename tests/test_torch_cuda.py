"""CUDA kernels against their plain PyTorch twins, on the GPU.

B1/B2 (``csrc/graphconv.cu``) and B3 (``csrc/contact.cu``), plus one
full-width fine-tuning step whose float32 loss and gradients are held to
float64 on the card, and the CNN and the shared-trunk multi-mode step on
the card against the same forwards on the CPU. On a host with several
cards, the kernels on every card (and from one thread a card at once), the
data-parallel engine, and NCCL ranks over every card.

Marked ``cuda``: they skip where no CUDA device is present. On a machine
with one (and without JAX, which this file does not import), run them as

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

``--noconftest`` keeps ``tests/conftest.py``, which configures JAX, out.
"""

import dataclasses
import shutil
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from metagenomic_deepfri_tpu_torch.batching.engine import (BatchedPredictor,
                                                           ModelHandle)
from metagenomic_deepfri_tpu_torch.models.convert import (
    gcn_params_from_numpy, gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.models.deepfri import (
    CNNConfig, GCNConfig, cnn_forward, forward_pass_single, gcn_forward,
    gcn_forward_fused, gcn_forward_multimode, init_cnn, init_gcn)
from metagenomic_deepfri_tpu_torch.ops import contact
from metagenomic_deepfri_tpu_torch.ops import graphconv as gc
from metagenomic_deepfri_tpu_torch.ops.one_hot import seq2tokens
from metagenomic_deepfri_tpu_torch.parallel import train
from metagenomic_deepfri_tpu_torch.precision import use_highest_f32_precision
from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
    aligned_contacts_from_coords
from metagenomic_deepfri_tpu_torch.synthetic import (AMINO_ACIDS,
                                                     aligned_items,
                                                     contact_batch,
                                                     near_threshold_batch,
                                                     with_float32_extremes)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(device, coords, ins, lengths):
    return (torch.from_numpy(coords).to(device),
            torch.from_numpy(ins).to(device),
            torch.from_numpy(lengths).to(device))


EDGE_L = [1, 63, 64, 65, 130, 512, 1000]


def _edge_batch(device, L, seed):
    """contact_batch(B=4, L) with lengths 0, 1 and L in the same batch (the
    fourth protein keeps its random length)."""
    coords, ins, lengths = contact_batch(B=4, L=max(L, 16), seed=seed)
    coords, ins = coords[:, :L].copy(), ins[:, :L].copy()
    lengths = np.minimum(lengths, L)
    lengths[:3] = (0, min(1, L), L)
    return _on(device, coords, ins, lengths.astype(np.int32))


def _features(B, L, D, seed):
    """Seeded float32 features; columns d % 3 == 0 scaled by 1e30 (one sign
    a column, so sums do not cancel), d % 3 == 1 by 1e-30."""
    xs = np.random.default_rng(seed).normal(size=(B, L, D))
    sign = np.where(np.arange(0, D, 3) % 2 == 0, 1.0, -1.0)
    xs[..., 0::3] = np.abs(xs[..., 0::3]) * 1e30 * sign
    xs[..., 1::3] *= 1e-30
    return torch.from_numpy(xs.astype(np.float32))


@pytest.mark.parametrize("L", EDGE_L)
def test_degrees_exact(cuda, L):
    args = _edge_batch(cuda, L, seed=L)
    before = gc.contact_degrees.launches
    deg = gc.contact_degrees(*args)
    ref = gc.contact_degrees_ref(*args)
    torch.cuda.synchronize()
    assert gc.contact_degrees.launches == before + 1
    torch.testing.assert_close(deg, ref, rtol=0, atol=0)


def test_degrees_near_threshold_exact(cuda):
    args = _on(cuda, *near_threshold_batch(B=4, L=512, seed=1))
    torch.testing.assert_close(gc.contact_degrees(*args),
                               gc.contact_degrees_ref(*args), rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [37, 48, 200, 512, 1024])
@pytest.mark.parametrize("L", EDGE_L)
def test_aggregate_matches_twin(cuda, L, D, compute_dtype):
    """Every D is accepted: D % 4 != 0 (37) takes 4-byte cp.async copies
    instead of TMA, odd D scalar stores; features mix magnitudes 1e30, 1
    and 1e-30."""
    coords, ins, lengths = _edge_batch(cuda, L, seed=D + L)
    xs = _features(4, L, D, seed=D).to(cuda)
    before = gc.graphconv_aggregate.launches
    out = gc.graphconv_aggregate(coords, ins, lengths, xs,
                                 compute_dtype=compute_dtype)
    ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs,
                                     compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert gc.graphconv_aggregate.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("D", [48, 1024])
@pytest.mark.parametrize("L", [130, 512])
def test_aggregate_float32_extremes(cuda, L, D):
    """float32 compute with one finite value past bf16's range (up to
    float32's largest) in a valid row of each protein: finite, and within
    rtol 1e-5 / atol 1e-4 of the twin."""
    coords, ins, lengths = contact_batch(B=4, L=L, seed=L + 1)
    xs = np.random.default_rng(D).normal(size=(4, L, D))
    xs = torch.from_numpy(with_float32_extremes(xs, lengths)).to(cuda)
    coords, ins, lengths = _on(cuda, coords, ins, lengths)
    out = gc.graphconv_aggregate(coords, ins, lengths, xs)
    ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ref).all()) and ref.abs().max() >= 3.4e38
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_rejects_wrong_dtype(cuda):
    coords, ins, lengths = _on(cuda, *contact_batch(B=2, L=64, seed=0))
    with pytest.raises(TypeError):
        gc.contact_degrees(coords, ins, lengths.to(torch.int64))
    with pytest.raises(ValueError):
        gc.graphconv_aggregate(coords, ins, lengths,
                               torch.zeros((2, 64, 8), device=cuda)[:, ::2])


def test_fused_forward_matches_dense(cuda):
    cfg = GCNConfig(n_labels=8, lm_hidden=16, lm_layers=1, embed_dim=128,
                    gc_dims=(128, 128), fc_dims=(32,))
    params = init_gcn(cfg, torch.Generator().manual_seed(0), cuda)
    coords, ins, lengths = _on(cuda, *contact_batch(B=2, L=128, seed=3))
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(
        rng.integers(1, 20, (2, 128)).astype(np.uint8)).to(cuda)
    adj = aligned_contacts_from_coords(coords, ins, lengths)
    ref = gcn_forward(params, cfg, tokens, adj, lengths)
    out = gcn_forward_fused(params, cfg, tokens, coords, ins, lengths)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["L130", "L512", "near_threshold"])
def test_contact_map_exact(cuda, case):
    """B3 against its twin, exact: sentinel coordinates (1e6 + 1e3·i, far
    from everything), ragged lengths, and pairs at 6 Å ± 1 ulp."""
    if case == "near_threshold":
        coords, _, lengths = near_threshold_batch(B=4, L=512, seed=2)
        lengths[1:] = (500, 129, 1)
    else:
        coords, _, lengths = contact_batch(B=4, L=int(case[1:]),
                                           seed=int(case[1:]))
    coords = torch.from_numpy(coords).to(cuda)
    lengths = torch.from_numpy(lengths).to(cuda)
    before = contact.contact_map_fused.launches
    out = contact.contact_map_fused(coords, lengths)
    ref = contact.batched_contact_maps(coords, lengths)
    torch.cuda.synchronize()
    assert contact.contact_map_fused.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("B, L", [(0, 64), (3, 0), (2, 1), (1, 65)])
def test_contact_map_edge_shapes(cuda, B, L):
    coords = torch.randn((B, L, 3), device=cuda)
    lengths = torch.full((B,), L, dtype=torch.int32, device=cuda)
    out = contact.contact_map_fused(coords, lengths)
    assert out.shape == (B, L, L) and out.dtype == torch.float32
    torch.testing.assert_close(out, contact.batched_contact_maps(
        coords, lengths), rtol=0, atol=0)


def test_contact_map_rejects_bad_inputs(cuda):
    coords = torch.zeros((2, 8, 3), device=cuda)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        contact.contact_map_fused(coords.double(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        contact.contact_map_fused(
            torch.zeros((2, 8, 6), device=cuda)[:, :, ::2], lengths)
    with pytest.raises(ValueError, match="is on"):
        contact.contact_map_fused(coords, lengths.cpu())


def test_full_width_step_matches_float64(cuda):
    """One step at the published width (mf head, 489 terms): float32 loss
    and every gradient leaf within normwise rtol 1e-4 of float64, both on
    the card (TF32 would exceed it)."""
    use_highest_f32_precision()
    cfg = GCNConfig(n_labels=489, adj_norm="none")
    params = init_gcn(cfg, torch.Generator().manual_seed(0), "cpu")
    coords, _, lengths = contact_batch(B=4, L=256, seed=5)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(
        rng.integers(1, 25, (4, 256)).astype(np.uint8)).to(cuda)
    labels = torch.from_numpy(
        (rng.random((4, 489)) < 0.01).astype(np.int32)).to(cuda)
    lengths = torch.from_numpy(lengths).to(cuda)
    adj = contact.contact_map_fused(torch.from_numpy(coords).to(cuda),
                                    lengths)
    out = {}
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="float64")):
        dtype = torch.float64 if c.compute_dtype == "float64" \
            else torch.float32
        p = gcn_params_from_numpy(params, cuda, dtype, requires_grad=True)
        loss = train.gcn_loss(p, c, tokens, adj.to(dtype), lengths, labels)
        out[dtype] = [loss] + list(torch.autograd.grad(
            loss, train.param_leaves(p)))
    for g, r in zip(out[torch.float32], out[torch.float64], strict=True):
        err = (g.double() - r).abs().max() / r.abs().max().clamp_min(1e-300)
        assert err.item() <= 1e-4


def test_cnn_on_card_matches_cpu(cuda):
    """The full-width CNN (512 filters of widths 8 and 16, FC 1024) on the
    card against the CPU, float32 with TF32 off: atol 1e-5; and each row of
    a padded engine batch against its unpadded single run on the card."""
    use_highest_f32_precision()
    cfg = CNNConfig(n_labels=489)
    params = gcn_params_to_numpy(init_cnn(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(3)
    seqs = [(f"s{i}", "".join(rng.choice(list(AMINO_ACIDS), size=int(n))))
            for i, n in enumerate((5, 40, 333, 1000))]
    tokens = np.zeros((4, 1024), np.uint8)
    lengths = np.array([len(s) for _, s in seqs], np.int32)
    for i, (_, s) in enumerate(seqs):
        tokens[i, :len(s)] = seq2tokens(s)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = cnn_forward(
            gcn_params_from_numpy(params, dev), cfg,
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev)).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-5)
    engine = BatchedPredictor(cnn_models={"mf": ModelHandle(
        "cnn", "mf", cfg, params)}, device=cuda)
    rows = engine.predict_cnn(seqs)["mf"]
    p = gcn_params_from_numpy(params, cuda)
    for qid, seq in seqs:
        np.testing.assert_allclose(
            rows[qid], forward_pass_single(p, cfg, seq).cpu().numpy(),
            rtol=0, atol=1e-5)


def test_multimode_on_card_matches_per_mode(cuda):
    """The shared-trunk step on the card against per-mode dense forwards
    on the card (atol 1e-5), and the dense multi-mode engine against the
    fused per-mode engine (B1/B2) on the card (atol 1e-4)."""
    use_highest_f32_precision()
    labels = {"bp": 64, "cc": 16, "mf": 32}
    cfgs, trees = {}, {}
    for i, (mode, n) in enumerate(labels.items()):
        cfgs[mode] = GCNConfig(n_labels=n, lm_hidden=64, lm_layers=2,
                               embed_dim=128, gc_dims=(64, 64), fc_dims=(64,))
        trees[mode] = gcn_params_to_numpy(init_gcn(
            cfgs[mode], torch.Generator().manual_seed(i), "cpu"))
        for k in ("lm", "lm_embed", "aa_embed"):
            trees[mode][k] = trees["bp"][k]
    coords, ins, lengths = _on(cuda, *contact_batch(B=4, L=256, seed=9))
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        1, 25, (4, 256)).astype(np.uint8)).to(cuda)
    adj = aligned_contacts_from_coords(coords, ins, lengths)
    shared = {k: gcn_params_from_numpy(trees["bp"][k], cuda)
              for k in ("lm", "lm_embed", "aa_embed")}
    per_mode = {m: gcn_params_from_numpy(
        {k: v for k, v in t.items() if k not in shared}, cuda)
        for m, t in trees.items()}
    out = gcn_forward_multimode(shared, per_mode, cfgs, tokens, adj, lengths)
    for m in labels:
        ref = gcn_forward(gcn_params_from_numpy(trees[m], cuda), cfgs[m],
                          tokens, adj, lengths)
        torch.testing.assert_close(out[m], ref, rtol=0, atol=1e-5)
    handles = {m: ModelHandle("gcn", m, cfgs[m], trees[m]) for m in labels}
    items = aligned_items(20, seed=4, min_len=40, max_len=300)
    fused = BatchedPredictor(handles, device=cuda, batch_cap=8,
                             spmm="fused")
    dense = BatchedPredictor(handles, device=cuda, batch_cap=8, spmm="dense")
    assert dense._multi_key(list(labels))
    before = gc.graphconv_aggregate.launches
    got = fused.predict_gcn_from_coords(items)
    assert gc.graphconv_aggregate.launches > before
    want = dense.predict_gcn_from_coords(items)
    for m in labels:
        for q in want[m]:
            np.testing.assert_allclose(got[m][q], want[m][q], rtol=0,
                                       atol=1e-4)


def _fused_modes_per_batch(monkeypatch) -> list:
    """Spy on every engine's GCN batches: for each, the number of modes the
    spmm policy sends to the fused kernels (one B2 and three B1 launches
    each; none for a shared-trunk batch)."""
    seen = []
    real = BatchedPredictor._run_batch

    def spy(self, bucket, chunk, batch, modes, net="gcn_coords",
            overflow_cb=None):
        if net == "gcn_coords":
            seen.append(0 if self._multi_key(modes) else sum(
                self._mode_spmm(m, bucket) == "fused" for m in modes))
        return real(self, bucket, chunk, batch, modes, net, overflow_cb)

    monkeypatch.setattr(BatchedPredictor, "_run_batch", spy)
    return seen


def test_native_search_with_cuda_initialised(cuda):
    """The native NW and k-mer libraries (system OpenMP) run with 4 threads
    in a process where torch has initialised CUDA (and loaded its own
    OpenMP runtime): equal to their single-threaded and numpy results."""
    from metagenomic_deepfri_tpu_torch.align.matrices import ScoringMatrix
    from metagenomic_deepfri_tpu_torch.ops.nw import nw_align, nw_score_many
    from metagenomic_deepfri_tpu_torch.search.engine import builtin_search

    torch.ones(8, device=cuda).sum().item()
    rng = np.random.default_rng(12)
    aas = list(AMINO_ACIDS)
    targets = {f"t{i}": "".join(rng.choice(aas, size=int(
        rng.integers(60, 300)))) for i in range(120)}
    queries = {}
    for i, (tid, seq) in enumerate(list(targets.items())[:40]):
        q = list(seq)
        for pos in rng.choice(len(q), size=len(q) // 10, replace=False):
            q[pos] = rng.choice(aas)
        queries[f"q{i}"] = "".join(q)
    sm = ScoringMatrix.from_name("BLOSUM62")
    seqs = list(targets.values())
    many = nw_score_many(queries["q0"], seqs, sm, threads=4)
    assert np.array_equal(many, nw_score_many(queries["q0"], seqs, sm,
                                              threads=1))
    assert np.array_equal(many[:6], [nw_align(queries["q0"], t, sm,
                                              force_python=True)[0]
                                     for t in seqs[:6]])
    four = builtin_search(queries, targets, max_eval=1e-3, threads=4)
    one = builtin_search(queries, targets, max_eval=1e-3, threads=1)
    assert len(four) >= 40
    for col in four.table.dtype.names:
        assert np.array_equal(four.table[col], one.table[col])
    assert torch.cuda.is_initialized()


def test_pipeline_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``predict_protein_function(device="cuda")`` on a small structure
    directory: the same alignment summary and results.tsv rows as the same
    pipeline on the CPU (scores within one unit of the 4th decimal), with
    B2 launched once for every mode of a GCN batch that the ``"auto"``
    table sends to the fused kernels."""
    from metagenomic_deepfri_tpu_torch import pipeline, synthetic

    db = synthetic.write_structure_db(tmp_path / "structures", 24, seed=3,
                                      min_len=40, max_len=300)
    rng = np.random.default_rng(4)
    queries = {f"h{i}": synthetic.hit_query(rng, db[f"s{i}"])
               for i in range(12)}
    queries.update({f"n{i}": "".join(rng.choice(list(AMINO_ACIDS), 90))
                    for i in range(6)})
    (tmp_path / "q.faa").write_text(
        "".join(f">{k}\n{v}\n" for k, v in queries.items()))
    gcn, cnn = {}, {}
    for i, mode in enumerate(("mf", "cc")):
        gcfg = GCNConfig(n_labels=24, lm_hidden=32, lm_layers=1,
                         embed_dim=32, gc_dims=(32, 32, 32), fc_dims=(32,),
                         adj_norm="none")
        ccfg = CNNConfig(n_labels=24, conv_filters=16, conv_kernels=(8, 16),
                         fc_dims=(32,))
        terms = synthetic.goterms(24)
        gcn[mode] = (gcfg, gcn_params_to_numpy(init_gcn(
            gcfg, torch.Generator().manual_seed(i), "cpu")), terms)
        cnn[mode] = (ccfg, gcn_params_to_numpy(init_cnn(
            ccfg, torch.Generator().manual_seed(10 + i), "cpu")), terms)
    weights = synthetic.write_model_set(tmp_path / "weights", gcn, cnn)

    outs = {}
    fused_modes = _fused_modes_per_batch(monkeypatch)
    for dev in ("cpu", str(cuda)):
        fused_modes.clear()
        out = tmp_path / f"on_{dev}"
        qf = pipeline.load_query_file(tmp_path / "q.faa")
        dbs = pipeline.hierarchical_database_search(
            qf, out / "database_search", [tmp_path / "structures"],
            skip_pdb=True, max_eval=1e-3, threads=4)
        before = gc.contact_degrees.launches
        pipeline.predict_protein_function(
            pipeline.load_query_file(tmp_path / "q.faa"), tuple(dbs),
            weights, out, deepfri_processing_modes=["mf", "cc"], threads=4,
            device=dev)
        if torch.device(dev).type == "cuda":
            assert fused_modes
            assert gc.contact_degrees.launches - before == sum(fused_modes)
        outs["card" if dev != "cpu" else "cpu"] = out
    assert (outs["card"] / "alignment_summary.tsv").read_bytes() == \
        (outs["cpu"] / "alignment_summary.tsv").read_bytes()
    rows = {d: [ln.split("\t") for ln in
                (o / "results.tsv").read_text().splitlines()]
            for d, o in outs.items()}
    assert len(rows["card"]) == len(rows["cpu"]) > 10
    for a, b in zip(rows["card"], rows["cpu"]):
        assert a[:4] + a[5:] == b[:4] + b[5:]
        if a[4] != "score":
            assert abs(float(a[4]) - float(b[4])) <= 1e-4 + 1e-9


def test_server_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``AnnotationServer(device="cuda:0")`` answers through its batcher
    thread (whose current device is not set by the caller) and its socket
    as the same server on the CPU does: the same ids, skips and metadata,
    scores within one unit of the 4th decimal, B1 launched three times for
    every mode of a GCN batch that the ``"auto"`` table sends to the fused
    kernels."""
    from metagenomic_deepfri_tpu_torch import synthetic
    from metagenomic_deepfri_tpu_torch.serving import (AnnotationServer,
                                                       annotate_over_socket)

    db = synthetic.write_structure_db(tmp_path / "structures", 16, seed=5,
                                      min_len=40, max_len=300)
    rng = np.random.default_rng(6)
    queries = {f"h{i}": synthetic.hit_query(rng, db[f"s{i}"])
               for i in range(8)}
    queries.update({f"n{i}": "".join(rng.choice(list(AMINO_ACIDS), 80))
                    for i in range(4)})
    queries["sel"] = "MKVU" + queries["n0"]
    gcn, cnn = {}, {}
    for i, mode in enumerate(("mf", "cc")):
        gcfg = GCNConfig(n_labels=24, lm_hidden=32, lm_layers=1,
                         embed_dim=32, gc_dims=(32, 32, 32), fc_dims=(32,),
                         adj_norm="none")
        ccfg = CNNConfig(n_labels=24, conv_filters=16, conv_kernels=(8, 16),
                         fc_dims=(32,))
        terms = synthetic.goterms(24)
        gcn[mode] = (gcfg, gcn_params_to_numpy(init_gcn(
            gcfg, torch.Generator().manual_seed(i), "cpu")), terms)
        cnn[mode] = (ccfg, gcn_params_to_numpy(init_cnn(
            ccfg, torch.Generator().manual_seed(10 + i), "cpu")), terms)
    weights = synthetic.write_model_set(tmp_path / "weights", gcn, cnn)
    kw = dict(databases=[tmp_path / "structures"], max_eval=1e-3, threads=4)
    ref = AnnotationServer(weights, device="cpu", **kw).annotate(queries)
    srv = AnnotationServer(weights, device="cuda:0", **kw)
    srv._warmup_future.result(timeout=300)  # its launches before the count
    fused_modes = _fused_modes_per_batch(monkeypatch)
    before = gc.graphconv_aggregate.launches
    got = srv.submit(dict(queries), timeout=300)
    assert fused_modes
    assert gc.graphconv_aggregate.launches - before == 3 * sum(fused_modes)
    sock_dir = tempfile.mkdtemp()   # Unix socket paths are short
    sock = Path(sock_dir) / "s.sock"
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_unix, args=(sock, ready),
                         daemon=True)
    t.start()
    try:
        assert ready.wait(10)
        assert annotate_over_socket(sock, {"h0": queries["h0"]})[
            "results"]["h0"]["target"] == "s0"
    finally:
        srv.shutdown()
        t.join(timeout=10)
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert got["skipped"] == ref["skipped"] == {"sel": "selenocysteine"}
    assert set(got["results"]) == set(ref["results"])
    for qid, r in ref["results"].items():
        g = got["results"][qid]
        assert {k: v for k, v in g.items() if k != "scores"} == \
            {k: v for k, v in r.items() if k != "scores"}
        for mode, rows in r["scores"].items():
            want = {t: s for t, s, _ in rows}
            have = {t: s for t, s, _ in g["scores"][mode]}
            for term in want.keys() | have.keys():
                if term in want and term in have:
                    assert abs(want[term] - have[term]) <= 1e-4 + 1e-9
                else:
                    assert (want.get(term) or have.get(term)) <= 0.1 + 1e-4
    assert got["results"]["h0"]["aligned"] and not \
        got["results"]["n0"]["aligned"]


def test_predict_gcn_on_card_matches_cpu(cuda):
    """``predict_gcn`` on the card (the uint8 adjacency from pinned host
    memory, copied without blocking) gives the CPU engine's rows, on the
    shared-trunk step and per mode, and launches no kernel of ours."""
    from metagenomic_deepfri_tpu_torch.bench_utils import make_random_items

    labels = {"bp": 40, "cc": 6, "mf": 9}
    base = GCNConfig(n_labels=1, lm_hidden=32, lm_layers=1, embed_dim=32,
                     gc_dims=(32, 32), fc_dims=(32,))
    trees, shared = {}, None
    for i, (m, n) in enumerate(labels.items()):
        trees[m] = gcn_params_to_numpy(init_gcn(
            dataclasses.replace(base, n_labels=n),
            torch.Generator().manual_seed(i), "cpu"))
        shared = shared or trees[m]["lm"]
        trees[m]["lm"] = shared
    handles = {m: ModelHandle("gcn", m, dataclasses.replace(
        base, n_labels=n), trees[m]) for m, n in labels.items()}
    items = make_random_items(20, 40, 300, seed=8, form="dense")
    for modes in (list(labels), ["mf"]):
        want = BatchedPredictor(handles, device="cpu", batch_cap=8
                                ).predict_gcn(items, modes=modes)
        engine = BatchedPredictor(handles, device=cuda, batch_cap=8)
        assert bool(engine._multi_key(modes)) == (len(modes) > 1)
        before = (gc.graphconv_aggregate.launches,
                  gc.contact_degrees.launches)
        got = engine.predict_gcn(items, modes=modes)
        assert before == (gc.graphconv_aggregate.launches,
                          gc.contact_degrees.launches)
        for m in modes:
            for q in want[m]:
                np.testing.assert_allclose(got[m][q], want[m][q], rtol=0,
                                           atol=1e-4)


def test_nw_device_matches_host_on_card(cuda):
    """The device NW wavefront on the card equals the host engine on 200
    seeded pairs (8 queries × 25 targets) at three gap settings."""
    from metagenomic_deepfri_tpu_torch.align.matrices import ScoringMatrix
    from metagenomic_deepfri_tpu_torch.ops.nw import (nw_score_many,
                                                      nw_score_many_device)

    sm = ScoringMatrix.from_name("BLOSUM62")
    rng = np.random.default_rng(11)
    aas = list(AMINO_ACIDS)
    gaps = [(10, 1), (11, 1), (5, 2)]
    for i in range(8):
        go, ge = gaps[i % 3]
        q = "".join(rng.choice(aas, size=int(rng.integers(1, 301))))
        targets = ["".join(rng.choice(aas, size=int(rng.integers(1, 301))))
                   for _ in range(25)]
        got = nw_score_many_device(q, targets, sm, go, ge, device=cuda)
        assert np.array_equal(got, nw_score_many(q, targets, sm, go, ge))


def test_device_only_gcn_pps_on_card(cuda):
    """``bench_utils.device_only_gcn_pps`` on the card: a finite positive
    rate on each route, named with the card."""
    from metagenomic_deepfri_tpu_torch import bench_utils

    for spmm in ("fused", "dense"):
        row = bench_utils.device_only_gcn_pps(bucket=128, n_labels=64,
                                              reps=2, batch_cap=8,
                                              spmm=spmm, device=cuda)
        assert row["spmm_route"] == spmm
        assert np.isfinite(row["device_only_pps"])
        assert row["device_only_pps"] > 0
    assert bench_utils.device_name(cuda) == torch.cuda.get_device_name(0)


# ---------------------------------------------------------------------------
# Several cards. Run them on a host with four with the command above; each
# skips below two cards.
# ---------------------------------------------------------------------------


@pytest.fixture
def cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_kernels_on_every_card(cards):
    """B1/B2/B3 on each card (not the current one) against their twins
    there, each launch counted once."""
    batch = contact_batch(B=4, L=512, seed=3)
    xs_host = _features(4, 512, 200, seed=3)
    for dev in cards:
        coords, ins, lengths = _on(dev, *batch)
        xs = xs_host.to(dev)
        before = (gc.contact_degrees.launches, gc.graphconv_aggregate.launches,
                  contact.contact_map_fused.launches)
        deg = gc.contact_degrees(coords, ins, lengths)
        out = gc.graphconv_aggregate(coords, ins, lengths, xs)
        cmap = contact.contact_map_fused(coords, lengths)
        torch.cuda.synchronize(dev)
        assert (gc.contact_degrees.launches, gc.graphconv_aggregate.launches,
                contact.contact_map_fused.launches) == tuple(
                    b + 1 for b in before)
        assert deg.device == out.device == cmap.device == dev
        torch.testing.assert_close(
            deg, gc.contact_degrees_ref(coords, ins, lengths), rtol=0, atol=0)
        torch.testing.assert_close(
            out, gc.graphconv_aggregate_ref(coords, ins, lengths, xs),
            rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(
            cmap, contact.batched_contact_maps(coords, lengths), rtol=0,
            atol=0)


def test_kernels_from_threads_on_every_card(cards):
    """One host thread a card launching B1 and B2 at once (as the
    multi-device engine does): every result right, every launch counted."""
    batch = contact_batch(B=4, L=256, seed=5)
    xs_host = _features(4, 256, 48, seed=5)
    reps = 20
    before = (gc.contact_degrees.launches, gc.graphconv_aggregate.launches)
    errors = []

    def work(dev):
        try:
            with torch.cuda.device(dev), torch.cuda.stream(
                    torch.cuda.Stream(dev)):
                coords, ins, lengths = _on(dev, *batch)
                xs = xs_host.to(dev)
                ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs)
                for _ in range(reps):
                    gc.contact_degrees(coords, ins, lengths)
                    out = gc.graphconv_aggregate(coords, ins, lengths, xs)
                torch.testing.assert_close(out.cpu(), ref.cpu(), rtol=1e-5,
                                           atol=1e-4)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=work, args=(d,)) for d in cards]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert (gc.contact_degrees.launches - before[0],
            gc.graphconv_aggregate.launches - before[1]) == (
                reps * len(cards), reps * len(cards))


def test_engine_over_every_card_matches_one(cards):
    """The data-parallel engine over every card against one card, on the
    fused route: the same scores, B1/B2 on every card's slice."""
    cfg = GCNConfig(n_labels=40, lm_hidden=64, lm_layers=1, embed_dim=64,
                    gc_dims=(32, 32), fc_dims=(64,))
    h = {"mf": ModelHandle("gcn", "mf", cfg, gcn_params_to_numpy(
        init_gcn(cfg, torch.Generator().manual_seed(0), "cpu")))}
    items = aligned_items(37, seed=4, min_len=20, max_len=200)
    one = BatchedPredictor(h, device=cards[0], spmm="fused",
                           batch_cap=16).predict_gcn_from_coords(items)
    gc.reset_launch_counts()
    many = BatchedPredictor(h, device=cards, spmm="fused", batch_cap=16)
    got = many.predict_gcn_from_coords(items)
    # buckets of 20-200 aa: 128 and 256; each batch runs once a card
    assert gc.contact_degrees.launches % len(cards) == 0
    assert gc.graphconv_aggregate.launches == 2 * gc.contact_degrees.launches
    for qid, row in one["mf"].items():
        np.testing.assert_allclose(got["mf"][qid], row, rtol=0, atol=1e-5)


def test_ranks_over_every_card(cards):
    """NCCL ranks, one a card: the data- and tensor-parallel forward and the
    graph-sharded forward against the dense forward on one card."""
    from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
        aligned_contacts_from_coords
    from metagenomic_deepfri_tpu_torch.parallel import graph_shard, shard

    use_highest_f32_precision()
    cfg = GCNConfig(n_labels=8, lm_hidden=16, lm_layers=1, embed_dim=32,
                    gc_dims=(16, 16), fc_dims=(32, 16))
    params = gcn_params_to_numpy(init_gcn(
        cfg, torch.Generator().manual_seed(1), "cpu", gc_bias=True))
    n = len(cards)
    coords, ins, lengths = contact_batch(B=2 * n, L=16 * n, seed=9)
    tokens = np.random.default_rng(9).integers(
        1, 21, coords.shape[:2]).astype(np.uint8)
    dev = cards[0]
    t, c, i, ln = (torch.from_numpy(a).to(dev)
                   for a in (tokens, coords, ins, lengths))
    adj = aligned_contacts_from_coords(c, i, ln)
    with torch.no_grad():
        ref = gcn_forward(gcn_params_from_numpy(params, dev), cfg, t, adj,
                          ln).cpu().numpy()
    mp = 2 if n % 2 == 0 else 1
    got = shard.sharded_gcn_forward(cards, cfg, params, tokens,
                                    adj.cpu().numpy(), lengths,
                                    model_parallel=mp)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    got = graph_shard.graph_sharded_gcn_forward(cards, cfg, params, tokens,
                                                coords, ins, lengths)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_spans_enclose_their_kernels_on_the_trace_clock(cuda):
    """Under a CUDA-only profiler session (as the benchmark traces), a host
    span around a product's launch and ``synchronize()`` encloses the
    product's kernels on the trace's clock, and the device span's CUDA
    events, resolved only when read, hold at least the kernels' time."""
    from torch.profiler import ProfilerActivity, profile

    from metagenomic_deepfri_tpu_torch import profiling

    a = torch.randn(2048, 2048, device=cuda)
    (a @ a).sum().item()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with profiling.span("probe"), \
                    profiling.device_span("probe/device", cuda) as dev:
                a @ a
                assert dev._events is not None
                torch.cuda.synchronize()
    got = profiling.spans()
    probes = [s for s in got if s.name == "probe"]
    devices = [s for s in got if s.name == "probe/device"]
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()]
    assert len(probes) == len(devices) == 3 and kernels
    for k in kernels:
        start, end = k.start_ns(), k.start_ns() + k.duration_ns()
        (probe,) = [p for p in probes if p.start_ns <= start <= p.end_ns]
        assert end <= probe.end_ns
    for probe, dev in zip(probes, devices):
        inside = sum(k.duration_ns() for k in kernels
                     if probe.start_ns <= k.start_ns() <= probe.end_ns)
        assert inside / 1e9 <= dev.device_s <= probe.host_s
    profiling.reset()


def test_engine_spans_on_the_card(cuda):
    """The engine's batch, host and model spans on the card: every model
    span resolved to device seconds, ``engine/unpack`` opened only after the
    device finished, and nothing recorded outside a session."""
    from torch.profiler import ProfilerActivity, profile

    from metagenomic_deepfri_tpu_torch import profiling

    use_highest_f32_precision()
    cfg = GCNConfig(n_labels=24, lm_hidden=32, lm_layers=1, embed_dim=64,
                    gc_dims=(32, 32), fc_dims=(64,))
    h = {m: ModelHandle("gcn", m, cfg, gcn_params_to_numpy(init_gcn(
        cfg, torch.Generator().manual_seed(2), "cpu"))) for m in ("mf",)}
    engine = BatchedPredictor(h, device=cuda, spmm="fused", batch_cap=16)
    items = aligned_items(40, seed=3, min_len=30, max_len=200)
    profiling.reset()
    engine.predict_gcn_from_coords(items)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.predict_gcn_from_coords(items)
    got = {}
    for s in profiling.spans():
        got.setdefault(s.name, []).append(s)
    batches = got["engine/batch"]
    assert sum(b.counts["rows"] for b in batches) == 40
    for name in ("model/lm", "model/graph", "model/head"):
        assert len(got[name]) == len(batches)
        assert all(s.device_s > 0 for s in got[name])
    device = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation()]
    assert device
    for batch, unpack in zip(batches, got["engine/unpack"]):
        assert unpack.parent == batch.id
        assert all(end <= unpack.start_ns for start, end in device
                   if batch.start_ns <= start < unpack.start_ns)
    profiling.reset()


def test_esm2_trunk_at_published_widths_on_card(cuda):
    """ESM-2 650M's trunk (33 layers, d 1280, 20 heads, FFN 5120) on a few
    proteins in one padded batch, with an empty padding row, against the
    plain reference (``esm2_reference.py``, float64 on the card), with
    TF32 off. The tolerance, 5e-4 on the residue representation (values of
    order 1 after the final LayerNorm), holds float32 rounding through 33
    layers of width 1280 and 5120 with room (5.4e-6 on the H100); the same
    batch with TF32 on (10 mantissa bits for every matmul operand; 3.5e-3)
    misses it."""
    from esm2_reference import residues
    from metagenomic_deepfri_tpu_torch.models.esm2 import (ESM2Config,
                                                           esm2_forward,
                                                           init_esm2)

    cfg = ESM2Config()
    tree = init_esm2(cfg, torch.Generator(device=cuda).manual_seed(7), cuda)
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list(AMINO_ACIDS), size=n))
            for n in (37, 250, 610)]
    tokens = np.zeros((4, 640), np.uint8)
    lengths = np.zeros(4, np.int32)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = seq2tokens(s)
        lengths[i] = len(s)
    tok, lens = (torch.from_numpy(tokens).to(cuda),
                 torch.from_numpy(lengths).to(cuda))
    ref = [residues(tree, cfg.heads, s) for s in seqs]

    def widest():
        with torch.inference_mode():
            got = esm2_forward(tree, cfg, tok, lens)
        assert torch.isfinite(got).all()
        return max(float((got[i, :len(s)].double() - r).abs().max())
                   for i, (s, r) in enumerate(zip(seqs, ref)))

    use_highest_f32_precision()
    exact = widest()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = widest()
    finally:
        use_highest_f32_precision()
    print(f"esm2 trunk on the card: float32 {exact:.3g}, TF32 {tf32:.3g}")
    assert exact < 5e-4 < tf32
