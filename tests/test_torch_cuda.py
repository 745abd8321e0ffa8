"""CUDA kernels against their plain PyTorch twins, on the GPU.

B1/B2 (``csrc/graphconv.cu``) and B3 (``csrc/contact.cu``), plus one
full-width fine-tuning step whose float32 loss and gradients are held to
float64 on the card, and the CNN and the shared-trunk multi-mode step on
the card against the same forwards on the CPU.

Marked ``cuda``: they skip where no CUDA device is present. On a machine
with one (and without JAX, which this file does not import), run them as

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

``--noconftest`` keeps ``tests/conftest.py``, which configures JAX, out.
"""

import dataclasses

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
                                                     near_threshold_batch)

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


@pytest.mark.parametrize("L", [130, 512])
def test_degrees_exact(cuda, L):
    args = _on(cuda, *contact_batch(B=4, L=L, seed=L))
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
@pytest.mark.parametrize("D", [48, 512, 1024])
@pytest.mark.parametrize("L", [130, 512])
def test_aggregate_matches_twin(cuda, L, D, compute_dtype):
    coords, ins, lengths = _on(cuda, *contact_batch(B=4, L=L, seed=D + L))
    g = torch.Generator().manual_seed(D)
    xs = torch.randn((4, L, D), generator=g).to(cuda)
    before = gc.graphconv_aggregate.launches
    out = gc.graphconv_aggregate(coords, ins, lengths, xs,
                                 compute_dtype=compute_dtype)
    ref = gc.graphconv_aggregate_ref(coords, ins, lengths, xs,
                                     compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert gc.graphconv_aggregate.launches == before + 1
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
    fused = BatchedPredictor(handles, device=cuda, batch_cap=8)
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


def test_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """``predict_protein_function(device="cuda")`` on a small structure
    directory: the same alignment summary and results.tsv rows as the same
    pipeline on the CPU (scores within one unit of the 4th decimal), with
    B1/B2 launched for every GCN batch."""
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
    for dev in ("cpu", str(cuda)):
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
            assert gc.contact_degrees.launches > before
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
