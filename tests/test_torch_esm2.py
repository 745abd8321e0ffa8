"""ESM-2 as the GCN's residue-LM trunk, on the CPU at a tiny size.

The plain reference (``esm2_reference.py``, float64, one protein at a
time) is tied to the Hugging Face ``EsmModel`` through the loader of the
published key layout; the port's trunk, ``predict_stream`` on its three
routes and ``predict-function`` from a native checkpoint folder are held to
that reference. Also: the shared-trunk step runs the trunk once a batch and
hashes none of it, the spans and counters, the alphabet table and the
token-slot batch rule.

Tolerances: the port computes in float32 and the reference in float64, so
residue representations (of order 1 after the final LayerNorm) agree to
float32 rounding through two layers of width 64, a few 1e-6 (asserted
within 1e-5); scores (probabilities) to within 1e-5 (asserted 2e-5), the
GCN tail's float32 sums over up to a few hundred residues added.
"""

import json

import numpy as np
import pytest
import torch

import esm2_reference as ref
from metagenomic_deepfri_tpu_torch import cli, profiling
from metagenomic_deepfri_tpu_torch.batching import buckets
from metagenomic_deepfri_tpu_torch.batching import engine as engine_mod
from metagenomic_deepfri_tpu_torch.batching.engine import (BatchedPredictor,
                                                           ModelHandle)
from metagenomic_deepfri_tpu_torch.models import deepfri, esm2
from metagenomic_deepfri_tpu_torch.models.convert import (
    esm2_from_hf_state_dict, gcn_params_from_numpy, gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.models.registry import (load_checkpoint,
                                                           load_models,
                                                           save_checkpoint)
from metagenomic_deepfri_tpu_torch.ops.one_hot import ALPHABET, batch_tokens
from metagenomic_deepfri_tpu_torch.synthetic import (AMINO_ACIDS,
                                                     aligned_items, hit_query,
                                                     write_structure_db)

TINY_ESM = esm2.ESM2Config(layers=2, dim=64, heads=4, ffn=256)
REP_TOL = 1e-5
SCORE_TOL = 2e-5
TERMS = {"bp": 9, "cc": 4, "mf": 6}


def _config(n_labels, **kw):
    return deepfri.ESMGCNConfig(n_labels=n_labels, embed_dim=32,
                                gc_dims=(16, 16, 16), fc_dims=(32,),
                                esm=TINY_ESM, **kw)


def _trees(seed=3, modes=TERMS):
    """{mode: tree} of random GCNs on one shared trunk and embedding pair
    (one tree object, as a model set that shares them is loaded)."""
    gen = torch.Generator().manual_seed(seed)
    base = deepfri.init_gcn(_config(1), gen, "cpu")
    out = {}
    for m, n in modes.items():
        tree = deepfri.init_gcn(_config(n), gen, "cpu")
        tree.update(lm=base["lm"], lm_embed=base["lm_embed"],
                    aa_embed=base["aa_embed"])
        out[m] = tree
    return out


def _engine(trees, **kw):
    handles = {m: ModelHandle("gcn", m, _config(TERMS[m]), t)
               for m, t in trees.items()}
    return BatchedPredictor(handles, device="cpu", **kw)


def _reference(tree, item):
    _, seq, coords, ins = item
    return ref.gcn_scores(tree, TINY_ESM.heads, seq, coords, ins).numpy()


# -- (a) the reference against the published implementation -------------------

def test_reference_matches_transformers_esm(monkeypatch):
    """The reference, on weights loaded through
    ``esm2_from_hf_state_dict``, against ``transformers.EsmModel`` on the
    same seeded random weights (every bias and LayerNorm affine away from
    its initial value): a padded batch of rows without ``<mask>``, and an
    unpadded row with one (``EsmModel`` 4.57 counts a padded row's padding
    in the ``<mask>`` share of its token-dropout scale, where ``fair-esm``
    counts real tokens only; the port has no ``<mask>``)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    cfg = transformers.EsmConfig(
        vocab_size=33, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256,
        position_embedding_type="rotary", token_dropout=True,
        mask_token_id=32, pad_token_id=1, emb_layer_norm_before=False,
        layer_norm_eps=1e-5, hidden_act="gelu", max_position_embeddings=1026)
    model = transformers.EsmModel(cfg, add_pooling_layer=False).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            shift = 1.0 if "LayerNorm" in name and name.endswith(
                "weight") else 0.0
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + shift)
    config, tree = esm2_from_hf_state_dict(
        {"esm." + k: v for k, v in model.state_dict().items()}, heads=4)
    assert config == TINY_ESM
    tree = gcn_params_from_numpy(tree, "cpu")
    seqs = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWYXBZUO" * 2, "GG"]
    ids = [ref.esm_ids(s) for s in seqs]
    T = max(len(i) for i in ids)
    batch = torch.full((3, T), 1)
    mask = torch.zeros((3, T), dtype=torch.long)
    for b, i in enumerate(ids):
        batch[b, :len(i)], mask[b, :len(i)] = i, 1
    with torch.no_grad():
        hf = model(input_ids=batch, attention_mask=mask).last_hidden_state
        masked = ids[1].clone()
        masked[5] = ref.MASK
        hf_masked = model(input_ids=masked[None]).last_hidden_state[0]
    for b, i in enumerate(ids):
        got = ref.trunk_ids(tree, 4, i)
        assert (got - hf[b, :len(i)].double()).abs().max() < REP_TOL
    got = ref.trunk_ids(tree, 4, masked)
    assert (got - hf_masked.double()).abs().max() < REP_TOL


# -- (b) the port's trunk ------------------------------------------------------

@pytest.mark.parametrize("bucket,rows", [(128, 3), (256, 5), (512, 8)])
def test_trunk_matches_reference_any_bucket_and_batch(bucket, rows):
    """Every row of a padded batch (empty padding rows among them) is
    finite, equals the reference, and does not depend on the bucket or on
    the rows beside it."""
    tree = _trees()["mf"]["lm"]
    rng = np.random.default_rng(bucket)
    seqs = ["".join(rng.choice(list(AMINO_ACIDS),
                               size=int(rng.integers(1, 120))))
            for _ in range(3)]
    padded = seqs + [""] * (rows - len(seqs))
    tokens, lengths = batch_tokens(padded, bucket)
    got = esm2.esm2_forward(tree, TINY_ESM, torch.from_numpy(tokens),
                            torch.from_numpy(lengths))
    assert got.shape == (rows, bucket, TINY_ESM.dim)
    assert torch.isfinite(got).all()
    alone = esm2.esm2_forward(tree, TINY_ESM,
                              torch.from_numpy(tokens[:1, :128]),
                              torch.from_numpy(lengths[:1]))
    for i, s in enumerate(seqs):
        want = ref.residues(tree, TINY_ESM.heads, s)
        assert (got[i, :len(s)].double() - want).abs().max() < REP_TOL
    assert (got[0, :len(seqs[0])] - alone[0, :len(seqs[0])]).abs().max() \
        < REP_TOL


# -- (c) predict_stream on every route -------------------------------------------

@pytest.mark.parametrize("modes,spmm", [(("mf",), "fused"), (("mf",), "dense"),
                                        (("bp", "cc", "mf"), "auto")])
def test_predict_stream_matches_reference(modes, spmm):
    """One mode on the fused route (the kernels' plain twins) and on the
    dense route, three modes in the shared-trunk step: every protein's
    scores equal the reference's."""
    trees = _trees()
    engine = _engine({m: trees[m] for m in modes}, spmm=spmm)
    items = aligned_items(12, seed=5, min_len=20, max_len=300)
    got = {m: {} for m in modes}

    def collect(part):
        for m in modes:
            got[m].update(part[m])

    assert engine.predict_stream(iter(items), modes=list(modes),
                                 result_cb=collect) == len(items)
    if len(modes) > 1:
        assert engine._multi_key(list(modes))
    for m in modes:
        for item in items:
            np.testing.assert_allclose(got[m][item[0]],
                                       _reference(trees[m], item),
                                       rtol=0, atol=SCORE_TOL)


# -- (d) one trunk pass a batch, nothing hashed ------------------------------------

def test_shared_trunk_runs_once_and_is_not_hashed(monkeypatch):
    """Three modes handed one trunk tree: the engine recognises it by its
    tensors, hashes none of it (only the per-mode subtrees), and the
    shared-trunk step runs ESM-2 once a batch."""
    hashed, passes = [], []
    real_digest, real_forward = engine_mod._subtree_digest, \
        deepfri.esm2_forward
    monkeypatch.setattr(engine_mod, "_subtree_digest",
                        lambda t: hashed.append(t) or real_digest(t))
    monkeypatch.setattr(deepfri, "esm2_forward",
                        lambda *a, **k: passes.append(1) or real_forward(
                            *a, **k))
    trees = _trees()
    engine = _engine(trees)
    assert sorted(engine._gcn_shared[0]) == ["aa_embed", "lm", "lm_embed"]
    assert not any(t is trees["mf"][k] for t in hashed
                   for k in ("lm", "lm_embed", "aa_embed"))
    assert len(hashed) == 3 * 3      # gc, fc and head of each mode
    items = aligned_items(20, seed=6, min_len=20, max_len=250)
    batches = []
    engine.predict_stream(iter(items), result_cb=batches.append)
    assert len(passes) == len(batches) == 2    # buckets 128 and 256


def test_equal_copies_are_still_shared_by_content():
    """Trunks loaded as separate, bitwise-equal copies (the published
    files each carry one) are shared through their content hashes."""
    trees = _trees()
    copies = {m: {**t, "lm": gcn_params_to_numpy(t["lm"])}
              for m, t in trees.items()}
    engine = _engine(copies)
    assert "lm" in engine._gcn_shared[0]


# -- (e) spans and counters ----------------------------------------------------------

def test_trunk_spans_and_counters():
    """``model/lm`` counts Σ(L+2) tokens, B·T slots and Σ(L+2)² pairs over
    the batch's proteins; every layer has its ``model/esm/attn`` (with
    ``model/esm/sdpa`` inside it) and ``model/esm/ffn`` spans."""
    engine = _engine(_trees())
    items = aligned_items(10, seed=7, min_len=20, max_len=110)
    profiling.reset()
    profiling.set_recording(True)
    try:
        engine.predict_stream(iter(items))
        got = profiling.spans()
    finally:
        profiling.set_recording(None)
        profiling.reset()
    lm = [s for s in got if s.name == "model/lm"]
    n = [len(it[1]) + 2 for it in items]
    assert len(lm) == 1
    assert lm[0].counts == {"tokens": sum(n), "slots": 16 * 130,
                            "attn_pairs": sum(v * v for v in n)}
    by = {name: [s for s in got if s.name == name]
          for name in ("model/esm/attn", "model/esm/sdpa", "model/esm/ffn")}
    assert all(len(v) == TINY_ESM.layers for v in by.values())
    attn_ids = {s.id for s in by["model/esm/attn"]}
    assert all(s.parent in attn_ids for s in by["model/esm/sdpa"])
    assert all(s.parent == lm[0].id for s in by["model/esm/ffn"])
    # Four projections a layer, each under model/esm/gemm: qkv and out in
    # the attention span, fc1 and fc2 in the feed-forward one; split 0
    # (torch.addmm) on the CPU.
    gemm = [s for s in got if s.name == "model/esm/gemm"]
    ffn_ids = {s.id for s in by["model/esm/ffn"]}
    assert len(gemm) == 4 * TINY_ESM.layers
    assert sum(s.parent in attn_ids for s in gemm) == 2 * TINY_ESM.layers
    assert sum(s.parent in ffn_ids for s in gemm) == 2 * TINY_ESM.layers
    assert {s.counts["rows"] for s in gemm} == {16 * 130}
    assert all(s.counts["split"] == 0 for s in gemm)


# -- (f) the alphabet and the batch rule ---------------------------------------------

def test_alphabet_table():
    assert esm2.ESM_ALPHABET == ref.ESM_ALPHABET
    assert len(esm2.ESM_ALPHABET) == 33
    assert [esm2.ESM_ALPHABET[i] for i in esm2.PORT_TO_ESM] == list(ALPHABET)
    assert esm2.PORT_TO_ESM.tolist() == [
        30, 13, 6, 26, 4, 17, 11, 15, 21, 19, 22, 23, 14, 7, 8, 28, 12, 9,
        18, 24, 16, 5, 25, 27, 10, 20]
    tokens, lengths = batch_tokens(["MKV", ""], 4)
    ids = esm2.esm_tokens(torch.from_numpy(tokens), torch.from_numpy(lengths))
    assert ids.tolist() == [[0, 20, 15, 7, 2, 1], [0, 2, 1, 1, 1, 1]]
    assert esm2.TOKEN_DROPOUT_SCALE == pytest.approx(0.88)


@pytest.mark.parametrize("bucket,rows", [(128, 256), (256, 128), (512, 64),
                                         (1024, 32), (2048, 16), (4096, 8),
                                         (8192, 4), (1280, 24)])
def test_token_slot_batch_rule(bucket, rows):
    assert buckets.ESM_TOKEN_SLOTS == 32768
    assert buckets.esm_batch_size(bucket) == rows
    gen = torch.Generator().manual_seed(1)
    handle = ModelHandle("gcn", "mf", _config(6), deepfri.init_gcn(
        _config(6), gen, "cpu"))
    one = BatchedPredictor({"mf": handle}, device="cpu")
    two = BatchedPredictor({"mf": handle}, device="cpu,cpu")
    assert one._steady_batch(bucket) == rows
    assert two._steady_batch(bucket) == 2 * rows
    assert one._steady_batch(bucket, "cnn") == buckets.cnn_batch_size(bucket)


def test_lstm_configs_keep_their_batch_rule():
    cfg = deepfri.GCNConfig(n_labels=3, lm_hidden=8, lm_layers=1,
                            embed_dim=16, gc_dims=(8,), fc_dims=(8,))
    handle = ModelHandle("gcn", "mf", cfg, deepfri.init_gcn(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    engine = BatchedPredictor({"mf": handle}, device="cpu")
    assert [engine._steady_batch(b) for b in (128, 512, 1024)] == [
        buckets.gcn_batch_size(b) for b in (128, 512, 1024)]


# -- (g) checkpoints and predict-function ---------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    """The sidecar names the trunk; the tree comes back leaf for leaf. An
    LSTM-LM GCN's sidecar gains no key."""
    cfg, tree = _config(6), gcn_params_to_numpy(_trees()["mf"])
    save_checkpoint(tmp_path / "gcn_mf.npz", cfg, tree)
    side = json.loads((tmp_path / "gcn_mf_config.json").read_text())
    assert side["esm"]["dim"] == 64 and side["esm"]["layers"] == 2
    got_cfg, got = load_checkpoint(tmp_path / "gcn_mf.npz")
    assert got_cfg == cfg
    flat = dict(engine_mod._tree_leaves(tree))
    assert flat.keys() == dict(engine_mod._tree_leaves(got)).keys()
    for path, leaf in engine_mod._tree_leaves(got):
        np.testing.assert_array_equal(leaf, flat[path])
    lstm = deepfri.GCNConfig(n_labels=2)
    save_checkpoint(tmp_path / "lstm.npz", lstm, {"x": np.zeros(1)})
    assert "esm" not in json.loads(
        (tmp_path / "lstm_config.json").read_text())
    assert load_checkpoint(tmp_path / "lstm.npz")[0] == lstm


def _weights_folder(path, trees):
    """A weights folder of native checkpoints: an ESM-2 GCN for each
    mode of ``trees`` and a tiny CNN for each."""
    path.mkdir()
    names = {"gcn": {}, "cnn": {}}
    gen = torch.Generator().manual_seed(9)
    for m, tree in trees.items():
        terms = [f"GO:{i:07d}" for i in range(TERMS[m])]
        cnn_cfg = deepfri.CNNConfig(n_labels=TERMS[m], conv_filters=8,
                                    conv_kernels=(3,), fc_dims=(8,))
        for net, cfg, params in (
                ("gcn", _config(TERMS[m]), gcn_params_to_numpy(tree)),
                ("cnn", cnn_cfg, gcn_params_to_numpy(
                    deepfri.init_cnn(cnn_cfg, gen, "cpu")))):
            name = f"{net}_{m}.npz"
            save_checkpoint(path / name, cfg, params)
            (path / f"{net}_{m}_model_params.json").write_text(json.dumps(
                {"goterms": terms, "gonames": [f"term {t}" for t in terms]}))
            names[net][m] = name
    (path / "model_config.json").write_text(json.dumps(
        {**names, "version": "1.1"}))
    return path


def test_load_models_from_native_checkpoints(tmp_path):
    trees = _trees()
    weights = _weights_folder(tmp_path / "w", trees)
    gcn, cnn, _ = load_models(weights, ["bp", "cc", "mf"])
    assert all(h.config.esm == TINY_ESM for h in gcn.values())
    engine = BatchedPredictor(gcn, device="cpu")
    assert "lm" in engine._gcn_shared[0]
    items = aligned_items(5, seed=10, min_len=30, max_len=90)
    got = engine.predict_gcn_from_coords(items)
    for m in gcn:
        for item in items:
            np.testing.assert_allclose(got[m][item[0]],
                                       _reference(trees[m], item),
                                       rtol=0, atol=SCORE_TOL)


def test_predict_function_from_a_weights_folder(tmp_path):
    """``predict-function`` on an ESM-2 GCN loaded from native
    checkpoints: each query with a structure hit gets the reference's
    scores on the contact map the run saved for it."""
    trees = _trees(modes={"mf": 6})
    weights = _weights_folder(tmp_path / "w", trees)
    seqs = write_structure_db(tmp_path / "structures", 4, seed=12,
                              min_len=50, max_len=120)
    rng = np.random.default_rng(13)
    queries = {f"q{i}": hit_query(rng, s) for i, s in enumerate(
        seqs.values())}
    (tmp_path / "q.faa").write_text("".join(
        f">{q}\n{s}\n" for q, s in queries.items()))
    out = tmp_path / "out"
    assert cli.main(["predict-function", "-i", str(tmp_path / "q.faa"),
                     "-d", str(tmp_path / "structures"), "-w", str(weights),
                     "-o", str(out), "--skip-pdb", "-p", "mf",
                     "--save-cmaps", "-t", "1", "--device", "cpu"]) == 0
    rows = (out / "prediction_matrix_mf.tsv").read_text().splitlines()
    header = rows[0].split("\t")
    assert header[2:] == [f"GO:{i:07d}" for i in range(6)]
    seen = 0
    for line in rows[1:]:
        cells = line.split("\t")
        cmaps = list((out / "contact_maps").glob(f"{cells[0]}*.npy"))
        if not cmaps:
            continue
        cmap = np.load(cmaps[0]).astype(np.float64)
        seq = queries[cells[0]]
        want = _scores_on_cmap(trees["mf"], seq, cmap)
        np.testing.assert_allclose(np.asarray(cells[2:], np.float64), want,
                                   rtol=0, atol=1e-4)
        seen += 1
    assert seen == len(queries)


def _scores_on_cmap(tree, seq, cmap):
    """The reference's scores of one protein on a given 0/1 contact map
    (DeepFRI's D^-1/2 A D^-1/2 normalisation)."""
    inv = 1.0 / np.sqrt(cmap.sum(-1))
    adj = torch.from_numpy(cmap * inv[:, None] * inv[None, :])
    return ref.gcn_scores(tree, TINY_ESM.heads, seq, adj=adj).numpy()
