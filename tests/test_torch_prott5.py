"""ProtT5-XL-UniRef50's encoder as the GCN's residue-LM trunk, on the CPU at
a tiny size: 2 layers, d 64, 4 heads of d_kv 32 (an inner width of 128,
not d), d_ff 256, 32 buckets to a distance of 128, lengths up to 300 (so
the log-spaced buckets and the clamp are reached).

The plain reference (``prott5_reference.py``, float32, padded blocks) is
tied to ``transformers.T5EncoderModel`` through the converter of its key
layout; the port's trunk and ``predict_stream`` on the shared-trunk step
are held to that reference, and three mutations of the port (the position
bias dropped, T5's missing 1/√d_kv scale added, LayerNorm in RMSNorm's
place) each miss it. Also: the bucket table, independence from batch-mates
and padding, spans and counters, checkpoints and the registry, and the
token-slot batch rule of both transformer trunks.

Tolerances: the port and the reference both compute in float32, in other
orders (E2's twin, with its own bias gather, against the reference's
softmax; E1's twin absent on the CPU, so ``torch.mm`` against
``torch.matmul``), so residue
representations (of order 1 after the final RMSNorm) agree to float32
rounding through two layers: a few 1e-6, asserted within 2e-5; scores
(probabilities) within 1e-5 (asserted 2e-5), the tails' float32 sums over
up to 300 residues added. Against ``T5EncoderModel`` (float32 as well) the
same 2e-5. The smallest mutation moves the representation by more than
1e-2.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import prott5_reference as ref
from metagenomic_deepfri_tpu_torch import profiling
from metagenomic_deepfri_tpu_torch.batching import buckets
from metagenomic_deepfri_tpu_torch.batching import engine as engine_mod
from metagenomic_deepfri_tpu_torch.batching.engine import (BatchedPredictor,
                                                           ModelHandle)
from metagenomic_deepfri_tpu_torch.models import deepfri, esm2, prott5
from metagenomic_deepfri_tpu_torch.models.convert import (
    gcn_params_from_numpy, gcn_params_to_numpy, prott5_from_hf_state_dict)
from metagenomic_deepfri_tpu_torch.models.registry import (load_checkpoint,
                                                           load_models,
                                                           save_checkpoint)
from metagenomic_deepfri_tpu_torch.ops.attention import _bias_of, attend
from metagenomic_deepfri_tpu_torch.ops.one_hot import ALPHABET, batch_tokens
from metagenomic_deepfri_tpu_torch.synthetic import (AMINO_ACIDS,
                                                     aligned_items)

TINY = prott5.ProtT5Config(layers=2, dim=64, heads=4, d_kv=32, ffn=256)
TINY_DICT = dataclasses.asdict(TINY)
REP_TOL = 2e-5
SCORE_TOL = 2e-5
TERMS = {"bp": 9, "cc": 4, "mf": 6}
REF_CONFIG = {"t5": TINY_DICT, "contact_threshold": 6.0,
              "generated_contacts": 2, "adj_norm": "sym"}


def _config(n_labels, **kw):
    return deepfri.ProtT5GCNConfig(n_labels=n_labels, embed_dim=32,
                                   gc_dims=(16, 16, 16), fc_dims=(32,),
                                   t5=TINY, **kw)


def _trees(seed=3, modes=TERMS):
    """{mode: tree} of random GCNs on one shared encoder and embedding
    pair (one tree object, as a model set that shares them is loaded)."""
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


def _seqs(n, seed, lo=1, hi=300):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(AMINO_ACIDS),
                               size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _port(lm, seqs, bucket, rows=None):
    padded = seqs + [""] * ((rows or len(seqs)) - len(seqs))
    tokens, lengths = batch_tokens(padded, bucket)
    with torch.no_grad():
        return prott5.prott5_forward(lm, TINY, torch.from_numpy(tokens),
                                     torch.from_numpy(lengths))


def _widest(got, seqs, want):
    return max(float((got[i, :len(s)] - want[i, :len(s)]).abs().max())
               for i, s in enumerate(seqs))


# -- (a) the reference against the published implementation -------------------

def _hf_model(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    cfg = transformers.T5Config(
        vocab_size=128, d_model=64, d_kv=32, d_ff=256, num_layers=2,
        num_heads=4, relative_attention_num_buckets=32,
        relative_attention_max_distance=128, feed_forward_proj="relu",
        layer_norm_epsilon=1e-6, dropout_rate=0.0, is_encoder_decoder=False,
        use_cache=False)
    model = transformers.T5EncoderModel(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_norm" in name:
                p.copy_(0.8 + 0.4 * torch.rand(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * p.shape[-1] ** -0.5)
    return model


@pytest.mark.parametrize("copy", ["tests", "portbench"])
def test_reference_matches_transformers_t5(monkeypatch, copy):
    """Both copies of the reference (the tests' and the benchmark's, which
    decides a run's ``correct``), on weights loaded through
    ``prott5_from_hf_state_dict``, against ``transformers.T5EncoderModel``
    on the same seeded random weights (RMS scales away from 1), a padded
    batch of three rows with ``</s>`` ending each."""
    if copy == "tests":
        plain = ref
    else:
        from portbench import reference_prott5 as plain
    model = _hf_model(monkeypatch)
    config, tree = prott5_from_hf_state_dict(model.state_dict(), heads=4)
    assert config == TINY
    tree = gcn_params_from_numpy(tree, "cpu")
    seqs = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWYXBZUO" * 8, "GG"]
    ids, real = plain._tokens(seqs, "cpu")
    with torch.no_grad():
        hf = model(input_ids=ids,
                   attention_mask=real.long()).last_hidden_state
        got = plain.trunk(tree, TINY_DICT, seqs, "cpu",
                          plain.reference.exact)
    assert _widest(got, seqs, hf) < REP_TOL


def test_converter_reads_the_published_layout(monkeypatch):
    """Every leaf of the converted tree is the state dict's weight,
    transposed to (in, out), q | k | v side by side; the bias table is
    block 0's."""
    model = _hf_model(monkeypatch)
    state = model.state_dict()
    _, tree = prott5_from_hf_state_dict(state, heads=4)
    a = "encoder.block.1.layer.0.SelfAttention."
    np.testing.assert_array_equal(
        tree["layers"][1]["qkv"]["kernel"],
        torch.cat([state[a + n + ".weight"].T for n in "qkv"], 1).numpy())
    np.testing.assert_array_equal(tree["layers"][1]["o"]["kernel"],
                                  state[a + "o.weight"].T.numpy())
    np.testing.assert_array_equal(
        tree["rel_bias"], state["encoder.block.0.layer.0.SelfAttention."
                                "relative_attention_bias.weight"].numpy())
    np.testing.assert_array_equal(
        tree["layers"][0]["wo"]["kernel"],
        state["encoder.block.0.layer.1.DenseReluDense.wo.weight"].T.numpy())
    with pytest.raises(KeyError):
        prott5_from_hf_state_dict(
            {k: v for k, v in state.items() if "final_layer_norm" not in k},
            heads=4)


# -- (b) the bucket table -----------------------------------------------------

def test_buckets_match_transformers(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    bucket = transformers.models.t5.modeling_t5.T5Attention.\
        _relative_position_bucket
    rel = torch.arange(-1024, 1025)
    want = bucket(rel, bidirectional=True, num_buckets=32, max_distance=128)
    assert torch.equal(prott5.relative_position_bucket(rel, 32, 128), want)
    assert torch.equal(ref.bucket(rel, 32, 128), want)
    from portbench import reference_prott5
    assert torch.equal(reference_prott5.bucket(rel, 32, 128), want)


@pytest.mark.parametrize("distance,row", [(0, 0), (-1, 1), (1, 17), (-8, 8),
                                          (8, 24), (-127, 15), (-128, 15),
                                          (1000, 31), (-1000, 15), (7, 23)])
def test_bucket_anchors(distance, row):
    rel = torch.tensor([distance])
    assert int(prott5.relative_position_bucket(rel)[0]) == row
    assert int(ref.bucket(rel, 32, 128)[0]) == row


def test_position_bias_kept_per_length_and_remade_when_changed():
    """The bias's bucket table is made once for each length and device;
    the bias it gives with R is today's (H, T, T) gather, and reads R as it
    is at each call, so a changed R shows at once."""
    lm = _trees()["mf"]["lm"]
    first = prott5.distance_buckets(TINY, 40, "cpu")
    assert prott5.distance_buckets(TINY, 40, "cpu") is first
    assert prott5.distance_buckets(TINY, 41, "cpu") is not first
    assert first.dtype == torch.int8 and first.shape == (79,)
    pos = torch.arange(40)
    rows = prott5.relative_position_bucket(pos[None, :] - pos[:, None])
    bias = _bias_of((lm["rel_bias"], first), 40, torch.float32)
    assert torch.equal(bias, lm["rel_bias"][rows].permute(2, 0, 1))
    rel = lm["rel_bias"].clone()
    before = _bias_of((rel, first), 40, torch.float32)
    rel.mul_(2.0)
    after = _bias_of((rel, first), 40, torch.float32)
    assert torch.equal(after, 2.0 * before)


# -- (c) the port's trunk and predict_stream ----------------------------------

@pytest.mark.parametrize("bucket,rows", [(128, 3), (256, 5), (512, 8),
                                         (1024, 4)])
def test_trunk_matches_reference_any_bucket_and_batch(bucket, rows):
    """Every row of a padded batch (empty padding rows among them) is
    finite and equals the reference."""
    lm = _trees()["mf"]["lm"]
    seqs = _seqs(3, seed=bucket, hi=min(300, bucket))
    got = _port(lm, seqs, bucket, rows)
    assert got.shape == (rows, bucket, TINY.dim)
    assert torch.isfinite(got).all()
    with torch.no_grad():
        want = ref.trunk(lm, TINY_DICT, seqs, "cpu", ref.reference.exact)
    assert _widest(got, seqs, want) < REP_TOL


def _reference_scores(trees, items):
    proteins = [(seq, coords, ins) for _, seq, coords, ins in items]
    with torch.no_grad():
        got = ref.gcn_block(trees, REF_CONFIG, proteins, "cpu")
    return {m: {it[0]: s[i].double().numpy() for i, it in enumerate(items)}
            for m, s in got.items()}


@pytest.mark.parametrize("modes", [("bp", "cc", "mf"), ("mf",)])
def test_predict_stream_matches_reference(modes):
    """Three modes in the shared-trunk step, and one mode alone: every
    protein's scores equal the reference's."""
    trees = _trees()
    engine = _engine({m: trees[m] for m in modes})
    items = aligned_items(12, seed=5, min_len=20, max_len=300)
    got = {m: {} for m in modes}

    def collect(part):
        for m in modes:
            got[m].update(part[m])

    assert engine.predict_stream(iter(items), modes=list(modes),
                                 result_cb=collect) == len(items)
    if len(modes) > 1:
        assert engine._multi_key(list(modes))
    want = _reference_scores({m: trees[m] for m in modes}, items)
    for m in modes:
        for item in items:
            np.testing.assert_allclose(got[m][item[0]], want[m][item[0]],
                                       rtol=0, atol=SCORE_TOL)


# -- (d) batch-mates and padding ----------------------------------------------

def test_rows_do_not_depend_on_batch_mates_or_padding():
    """A protein alone in the smallest bucket, beside others in a larger
    one, and among padding rows: the same representation."""
    lm = _trees()["mf"]["lm"]
    seqs = _seqs(4, seed=11, lo=30, hi=120)
    alone = _port(lm, seqs[:1], 128)
    crowd = _port(lm, seqs[::-1], 512, rows=8)
    n = len(seqs[0])
    assert (alone[0, :n] - crowd[3, :n]).abs().max() < 1e-5


# -- (e) mutations miss the reference -----------------------------------------

def _unscaled_attend(q, k, v, n, bias, counts):
    return attend(q * q.shape[-1] ** -0.5, k, v, n, "model/t5/sdpa", bias,
                  counts)


def _layer_norm(p, x, eps, dtype):
    return F.layer_norm(x, x.shape[-1:], p["scale"].to(dtype), None, eps)


def _no_position_bias(rel_bias, config, T):
    return (torch.zeros_like(rel_bias),
            prott5.distance_buckets(config, T, rel_bias.device))


@pytest.mark.parametrize("name,mutant", [
    ("_attn_bias", _no_position_bias), ("_attend", _unscaled_attend),
    ("_rms", _layer_norm)], ids=["no_bias", "scaled", "layernorm"])
def test_mutations_miss_the_reference(monkeypatch, name, mutant):
    lm = _trees()["mf"]["lm"]
    seqs = _seqs(3, seed=12, lo=150, hi=300)
    with torch.no_grad():
        want = ref.trunk(lm, TINY_DICT, seqs, "cpu", ref.reference.exact)
    assert _widest(_port(lm, seqs, 512), seqs, want) < REP_TOL
    monkeypatch.setattr(prott5, name, mutant)
    assert _widest(_port(lm, seqs, 512), seqs, want) > 1e-2


# -- (f) spans and counters ---------------------------------------------------

def test_trunk_spans_and_counters():
    """``model/lm`` counts Σ(n+1) tokens, B·T slots and Σ(n+1)² pairs over
    the batch's proteins; ``model/t5/bias`` once a batch; every layer has
    its ``model/t5/attn`` (with ``model/t5/sdpa`` inside it) and
    ``model/t5/ffn`` spans, and four ``model/t5/gemm`` (qkv and o in the
    attention, wi and wo in the feed-forward)."""
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
    n = [len(it[1]) + 1 for it in items]
    assert len(lm) == 1
    assert lm[0].counts == {"tokens": sum(n), "slots": 16 * 129,
                            "attn_pairs": sum(v * v for v in n)}
    by = {name: [s for s in got if s.name == name]
          for name in ("model/t5/attn", "model/t5/sdpa", "model/t5/ffn",
                       "model/t5/bias", "model/t5/gemm")}
    assert len(by["model/t5/bias"]) == 1
    assert by["model/t5/bias"][0].parent == lm[0].id
    assert all(len(by[k]) == TINY.layers
               for k in ("model/t5/attn", "model/t5/sdpa", "model/t5/ffn"))
    attn = {s.id for s in by["model/t5/attn"]}
    ffn = {s.id for s in by["model/t5/ffn"]}
    assert all(s.parent in attn for s in by["model/t5/sdpa"])
    gemm = by["model/t5/gemm"]
    assert len(gemm) == 4 * TINY.layers
    d, f, inner, rows = TINY.dim, TINY.ffn, TINY.inner, 16 * 129
    want = [(attn, d, 3 * inner), (attn, inner, d), (ffn, d, f),
            (ffn, f, d)] * TINY.layers
    for s, (parents, k, nn) in zip(gemm, want):
        assert s.parent in parents
        assert s.counts == {"rows": rows, "k": k, "n": nn, "split": 0}
    assert not [s for s in got if s.name.startswith("model/esm/")]


# -- (g) checkpoints and the registry -----------------------------------------

def test_checkpoint_round_trip(tmp_path):
    """The sidecar names the encoder's widths under ``t5``; the tree comes
    back leaf for leaf."""
    cfg, tree = _config(6), gcn_params_to_numpy(_trees()["mf"])
    save_checkpoint(tmp_path / "gcn_mf.npz", cfg, tree)
    side = json.loads((tmp_path / "gcn_mf_config.json").read_text())
    assert side["__class__"] == "ProtT5GCNConfig"
    assert side["t5"]["d_kv"] == 32 and side["t5"]["layers"] == 2
    got_cfg, got = load_checkpoint(tmp_path / "gcn_mf.npz")
    assert got_cfg == cfg
    flat = dict(engine_mod._tree_leaves(tree))
    assert flat.keys() == dict(engine_mod._tree_leaves(got)).keys()
    for path, leaf in engine_mod._tree_leaves(got):
        np.testing.assert_array_equal(leaf, flat[path])


def test_load_models_from_native_checkpoints(tmp_path):
    """A weights folder of native ProtT5 GCN checkpoints loads through the
    registry, shares its encoder across the modes, and scores as the
    reference."""
    trees = _trees()
    names = {"gcn": {}, "cnn": {}}
    for m, tree in trees.items():
        terms = [f"GO:{i:07d}" for i in range(TERMS[m])]
        save_checkpoint(tmp_path / f"gcn_{m}.npz", _config(TERMS[m]),
                        gcn_params_to_numpy(tree))
        (tmp_path / f"gcn_{m}_model_params.json").write_text(json.dumps(
            {"goterms": terms, "gonames": [f"term {t}" for t in terms]}))
        names["gcn"][m] = f"gcn_{m}.npz"
    (tmp_path / "model_config.json").write_text(json.dumps(
        {**names, "version": "1.1"}))
    gcn, _, _ = load_models(tmp_path, ["bp", "cc", "mf"])
    assert all(h.config.t5 == TINY for h in gcn.values())
    engine = BatchedPredictor(gcn, device="cpu")
    assert "lm" in engine._gcn_shared[0]
    items = aligned_items(5, seed=10, min_len=30, max_len=90)
    got = engine.predict_gcn_from_coords(items)
    want = _reference_scores(trees, items)
    for m in gcn:
        for item in items:
            np.testing.assert_allclose(got[m][item[0]], want[m][item[0]],
                                       rtol=0, atol=SCORE_TOL)


# -- (h) the token-slot batch rule --------------------------------------------

def _steady(config, devices="cpu"):
    tree = deepfri.init_gcn(config, torch.Generator().manual_seed(1), "cpu")
    return BatchedPredictor({"mf": ModelHandle("gcn", "mf", config, tree)},
                            device=devices)


@pytest.mark.parametrize("trunk", ["esm2", "prott5"])
@pytest.mark.parametrize("bucket,rows", [(128, 256), (256, 128), (512, 64),
                                         (1024, 32), (2048, 16)])
def test_token_slot_rule_of_both_trunks(trunk, bucket, rows):
    """The engine batches a GCN whose config names a transformer trunk by
    token slots: 32,768 for ESM-2 and ProtT5 alike."""
    if trunk == "esm2":
        config = deepfri.ESMGCNConfig(
            n_labels=3, embed_dim=16, gc_dims=(8,), fc_dims=(8,),
            esm=esm2.ESM2Config(layers=1, dim=16, heads=2, ffn=32))
    else:
        config = deepfri.ProtT5GCNConfig(
            n_labels=3, embed_dim=16, gc_dims=(8,), fc_dims=(8,),
            t5=prott5.ProtT5Config(layers=1, dim=16, heads=2, d_kv=8,
                                   ffn=32))
    assert deepfri.trunk_of(config) is not None
    assert _steady(config)._steady_batch(bucket) == rows
    assert _steady(config, "cpu,cpu")._steady_batch(bucket) == 2 * rows
    assert buckets.esm_batch_size(bucket) == rows
    assert _steady(config)._steady_batch(bucket, "cnn") == \
        buckets.cnn_batch_size(bucket)


def test_lstm_configs_keep_gcn_batch_size():
    cfg = deepfri.GCNConfig(n_labels=3, lm_hidden=8, lm_layers=1,
                            embed_dim=16, gc_dims=(8,), fc_dims=(8,))
    assert deepfri.trunk_of(cfg) is None
    engine = _steady(cfg)
    assert not engine._transformer_trunk
    assert [engine._steady_batch(b) for b in (128, 512, 1024)] == [
        buckets.gcn_batch_size(b) for b in (128, 512, 1024)]


# -- the vocabulary -----------------------------------------------------------

def test_vocabulary_table():
    assert prott5.T5_VOCAB == ref.T5_VOCAB
    assert [prott5.T5_VOCAB[i] for i in prott5.PORT_TO_T5] == [
        {"U": "X", "Z": "X", "O": "X", "B": "X", "-": "<unk>"}.get(c, c)
        for c in ALPHABET]
    tokens, lengths = batch_tokens(["MKV", ""], 4)
    ids = prott5.prott5_tokens(torch.from_numpy(tokens),
                               torch.from_numpy(lengths))
    assert ids.tolist() == [[19, 14, 6, 1, 0], [1, 0, 0, 0, 0]]


def test_init_scales_are_t5s():
    """The random encoder's standard deviations are T5's: unscaled q·kᵀ
    logits of order 1, not the softmax-saturating ones of Glorot scales."""
    cfg = prott5.ProtT5Config(layers=1, dim=256, heads=8, d_kv=64, ffn=1024)
    tree = prott5.init_prott5(cfg, torch.Generator().manual_seed(4), "cpu")
    p = tree["layers"][0]
    inner = cfg.inner
    q = p["qkv"]["kernel"][:, :inner]
    k = p["qkv"]["kernel"][:, inner:2 * inner]
    for got, want in ((q, (cfg.dim * cfg.d_kv) ** -0.5), (k, cfg.dim ** -0.5),
                      (p["o"]["kernel"], inner ** -0.5),
                      (p["wi"]["kernel"], cfg.dim ** -0.5),
                      (p["wo"]["kernel"], cfg.ffn ** -0.5),
                      (tree["rel_bias"], cfg.dim ** -0.5),
                      (tree["embed"], 1.0)):
        assert float(got.std()) == pytest.approx(want, rel=0.1)
    scale = p["ln1"]["scale"]
    assert float(scale.min()) > 0.8 and float(scale.max()) < 1.2
    x = torch.randn(50, cfg.dim)
    logits = (x @ q).view(50, cfg.heads, -1)[:, 0] @ \
        (x @ k).view(50, cfg.heads, -1)[:, 0].T
    assert 0.5 < float(logits.std()) < 2.0
    assert math.isclose(cfg.inner, 512)
