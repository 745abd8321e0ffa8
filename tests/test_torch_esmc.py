"""ESM C as the GCN's residue-LM trunk, on the CPU at a small size: d 128,
2 heads of 64, SwiGLU width 512 (``swiglu_correction_fn``'s for d 128), at
2 and 3 layers, so that the residual scale √(layers/36) is not 1 and the
division it asks for is exercised; lengths up to 300.

The plain reference is the benchmark's own (``portbench/reference_esmc.py``,
``nn.Module``s named as the ``esm`` package names them; no copy here). The
port's trunk and ``predict_stream`` on the shared-trunk step are held to it;
three mutations of the port (q's and k's LayerNorms dropped, SwiGLU's halves
swapped, the residual scale left out) each miss it. Also: E1's gated
epilogue on interleaved planes, independence from batch-mates and padding,
spans and counters, the converter of the ``esm`` key layout, checkpoints
and the registry, the token-slot batch rule, and the reference's rotary
against ``transformers``' ESM rotary.

Tolerances: the port and the reference are free to compute in other
orders (E2's twin against the reference's masked softmax, ``torch.mm``
against ``torch.matmul``), so residue representations (of order 1 after the
final LayerNorm) are held to float32 rounding through three layers whose
branches the residual scale multiplies by up to 4.2: within 2e-5 (on this
CPU build the two agree to the bit); scores (probabilities) within 2e-5,
the tails' float32 sums over up to 300 residues added. In float64 other
orders would differ by float64 rounding, ~1e-14: asserted within 1e-10.
The smallest mutation moves the representation by more than 1e-2.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from metagenomic_deepfri_tpu_torch import profiling
from metagenomic_deepfri_tpu_torch.batching import buckets
from metagenomic_deepfri_tpu_torch.batching.engine import (BatchedPredictor,
                                                           ModelHandle)
from metagenomic_deepfri_tpu_torch.batching import engine as engine_mod
from metagenomic_deepfri_tpu_torch.models import deepfri, esm2, esmc, prott5
from metagenomic_deepfri_tpu_torch.models.convert import (
    esmc_from_state_dict, gcn_params_from_numpy, gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.models.registry import (load_checkpoint,
                                                           load_models,
                                                           save_checkpoint)
from metagenomic_deepfri_tpu_torch.ops import esm_gemm as eg
from metagenomic_deepfri_tpu_torch.ops.one_hot import ALPHABET, batch_tokens
from metagenomic_deepfri_tpu_torch.synthetic import (AMINO_ACIDS,
                                                     aligned_items)
from portbench import reference_esmc as ref

SMALL = {n: esmc.ESMCConfig(layers=n, dim=128, heads=2, ffn=512)
         for n in (2, 3)}
TINY = SMALL[2]
REP_TOL = {torch.float32: 2e-5, torch.float64: 1e-10}
SCORE_TOL = 2e-5
TERMS = {"bp": 9, "cc": 4, "mf": 6}


def _dict(cfg):
    return dataclasses.asdict(cfg)


def _config(n_labels, trunk=TINY, **kw):
    return deepfri.ESMCGCNConfig(n_labels=n_labels, embed_dim=32,
                                 gc_dims=(16, 16, 16), fc_dims=(32,),
                                 esmc=trunk, **kw)


def _trees(seed=3, modes=TERMS, trunk=TINY):
    """{mode: tree} of random GCNs on one shared trunk and embedding pair
    (one tree object, as a model set that shares them is loaded)."""
    gen = torch.Generator().manual_seed(seed)
    base = deepfri.init_gcn(_config(1, trunk), gen, "cpu")
    out = {}
    for m, n in modes.items():
        tree = deepfri.init_gcn(_config(n, trunk), gen, "cpu")
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


def _port(lm, seqs, bucket, rows=None, cfg=TINY, dtype=torch.float32):
    padded = seqs + [""] * ((rows or len(seqs)) - len(seqs))
    tokens, lengths = batch_tokens(padded, bucket)
    with torch.no_grad():
        return esmc.esmc_forward(lm, cfg, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths), dtype)


def _reference(lm, seqs, cfg=TINY, dtype=torch.float32):
    tree = gcn_params_from_numpy(lm, "cpu", dtype)
    with torch.no_grad():
        return ref.trunk(tree, _dict(cfg), seqs, "cpu", ref.reference.exact)


def _widest(got, seqs, want):
    return max(float((got[i, :len(s)] - want[i, :len(s)]).abs().max())
               for i, s in enumerate(seqs))


# -- (a) the port's trunk against the reference -------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("layers", [2, 3])
def test_trunk_matches_reference(layers, dtype):
    """A padded batch of three proteins (an empty padding row among the
    rows) in float32 and float64: every real position equals the
    reference's within the dtype's tolerance."""
    cfg = SMALL[layers]
    lm = _trees(trunk=cfg)["mf"]["lm"]
    seqs = _seqs(3, seed=layers, hi=300)
    got = _port(lm, seqs, 512, rows=4, cfg=cfg, dtype=dtype)
    assert got.dtype == dtype and got.shape == (4, 512, cfg.dim)
    want = _reference(lm, seqs, cfg, dtype)
    assert cfg.residual_scale == pytest.approx(math.sqrt(layers / 36))
    assert _widest(got, seqs, want) < REP_TOL[dtype]


@pytest.mark.parametrize("bucket,rows", [(128, 3), (256, 5), (1024, 4)])
def test_padding_rows_finite_any_bucket(bucket, rows):
    """Every position of every row of a padded batch, empty padding rows
    among them, is finite, and the real ones equal the reference."""
    lm = _trees()["mf"]["lm"]
    seqs = _seqs(2, seed=bucket, hi=min(300, bucket))
    got = _port(lm, seqs, bucket, rows)
    assert got.shape == (rows, bucket, TINY.dim)
    assert torch.isfinite(got).all()
    assert _widest(got, seqs, _reference(lm, seqs)) < REP_TOL[torch.float32]


def test_rows_do_not_depend_on_batch_mates_or_padding():
    """A protein alone in the smallest bucket, beside others in a larger
    one, and among padding rows: the same representation."""
    lm = _trees()["mf"]["lm"]
    seqs = _seqs(4, seed=11, lo=30, hi=120)
    alone = _port(lm, seqs[:1], 128)
    crowd = _port(lm, seqs[::-1], 512, rows=8)
    n = len(seqs[0])
    assert (alone[0, :n] - crowd[3, :n]).abs().max() < 1e-5


# -- (b) mutations miss the reference -----------------------------------------

def _no_qk_norm(p, q, k, config, cos, sin, tokens, dtype):
    B, T, _ = q.shape
    H, hd = config.heads, config.head_dim

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    return (esm2._rotate(heads(q), cos, sin) * hd ** -0.5,
            esm2._rotate(heads(k), cos, sin))


def _gate_last(p, x, dtype, span, epilogue="bias", residual=None):
    if epilogue != "swiglu":
        return eg.project(p, x, dtype, span, epilogue, residual)
    a, b = eg.project(p, x, dtype, span).chunk(2, dim=-1)
    return F.silu(b) * a


def _unscaled(p, h, x, s, dtype):
    return eg.project(p, h, dtype, esmc.GEMM_SPAN, "residual", x)


@pytest.mark.parametrize("name,mutant", [
    ("_qk", _no_qk_norm), ("project", _gate_last),
    ("_residual", _unscaled)], ids=["no_qk_norm", "gate_last", "unscaled"])
def test_mutations_miss_the_reference(monkeypatch, name, mutant):
    lm = _trees()["mf"]["lm"]
    seqs = _seqs(3, seed=12, lo=150, hi=300)
    want = _reference(lm, seqs)
    assert _widest(_port(lm, seqs, 512), seqs, want) < REP_TOL[torch.float32]
    monkeypatch.setattr(esmc, name, mutant)
    assert _widest(_port(lm, seqs, 512), seqs, want) > 1e-2


# -- (c) predict_stream on the shared-trunk step ------------------------------

def _reference_scores(trees, items):
    proteins = [(seq, coords, ins) for _, seq, coords, ins in items]
    config = {"esmc": _dict(TINY), "contact_threshold": 6.0,
              "generated_contacts": 2, "adj_norm": "sym"}
    with torch.no_grad():
        got = ref.gcn_block(trees, config, proteins, "cpu")
    return {m: {it[0]: s[i].double().numpy() for i, it in enumerate(items)}
            for m, s in got.items()}


@pytest.mark.parametrize("modes", [("bp", "cc", "mf"), ("mf",)])
def test_predict_stream_matches_reference(modes):
    """Three modes in the shared-trunk step, and one mode alone: every
    protein's scores equal the reference's."""
    trees = _trees()
    engine = _engine({m: trees[m] for m in modes})
    items = aligned_items(10, seed=5, min_len=20, max_len=300)
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


# -- (d) spans and counters ---------------------------------------------------

def test_trunk_spans_and_counters():
    """``model/lm`` counts Σ(n+2) tokens, B·T slots and Σ(n+2)² pairs over
    the batch's proteins; every layer has its ``model/esmc/attn`` (with
    ``model/esmc/qkln``, counting the real tokens, and ``model/esmc/sdpa``
    inside it) and ``model/esmc/ffn``, and four ``model/esmc/gemm`` (qkv
    and out in the attention, fc1 and fc2 in the feed-forward), ``n`` the
    columns each product computes (2F for the gated fc1)."""
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
    rows = 16   # ten proteins, one straggler batch of 16 rows at bucket 128
    assert len(lm) == 1
    assert lm[0].counts == {"tokens": sum(n), "slots": rows * 130,
                            "attn_pairs": sum(v * v for v in n)}
    by = {name: [s for s in got if s.name == name]
          for name in ("model/esmc/attn", "model/esmc/qkln",
                       "model/esmc/sdpa", "model/esmc/ffn",
                       "model/esmc/gemm")}
    assert all(len(by[k]) == TINY.layers for k in (
        "model/esmc/attn", "model/esmc/qkln", "model/esmc/sdpa",
        "model/esmc/ffn"))
    attn = {s.id for s in by["model/esmc/attn"]}
    ffn = {s.id for s in by["model/esmc/ffn"]}
    assert all(s.parent in attn for s in by["model/esmc/sdpa"])
    assert all(s.parent in attn and s.counts == {"tokens": sum(n)}
               for s in by["model/esmc/qkln"])
    gemm = by["model/esmc/gemm"]
    assert len(gemm) == 4 * TINY.layers
    d, f = TINY.dim, TINY.ffn
    want = [(attn, d, 3 * d), (attn, d, d), (ffn, d, 2 * f),
            (ffn, f, d)] * TINY.layers
    for s, (parents, k, nn) in zip(gemm, want):
        assert s.parent in parents
        assert s.counts == {"rows": rows * 130, "k": k, "n": nn, "split": 0}
    assert not [s for s in got if s.name.startswith(("model/esm/",
                                                     "model/t5/"))]


# -- (e) E1's gated epilogue on the CPU ----------------------------------------

@pytest.mark.parametrize("F_", [64, 100, 3 * 64 + 1])
def test_interleaved_swiglu_planes_are_the_plain_gated_product(F_):
    """The kernel's layout: W's gate and up columns interleaved in blocks
    of 64 (zero-padded to whole blocks), each 128-column tile's product
    paired column j with j + 64 (:func:`swiglu_tiles`), is ``silu(a)·b``
    of the plain twin on the un-interleaved kernel: bit for bit where F
    fills whole blocks, else within float32 rounding (the CPU's matmul may
    sum a column in another order at another width: 6e-8 here, against
    the 1e-2 of a gate paired with the wrong up column)."""
    gen = torch.Generator().manual_seed(F_)
    x = torch.randn(37, 96, generator=gen)
    w = torch.randn(96, 2 * F_, generator=gen) * 96 ** -0.5
    planes = eg.weight_planes(w, "swiglu")
    Fp = -(-F_ // 64) * 64
    assert planes.shape == (3, 2 * Fp, 96)
    assert eg.weight_planes(w, "swiglu") is planes
    assert eg.weight_planes(w) is not planes
    got = eg.swiglu_tiles(eg.esm_gemm_ref(x, planes, None), F_)
    want = eg.esm_gemm_ref(x, eg.split_planes(w), None, "swiglu")
    assert got.shape == want.shape == (37, F_)
    if F_ % 64 == 0:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    base = eg.esm_gemm_ref(x, eg.split_planes(w), None)
    assert torch.equal(want, F.silu(base[:, :F_]) * base[:, F_:])
    inter = eg.interleave_swiglu(w)
    assert torch.equal(inter[:, :64], F.pad(w[:, :F_], (0, Fp - F_))[:, :64])
    assert torch.equal(inter[:, 64:128],
                       F.pad(w[:, F_:], (0, Fp - F_))[:, :64])


# -- (f) the reference: its key layout, its rotary, the converter ---------------

def test_reference_state_dict_keys_are_the_esm_packages():
    model = ref.ESMC(128, 2, 3, 512)
    assert list(model.state_dict()) == ref.state_keys(3)
    names = {k.split("blocks.0.", 1)[1] for k in ref.state_keys(1)
             if "blocks.0." in k}
    assert names == {
        "attn.layernorm_qkv.0.weight", "attn.layernorm_qkv.0.bias",
        "attn.layernorm_qkv.1.weight", "attn.q_ln.weight",
        "attn.k_ln.weight", "attn.out_proj.weight", "ffn.0.weight",
        "ffn.0.bias", "ffn.1.weight", "ffn.3.weight"}
    assert set(ref.state_keys(1)) - {f"transformer.blocks.0.{k}"
                                     for k in names} == {
        "embed.weight", "transformer.norm.weight"}
    assert ref.ESMC(1152, 18, 1).transformer.blocks[0].ffn[3].in_features \
        == 3072


def test_reference_rotary_matches_transformers_esm(monkeypatch):
    """The reference's rotary on q and k of heads of 64 against
    ``transformers``' ESM rotary embedding (rotate_half, the frequencies
    repeated, base 10,000), bit for bit; the port's rotary is ESM-2's."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    rotary = transformers.models.esm.modeling_esm.RotaryEmbedding(dim=64)
    gen = torch.Generator().manual_seed(9)
    q = torch.randn(2, 3, 77, 64, generator=gen)
    k = torch.randn(2, 3, 77, 64, generator=gen)
    want_q, want_k = rotary(q, k)
    assert torch.equal(ref.rotary(q), want_q)
    assert torch.equal(ref.rotary(k), want_k)
    cos, sin = esm2._rotary(77, 64, 10000.0, "cpu", torch.float32)
    assert torch.equal(esm2._rotate(q, cos, sin), want_q)


def _random_reference(seed=21):
    model = ref.ESMC(128, 2, 2, 512)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "ln" in name or "norm" in name or ".0." in name:
                p.copy_(0.8 + 0.4 * torch.rand(p.shape, generator=gen)
                        if name.endswith("weight")
                        else 0.2 * torch.rand(p.shape, generator=gen) - 0.1)
            else:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * p.shape[-1] ** -0.5)
    return model.eval()


def test_converter_reads_the_esm_layout():
    """A state dict of the reference module converts to the port's tree:
    every kernel the state dict's weight transposed, ``[q | k | v]`` and
    ``[gate | up]`` in their order, the widths from the shapes, heads of 64
    by default; the port on that tree equals the module."""
    model = _random_reference()
    state = {**model.state_dict(), "sequence_head.0.weight": torch.ones(3)}
    cfg, tree = esmc_from_state_dict(state)
    assert cfg == TINY
    b = "transformer.blocks.1."
    np.testing.assert_array_equal(
        tree["layers"][1]["qkv"]["kernel"],
        state[b + "attn.layernorm_qkv.1.weight"].T.numpy())
    np.testing.assert_array_equal(tree["layers"][1]["fc1"]["kernel"],
                                  state[b + "ffn.1.weight"].T.numpy())
    np.testing.assert_array_equal(tree["layers"][1]["k_ln"]["scale"],
                                  state[b + "attn.k_ln.weight"].numpy())
    assert "bias" not in tree["layers"][0]["q_ln"]
    assert "bias" not in tree["ln_final"]
    lm = gcn_params_from_numpy(tree, "cpu")
    seqs = _seqs(3, seed=22, hi=200)
    ids, real = ref._tokens(seqs, "cpu")
    with torch.no_grad():
        want = model(ids, real)[:, 1:-1]
    assert _widest(_port(lm, seqs, 256), seqs, want) < REP_TOL[torch.float32]
    with pytest.raises(KeyError):
        esmc_from_state_dict({k: v for k, v in state.items()
                              if k != "transformer.norm.weight"})


def test_vocabulary_is_esm2s():
    assert ref.ESM_VOCAB[:31] == esm2.ESM_ALPHABET[:31]
    assert ref.ESM_VOCAB[31:] == ("|", "<mask>")
    assert [ref.ESM_VOCAB[i] for i in esm2.PORT_TO_ESM] == list(ALPHABET)


# -- (g) checkpoints, the registry and the dispatch table -----------------------

def test_checkpoint_round_trip(tmp_path):
    """The sidecar names the trunk's widths under ``esmc``; the config and
    the tree come back leaf for leaf."""
    cfg, tree = _config(6), gcn_params_to_numpy(_trees()["mf"])
    save_checkpoint(tmp_path / "gcn_mf.npz", cfg, tree)
    side = json.loads((tmp_path / "gcn_mf_config.json").read_text())
    assert side["__class__"] == "ESMCGCNConfig"
    assert side["esmc"]["ffn"] == 512 and side["esmc"]["layers"] == 2
    got_cfg, got = load_checkpoint(tmp_path / "gcn_mf.npz")
    assert got_cfg == cfg and isinstance(got_cfg.esmc, esmc.ESMCConfig)
    flat = dict(engine_mod._tree_leaves(tree))
    assert flat.keys() == dict(engine_mod._tree_leaves(got)).keys()
    for path, leaf in engine_mod._tree_leaves(got):
        np.testing.assert_array_equal(leaf, flat[path])


def test_load_models_from_native_checkpoints(tmp_path):
    """A weights folder of native ESM C GCN checkpoints loads through the
    registry, shares its trunk across the modes, and scores as the
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
    assert all(h.config.esmc == TINY for h in gcn.values())
    engine = BatchedPredictor(gcn, device="cpu")
    assert "lm" in engine._gcn_shared[0]
    items = aligned_items(5, seed=10, min_len=30, max_len=90)
    got = engine.predict_gcn_from_coords(items)
    want = _reference_scores(trees, items)
    for m in gcn:
        for item in items:
            np.testing.assert_allclose(got[m][item[0]], want[m][item[0]],
                                       rtol=0, atol=SCORE_TOL)


def test_one_table_dispatches_every_trunk():
    """ESM-2, ProtT5 and ESM C go through :data:`deepfri.TRUNKS`: each GCN
    config class names its widths' field, and ``trunk_of`` reads it."""
    assert set(deepfri.TRUNKS) == {deepfri.ESMGCNConfig,
                                   deepfri.ProtT5GCNConfig,
                                   deepfri.ESMCGCNConfig}
    widths = {deepfri.ESMGCNConfig: esm2.ESM2Config(layers=1, dim=16,
                                                    heads=2, ffn=32),
              deepfri.ProtT5GCNConfig: prott5.ProtT5Config(
                  layers=1, dim=16, heads=2, d_kv=8, ffn=32),
              deepfri.ESMCGCNConfig: esmc.ESMCConfig(layers=1, dim=128,
                                                     heads=2, ffn=64)}
    for cls, w in widths.items():
        trunk = deepfri.TRUNKS[cls]
        cfg = cls(n_labels=3, embed_dim=16, gc_dims=(8,), fc_dims=(8,),
                  **{trunk.field: w})
        assert isinstance(w, trunk.widths)
        assert deepfri.trunk_of(cfg) is w
        tree = deepfri.init_gcn(cfg, torch.Generator().manual_seed(2), "cpu")
        assert tree["lm_embed"]["kernel"].shape == (w.dim, 16)
        tokens, lengths = batch_tokens(["MKVL", ""], 8)
        with torch.no_grad():
            out = deepfri.gcn_forward(tree, cfg, torch.from_numpy(tokens),
                                      torch.ones(2, 8, 8),
                                      torch.from_numpy(lengths))
        assert out.shape == (2, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("bucket,rows", [(128, 256), (256, 128), (512, 64),
                                         (1024, 32), (2048, 16)])
def test_token_slot_batch_of_an_esmc_mode(bucket, rows):
    """The engine batches a GCN with an ESM C trunk by token slots, as it
    does ESM-2's and ProtT5's: 32,768 a batch, times the devices."""
    cfg = _config(3)
    tree = deepfri.init_gcn(cfg, torch.Generator().manual_seed(1), "cpu")

    def engine(devices):
        return BatchedPredictor({"mf": ModelHandle("gcn", "mf", cfg, tree)},
                                device=devices)

    one = engine("cpu")
    assert one._transformer_trunk
    assert one._steady_batch(bucket) == rows == buckets.esm_batch_size(bucket)
    assert engine("cpu,cpu")._steady_batch(bucket) == 2 * rows
    assert one._steady_batch(bucket, "cnn") == buckets.cnn_batch_size(bucket)


def test_init_draws_away_from_identity():
    """LayerNorm scales in (0.8, 1.2), shifts in ±0.1, none on q_ln, k_ln
    and the final norm; Glorot kernels; fc1 (d, 2F); the embedding 64
    rows at the published widths."""
    cfg = esmc.ESMCConfig(layers=1, dim=256, heads=4, ffn=512)
    tree = esmc.init_esmc(cfg, torch.Generator().manual_seed(4), "cpu")
    p = tree["layers"][0]
    assert p["fc1"]["kernel"].shape == (256, 1024)
    assert set(p["q_ln"]) == set(p["k_ln"]) == set(tree["ln_final"]) == {
        "scale"}
    for norm in (p["ln_qkv"], p["q_ln"], p["ln_ffn"], tree["ln_final"]):
        assert 0.8 <= float(norm["scale"].min()) < 0.85
        assert 1.15 < float(norm["scale"].max()) <= 1.2
    assert 0.09 < float(p["ln_ffn"]["bias"].abs().max()) <= 0.1
    assert float(p["fc2"]["kernel"].abs().max()) <= math.sqrt(6 / 768)
    assert esmc.ESMCConfig().vocab == 64 and esmc.ESMCConfig().head_dim == 64
    assert esmc.ESMCConfig().residual_scale == 1.0
