"""The shared-trunk multi-mode GCN step of the port against the JAX package.

Tolerances: float32 scores atol 1e-5 against JAX and 1e-6 against the port's
own per-mode ``gcn_forward`` (the same ops, the LM once instead of once per
mode); bfloat16 atol 2e-3 against JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metagenomic_deepfri_tpu.batching import engine as jax_engine
from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu.ops.cmap_align import \
    aligned_contacts_from_coords as jax_aligned_contacts
from metagenomic_deepfri_tpu_torch.batching import engine
from metagenomic_deepfri_tpu_torch.models import deepfri
from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_from_numpy
from metagenomic_deepfri_tpu_torch.synthetic import aligned_items, contact_batch

SMALL = dict(lm_hidden=8, lm_layers=2, embed_dim=16, gc_dims=(8, 12),
             fc_dims=(16,))
LABELS = {"bp": 7, "cc": 3, "mf": 5}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trees(share=("lm", "lm_embed", "aa_embed"), compute_dtype="float32",
           config_of=None):
    """{mode: (jax config, numpy tree)} with the ``share`` subtrees equal."""
    out, base = {}, None
    for i, (mode, n) in enumerate(LABELS.items()):
        kw = {**SMALL, **((config_of or {}).get(mode, {}))}
        cfg = jax_deepfri.GCNConfig(n_labels=n, compute_dtype=compute_dtype,
                                    **kw)
        p = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(30 + i), cfg))
        base = base or p
        for k in share:
            p[k] = base[k]
        out[mode] = (cfg, p)
    return out


def _inputs(seed=0, B=3, L=40):
    coords, ins, lengths = contact_batch(B=B, L=L, seed=seed)
    tokens = np.random.default_rng(seed).integers(1, 25, (B, L)).astype(
        np.uint8)
    adj = np.array(jax_aligned_contacts(jnp.asarray(coords),
                                        jnp.asarray(ins),
                                        jnp.asarray(lengths)))
    return tokens, adj, lengths


def _split(trees, shared_keys):
    shared = {k: trees["bp"][1][k] for k in shared_keys}
    per_mode = {m: {k: v for k, v in p.items() if k not in shared_keys}
                for m, (_, p) in trees.items()}
    return shared, per_mode


@pytest.mark.parametrize("shared_keys, dtype, atol", [
    (("lm", "lm_embed", "aa_embed"), "float32", 1e-5),
    (("lm",), "float32", 1e-5),
    (("lm", "lm_embed", "aa_embed"), "bfloat16", 2e-3),
])
def test_multimode_matches_jax(shared_keys, dtype, atol):
    trees = _trees(share=shared_keys, compute_dtype=dtype)
    shared, per_mode = _split(trees, shared_keys)
    jcfgs = {m: c for m, (c, _) in trees.items()}
    cfgs = {m: deepfri.GCNConfig(**dataclasses.asdict(c))
            for m, c in jcfgs.items()}
    tokens, adj, lengths = _inputs(seed=1)
    ref = jax_deepfri.gcn_forward_multimode(
        shared, per_mode, jcfgs, jnp.asarray(tokens), jnp.asarray(adj),
        jnp.asarray(lengths))
    out = deepfri.gcn_forward_multimode(
        gcn_params_from_numpy(shared, "cpu"),
        gcn_params_from_numpy(per_mode, "cpu"), cfgs,
        torch.from_numpy(tokens), torch.from_numpy(adj),
        torch.from_numpy(lengths))
    assert list(out) == list(LABELS)
    for m, n in LABELS.items():
        assert out[m].shape == (3, n) and out[m].dtype == torch.float32
        np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]),
                                   rtol=0, atol=atol)


def test_multimode_matches_port_per_mode():
    trees = _trees()
    shared, per_mode = _split(trees, ("lm", "lm_embed", "aa_embed"))
    cfgs = {m: deepfri.GCNConfig(**dataclasses.asdict(c))
            for m, (c, _) in trees.items()}
    tokens, adj, lengths = (torch.from_numpy(a) for a in _inputs(seed=2))
    out = deepfri.gcn_forward_multimode(
        gcn_params_from_numpy(shared, "cpu"),
        gcn_params_from_numpy(per_mode, "cpu"), cfgs, tokens, adj, lengths)
    for m, (_, p) in trees.items():
        ref = deepfri.gcn_forward(gcn_params_from_numpy(p, "cpu"), cfgs[m],
                                  tokens, adj, lengths)
        np.testing.assert_allclose(out[m].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6)


# -- detection -----------------------------------------------------------------

def _handle_sets():
    return {
        "shared": _trees(),
        "lm_only": _trees(share=("lm",)),
        "none": _trees(share=()),
        "gc_dims_differ": _trees(config_of={"cc": {"gc_dims": (8, 8)}}),
        "adj_norm_differs": _trees(config_of={"mf": {"adj_norm": "row"}}),
        "pool_and_fc_differ": _trees(config_of={
            "bp": {"pool": "mean", "fc_dims": (12,)}}),
    }


def _summary(detected):
    if detected is None:
        return None
    shared, per_mode, configs = detected
    return (sorted(shared), {m: sorted(p) for m, p in per_mode.items()},
            {m: dataclasses.asdict(c) for m, c in configs.items()})


@pytest.mark.parametrize("case", sorted(_handle_sets()))
def test_detect_shared_matches_jax(case):
    trees = _handle_sets()[case]
    jax_h, torch_h = {}, {}
    for m, (cfg, p) in trees.items():
        jax_h[m] = jax_engine.ModelHandle(
            "gcn", m, cfg, p, fingerprints={
                k: jax_engine._subtree_digest(v) for k, v in p.items()})
        torch_h[m] = engine.ModelHandle(
            "gcn", m, deepfri.GCNConfig(**dataclasses.asdict(cfg)), p,
            fingerprints={k: engine._subtree_digest(v)
                          for k, v in p.items()})
    ref = _summary(jax_engine._detect_shared_gcn(jax_h))
    got = _summary(engine._detect_shared_gcn(torch_h))
    assert got == ref
    assert (got is not None) == (case in ("shared", "lm_only"))
    # one mode, or a CNN handle among them, never shares
    assert engine._detect_shared_gcn({"bp": torch_h["bp"]}) is None
    assert engine._detect_shared_gcn({
        **torch_h, "cc": engine.ModelHandle(
            "cnn", "cc", deepfri.CNNConfig(n_labels=3), {})}) is None


def test_digest_reads_tensors_and_arrays_alike():
    p = _trees()["bp"][1]
    assert (engine._subtree_digest(p["lm"])
            == engine._subtree_digest(gcn_params_from_numpy(p["lm"], "cpu")))
    assert (engine._subtree_digest(p["lm"])
            != engine._subtree_digest(_trees()["cc"][1]["gc"]))


# -- the engine's two routes ---------------------------------------------------

def _engine_handles(trees):
    jax_h = {m: jax_engine.ModelHandle("gcn", m, c, p)
             for m, (c, p) in trees.items()}
    torch_h = {m: engine.ModelHandle(
        "gcn", m, deepfri.GCNConfig(**dataclasses.asdict(c)), p)
        for m, (c, p) in trees.items()}
    return jax_h, torch_h


def _count_multimode(monkeypatch):
    calls = []
    real = engine.gcn_forward_multimode

    def spy(shared, per_mode, *args):
        calls.append(sorted(per_mode))
        return real(shared, per_mode, *args)

    monkeypatch.setattr(engine, "gcn_forward_multimode", spy)
    return calls


def test_dense_engine_runs_shared_trunk_like_jax(monkeypatch):
    jax_h, torch_h = _engine_handles(_trees())
    items = aligned_items(9, seed=5, min_len=12, max_len=60)
    jax_eng = jax_engine.BatchedPredictor(gcn_models=jax_h, batch_cap=4,
                                          buckets=(32, 64), spmm="xla")
    assert jax_eng._gcn_shared is not None
    ref = jax_eng.predict_gcn_from_coords(items)
    calls = _count_multimode(monkeypatch)
    port = engine.BatchedPredictor(torch_h, device="cpu", batch_cap=4,
                                   buckets=(32, 64), spmm="dense")
    out = port.predict_gcn_from_coords(items)
    assert calls and all(c == sorted(LABELS) for c in calls)
    for m in LABELS:
        assert set(out[m]) == set(ref[m])
        for q in ref[m]:
            np.testing.assert_allclose(out[m][q], ref[m][q], rtol=0,
                                       atol=1e-5)
    # one requested mode goes per mode
    calls.clear()
    single = port.predict_gcn_from_coords(items, modes=["cc"])
    assert not calls
    for q in single["cc"]:
        np.testing.assert_allclose(single["cc"][q], out["cc"][q], rtol=0,
                                   atol=1e-6)


def test_fused_engine_stays_per_mode_on_shared_placement(monkeypatch):
    _, torch_h = _engine_handles(_trees())
    calls = _count_multimode(monkeypatch)
    fused = engine.BatchedPredictor(torch_h, device="cpu", batch_cap=4,
                                    buckets=(32, 64), spmm="fused")
    assert fused._gcn_shared is not None and fused._multi_key(
        list(LABELS)) is None
    # the shared subtrees are placed once and aliased into every mode
    for k in ("lm", "lm_embed", "aa_embed"):
        leaf = fused._gcn_params["bp"][k]
        assert all(fused._gcn_params[m][k] is leaf for m in LABELS)
    assert fused._gcn_params["bp"]["gc"] is not fused._gcn_params["cc"]["gc"]
    items = aligned_items(6, seed=6, min_len=12, max_len=60)
    out = fused.predict_gcn_from_coords(items)
    dense = engine.BatchedPredictor(torch_h, device="cpu", batch_cap=4,
                                    buckets=(32, 64), spmm="dense"
                                    ).predict_gcn_from_coords(items)
    assert len(calls) == 2  # the dense engine's two batches only
    for m in LABELS:
        for q in dense[m]:
            np.testing.assert_allclose(out[m][q], dense[m][q], rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", 2e-3)])
def test_default_engine_runs_shared_trunk_like_jax(monkeypatch, dtype, atol):
    """Both packages' default engines ("auto") on three modes sharing the
    LM: one shared-trunk step a batch, the same scores."""
    jax_h, torch_h = _engine_handles(_trees(compute_dtype=dtype))
    items = aligned_items(9, seed=8, min_len=12, max_len=60)
    jax_eng = jax_engine.BatchedPredictor(gcn_models=jax_h, batch_cap=4,
                                          buckets=(32, 64))
    assert jax_eng.spmm == "auto" and jax_eng._multi_key(list(LABELS))
    ref = jax_eng.predict_gcn_from_coords(items)
    calls = _count_multimode(monkeypatch)
    port = engine.BatchedPredictor(torch_h, device="cpu", batch_cap=4,
                                   buckets=(32, 64))
    assert port.spmm == "auto" and port._multi_key(list(LABELS))
    assert port._multi_key(["cc"]) is None
    out = port.predict_gcn_from_coords(items)
    assert len(calls) == 3 and all(c == sorted(LABELS) for c in calls)
    for m in LABELS:
        assert set(out[m]) == set(ref[m])
        for q in ref[m]:
            np.testing.assert_allclose(out[m][q], ref[m][q], rtol=0,
                                       atol=atol)
