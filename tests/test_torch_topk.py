"""The port's dense score rows against the JAX engine's top-k score fetch,
and the float32 precision rule over both networks.

The port returns every row dense; the JAX engine with ``score_topk=K``
returns each row's top K and flags the rows whose K-th score still clears
the threshold. Among equal scores ``lax.top_k`` may keep any of the tied
indices, so the rows are compared tie-safely: every term at or above the
threshold that the JAX engine keeps holds the port's value (atol 1e-5), and
the rows it flags are held to the JAX engine's dense fetch instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from metagenomic_deepfri_tpu.batching import engine as jax_engine
from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu_torch.batching import engine
from metagenomic_deepfri_tpu_torch.models import deepfri
from metagenomic_deepfri_tpu_torch.models.convert import gcn_params_from_numpy
from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
    aligned_contacts_from_coords
from metagenomic_deepfri_tpu_torch.synthetic import (AMINO_ACIDS,
                                                     aligned_items,
                                                     threshold_head_bias)

K = 4
THRESHOLD = 0.1
N_LABELS = 40
GCN = dict(lm_hidden=8, lm_layers=1, embed_dim=16, gc_dims=(8, 8),
           fc_dims=(16,))
CNN = dict(conv_filters=8, conv_kernels=(3, 8), fc_dims=(16,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _calibrate(handle, logits):
    """Give the head the sparse bias of ``threshold_head_bias``: scores
    mostly far below the threshold and 2·K terms with their median on it,
    so some proteins overflow a top-K fetch and the rest do not."""
    assert not handle.params["head"]["bias"].any()
    with torch.inference_mode():
        out = logits(gcn_params_from_numpy(handle.params, "cpu"),
                     handle.config).numpy()
    handle.params["head"]["bias"] = threshold_head_bias(
        out[..., 0] - out[..., 1], THRESHOLD, 2 * K, seed=0)


def _gcn_handles(labels, items):
    jax_h, torch_h, base = {}, {}, None
    tokens, lengths, coords, ins = (
        torch.from_numpy(a)
        for a in engine._pad_batch_coords(items, 64, len(items)))
    adj = aligned_contacts_from_coords(coords, ins, lengths)
    for i, (mode, n) in enumerate(labels.items()):
        cfg = jax_deepfri.GCNConfig(n_labels=n, **GCN)
        p = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(50 + i), cfg))
        base = base or p
        for k in ("lm", "lm_embed", "aa_embed"):
            p[k] = base[k]
        jax_h[mode] = jax_engine.ModelHandle("gcn", mode, cfg, p)
        torch_h[mode] = engine.ModelHandle(
            "gcn", mode, deepfri.GCNConfig(**dataclasses.asdict(cfg)), p)
        _calibrate(torch_h[mode], lambda params, c: deepfri.gcn_forward_logits(
            params, c, tokens, adj, lengths))
    return jax_h, torch_h


def _collect(run):
    flagged = {}
    out = run(lambda mode, ids: flagged.setdefault(mode, []).extend(ids))
    return out, {m: set(v) for m, v in flagged.items()}


def _assert_keeps_every_term(out, ref, ref_flagged, ref_dense):
    """The port's dense rows hold every term ≥ the threshold that the JAX
    top-K rows keep (the JAX dense rows for the ids it flags), at the same
    value, and no other term clears the threshold by more than the
    tolerance."""
    for mode, rows in out.items():
        over = ref_flagged.get(mode, set())
        for q, row in rows.items():
            want = ref_dense[mode][q] if q in over else ref[mode][q]
            keep = want >= THRESHOLD
            np.testing.assert_allclose(row[keep], want[keep], rtol=0,
                                       atol=1e-5)
            assert not (row[~keep] >= THRESHOLD + 1e-5).any()


@pytest.mark.parametrize("spmm", ["fused", "dense"])
def test_gcn_topk_matches_jax(spmm):
    labels = {"bp": N_LABELS, "cc": 6}  # cc: 6 ≤ 2·K, stays dense
    items = aligned_items(12, seed=8, min_len=12, max_len=60)
    jax_h, torch_h = _gcn_handles(labels, items)
    kw = dict(batch_cap=4, buckets=(32, 64))
    ref, ref_flagged = _collect(lambda cb: jax_engine.BatchedPredictor(
        gcn_models=jax_h, score_topk=K, spmm="xla", **kw
    ).predict_gcn_from_coords(items, overflow_cb=cb))
    ref_dense = jax_engine.BatchedPredictor(
        gcn_models=jax_h, spmm="xla", **kw).predict_gcn_from_coords(items)
    port = engine.BatchedPredictor(torch_h, device="cpu", spmm=spmm, **kw)
    out = port.predict_gcn_from_coords(items)
    # both kinds of rows occur, and the JAX flags are the port's dense truth
    assert 0 < len(ref_flagged["bp"]) < len(items) and "cc" not in ref_flagged
    assert ref_flagged["bp"] == {q for q, row in out["bp"].items()
                                 if (row >= THRESHOLD).sum() >= K}
    assert all(row.shape == (n,) and row.dtype == np.float32
               for mode, n in labels.items() for row in out[mode].values())
    _assert_keeps_every_term(out, ref, ref_flagged, ref_dense)
    streamed = {"bp": {}, "cc": {}}
    port.predict_stream(
        iter(items), result_cb=lambda p: [streamed[m].update(p[m]) for m in p])
    for q in items:
        np.testing.assert_array_equal(streamed["bp"][q[0]], out["bp"][q[0]])


def test_cnn_topk_matches_jax():
    cfg = jax_deepfri.CNNConfig(n_labels=N_LABELS, **CNN)
    params = _np_tree(jax_deepfri.init_cnn(jax.random.PRNGKey(5), cfg))
    rng = np.random.default_rng(9)
    items = [(f"s{i}", "".join(rng.choice(list(AMINO_ACIDS), size=int(n))))
             for i, n in enumerate(rng.integers(5, 200, size=12))]
    tokens, lengths = (torch.from_numpy(a)
                       for a in engine._pad_batch(items, 256, len(items)))
    _calibrate(engine.ModelHandle(
        "cnn", "bp", deepfri.CNNConfig(**dataclasses.asdict(cfg)), params),
        lambda p, c: deepfri.cnn_forward_logits(p, c, tokens, lengths))
    jax_handles = {"bp": jax_engine.ModelHandle("cnn", "bp", cfg, params)}
    ref, ref_flagged = _collect(lambda cb: jax_engine.BatchedPredictor(
        cnn_models=jax_handles, batch_cap=4, score_topk=K
    ).predict_cnn(items, overflow_cb=cb))
    ref_dense = jax_engine.BatchedPredictor(
        cnn_models=jax_handles, batch_cap=4).predict_cnn(items)
    handle = engine.ModelHandle(
        "cnn", "bp", deepfri.CNNConfig(**dataclasses.asdict(cfg)), params)
    port = engine.BatchedPredictor(cnn_models={"bp": handle}, device="cpu",
                                   batch_cap=4)
    out = port.predict_cnn(items)
    assert 0 < len(ref_flagged["bp"]) < len(items)
    assert ref_flagged["bp"] == {q for q, row in out["bp"].items()
                                 if (row >= THRESHOLD).sum() >= K}
    _assert_keeps_every_term(out, ref, ref_flagged, ref_dense)
    streamed = {}
    port.predict_stream(iter(items), net="cnn",
                        result_cb=lambda p: streamed.update(p["bp"]))
    for q, row in out["bp"].items():
        np.testing.assert_array_equal(streamed[q], row)


@pytest.mark.parametrize("gcn_dtype, cnn_dtype, turned_off", [
    ("float32", "float32", True),
    ("float32", "bfloat16", False),
    ("bfloat16", "float32", False),
])
def test_precision_rule_covers_both_networks(gcn_dtype, cnn_dtype,
                                             turned_off):
    gcn = engine.ModelHandle("gcn", "mf", deepfri.GCNConfig(
        n_labels=3, compute_dtype=gcn_dtype, **GCN), _np_tree(
        jax_deepfri.init_gcn(jax.random.PRNGKey(0), jax_deepfri.GCNConfig(
            n_labels=3, **GCN))))
    cnn = engine.ModelHandle("cnn", "mf", deepfri.CNNConfig(
        n_labels=3, compute_dtype=cnn_dtype, **CNN), _np_tree(
        jax_deepfri.init_cnn(jax.random.PRNGKey(1), jax_deepfri.CNNConfig(
            n_labels=3, **CNN))))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        engine.BatchedPredictor({"mf": gcn}, {"mf": cnn}, device="cpu")
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (not turned_off,) * 2
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
