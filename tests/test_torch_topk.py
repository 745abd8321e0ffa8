"""Top-k score fetch of the port's engine against the JAX engine, and the
float32 precision rule over both networks.

Among equal scores ``lax.top_k`` and ``torch.topk`` may keep different
indices, so the engines are compared tie-safely: the sets of overflowed ids
must be equal, and for the other rows every position whose score is at or
above the threshold must hold the same value (atol 1e-5).
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


def _assert_tie_safe_equal(out, flagged, ref, ref_flagged, dense):
    """Equal overflow sets; equal values at every above-threshold position
    of the rows that did not overflow."""
    assert flagged == ref_flagged
    for mode, rows in dense.items():
        over = ref_flagged.get(mode, set())
        for q, row in rows.items():
            if q in over:
                continue
            keep = row >= THRESHOLD
            np.testing.assert_allclose(out[mode][q][keep], ref[mode][q][keep],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(out[mode][q][keep], row[keep],
                                       rtol=0, atol=1e-6)


def test_expand_topk_host_matches_jax():
    rng = np.random.default_rng(0)
    vals = -np.sort(-rng.random((5, K)).astype(np.float32), axis=1)
    vals[0] = 1.0  # ties at the top, as untrained heads give
    idx = np.stack([rng.choice(N_LABELS, K, replace=False)
                    for _ in range(5)]).astype(np.int32)
    for threshold in (0.1, 0.5, 1.0):
        got = engine._expand_topk_host((vals, idx), N_LABELS, threshold)
        ref = jax_engine._expand_topk_host((vals, idx), N_LABELS, threshold)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    dense = rng.random((3, 6)).astype(np.float32)
    got, overflow = engine._expand_topk_host(dense, 6, 0.1)
    assert got is dense and overflow is None


@pytest.mark.parametrize("spmm", ["fused", "dense"])
def test_gcn_topk_matches_jax(spmm):
    labels = {"bp": N_LABELS, "cc": 6}  # cc: 6 ≤ 2·K, stays dense
    items = aligned_items(12, seed=8, min_len=12, max_len=60)
    jax_h, torch_h = _gcn_handles(labels, items)
    kw = dict(batch_cap=4, buckets=(32, 64))
    ref, ref_flagged = _collect(lambda cb: jax_engine.BatchedPredictor(
        gcn_models=jax_h, score_topk=K, spmm="xla", **kw
    ).predict_gcn_from_coords(items, overflow_cb=cb))
    dense = engine.BatchedPredictor(torch_h, device="cpu", spmm=spmm, **kw
                                    ).predict_gcn_from_coords(items)
    port = engine.BatchedPredictor(torch_h, device="cpu", spmm=spmm,
                                   score_topk=K, **kw)
    out, flagged = _collect(lambda cb: port.predict_gcn_from_coords(
        items, overflow_cb=cb))
    # both kinds of rows occur, and the flags are the dense rows' truth
    assert 0 < len(flagged["bp"]) < len(items) and "cc" not in flagged
    assert flagged["bp"] == {q for q, row in dense["bp"].items()
                             if (row >= THRESHOLD).sum() >= K}
    _assert_tie_safe_equal(out, flagged, ref, ref_flagged, dense)
    assert all((row != 0).sum() == K for row in out["bp"].values())
    for q, row in out["cc"].items():
        np.testing.assert_array_equal(row, dense["cc"][q])
    streamed, s_flagged = {"bp": {}, "cc": {}}, {}
    port.predict_stream(
        iter(items), result_cb=lambda p: [streamed[m].update(p[m]) for m in p],
        overflow_cb=lambda m, q: s_flagged.setdefault(m, set()).update(q))
    assert s_flagged == flagged
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
    ref, ref_flagged = _collect(lambda cb: jax_engine.BatchedPredictor(
        cnn_models={"bp": jax_engine.ModelHandle("cnn", "bp", cfg, params)},
        batch_cap=4, score_topk=K).predict_cnn(items, overflow_cb=cb))
    handle = engine.ModelHandle(
        "cnn", "bp", deepfri.CNNConfig(**dataclasses.asdict(cfg)), params)
    dense = engine.BatchedPredictor(cnn_models={"bp": handle}, device="cpu",
                                    batch_cap=4).predict_cnn(items)
    port = engine.BatchedPredictor(cnn_models={"bp": handle}, device="cpu",
                                   batch_cap=4, score_topk=K)
    out, flagged = _collect(lambda cb: port.predict_cnn(items,
                                                        overflow_cb=cb))
    assert 0 < len(flagged["bp"]) < len(items)
    _assert_tie_safe_equal(out, flagged, ref, ref_flagged, dense)
    s_flagged = {}
    port.predict_stream(iter(items), net="cnn", overflow_cb=lambda m, q:
                        s_flagged.setdefault(m, set()).update(q))
    assert s_flagged == flagged


def test_topk_is_a_noop_for_small_heads():
    items = aligned_items(5, seed=3, min_len=12, max_len=60)
    _, torch_h = _gcn_handles({"mf": 2 * K}, items)
    ref = engine.BatchedPredictor(torch_h, device="cpu",
                                  buckets=(64,)).predict_gcn_from_coords(items)
    got = engine.BatchedPredictor(torch_h, device="cpu", buckets=(64,),
                                  score_topk=K).predict_gcn_from_coords(items)
    for q in ref["mf"]:
        np.testing.assert_array_equal(got["mf"][q], ref["mf"][q])


def test_compaction_keeps_sorted_top_values():
    handle = engine.ModelHandle("gcn", "bp", deepfri.GCNConfig(
        n_labels=N_LABELS, **GCN), {})
    eng = engine.BatchedPredictor({"bp": handle}, device="cpu",
                                  score_topk=K)
    scores = torch.rand((3, N_LABELS), generator=torch.Generator()
                        .manual_seed(1))
    vals, idx = eng._compact_scores(scores, N_LABELS)
    assert idx.dtype == torch.int32 and vals.shape == (3, K)
    assert torch.equal(vals, scores.sort(dim=-1, descending=True).values[:, :K])
    assert eng._compact_scores(scores, 2 * K) is scores


@pytest.mark.parametrize("bad", [0, -3])
def test_invalid_topk_rejected(bad):
    with pytest.raises(ValueError, match="score_topk"):
        engine.BatchedPredictor(device="cpu", score_topk=bad)
    assert engine.BatchedPredictor(device="cpu").score_topk is None


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
