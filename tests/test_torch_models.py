"""Port models (torch, CPU) against the JAX package with the same weights.

Weights come from the JAX initialisers and are copied into the port with
``gcn_params_from_numpy``; inputs are numpy arrays handed to both.
Tolerances: float32 LSTM atol 1e-5; float32 GCN rtol 1e-5 / atol 1e-5 (as
``tests/test_pallas.py`` holds the fused forward to the dense one); bf16
LSTM outputs atol 2e-3 and bf16 GCN scores atol 2e-2 (bf16 rounds at other
points in the two frameworks' matmuls).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu.models import lstm as jax_lstm
from metagenomic_deepfri_tpu.ops.cmap_align import \
    aligned_contacts_from_coords as jax_aligned_contacts
from metagenomic_deepfri_tpu_torch.models import deepfri, lstm
from metagenomic_deepfri_tpu_torch.models.convert import (
    gcn_params_from_numpy, gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.ops.cmap_align import \
    aligned_contacts_from_coords
from metagenomic_deepfri_tpu_torch.precision import (
    highest_f32_precision_active, use_highest_f32_precision)
from metagenomic_deepfri_tpu_torch.synthetic import contact_batch

SMALL = dict(n_labels=6, lm_hidden=16, lm_layers=2, embed_dim=64,
             gc_dims=(32, 32, 32), fc_dims=(32,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lstm_params(seed, in_dim=26, hidden=16):
    return _np_tree(jax_lstm.init_lstm(jax.random.PRNGKey(seed), in_dim,
                                       hidden))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_forward_f32(reverse):
    use_highest_f32_precision()
    assert highest_f32_precision_active()
    p = _lstm_params(0)
    x = np.random.default_rng(0).normal(size=(3, 11, 26)).astype(np.float32)
    ref = np.asarray(jax_lstm.lstm_forward(p, jnp.asarray(x),
                                           reverse=reverse))
    out = lstm.lstm_forward(gcn_params_from_numpy(p, "cpu"),
                            torch.from_numpy(x), reverse=reverse)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_lstm_forward_bf16():
    p = _lstm_params(1)
    x = np.random.default_rng(1).normal(size=(3, 11, 26)).astype(np.float32)
    ref = np.asarray(jax_lstm.lstm_forward(p, jnp.asarray(x),
                                           compute_dtype=jnp.bfloat16))
    out = lstm.lstm_forward(gcn_params_from_numpy(p, "cpu"),
                            torch.from_numpy(x),
                            compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32  # the emitted h is the f32 value
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-3)


def test_lstm_stack_bidirectional_f32():
    params = _np_tree(jax_lstm.init_lstm_stack(
        jax.random.PRNGKey(2), 26, 8, 2, bidirectional=True))
    x = np.random.default_rng(2).normal(size=(3, 10, 26)).astype(np.float32)
    lengths = np.array([10, 7, 3], np.int32)
    ref = np.asarray(jax_lstm.lstm_stack_forward(
        params, jnp.asarray(x), jnp.asarray(lengths)))
    out = lstm.lstm_stack_forward(gcn_params_from_numpy(params, "cpu"),
                                  torch.from_numpy(x),
                                  torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        lstm.reverse_sequences(torch.from_numpy(x),
                               torch.from_numpy(lengths)).numpy(),
        np.asarray(jax_lstm.reverse_sequences(jnp.asarray(x),
                                              jnp.asarray(lengths))))


def _gcn_case(compute_dtype="float32", seed=0, L=96, **overrides):
    jcfg = jax_deepfri.GCNConfig(**{**SMALL, **overrides},
                                 compute_dtype=compute_dtype)
    cfg = deepfri.GCNConfig(**dataclasses.asdict(jcfg))
    jparams = jax_deepfri.init_gcn(jax.random.PRNGKey(seed), jcfg)
    coords, ins, lengths = contact_batch(B=2, L=L, seed=seed + 3)
    tokens = np.random.default_rng(seed).integers(
        1, 25, (2, L)).astype(np.uint8)
    jax_in = tuple(jnp.asarray(a) for a in (tokens, coords, ins, lengths))
    torch_in = tuple(torch.from_numpy(a)
                     for a in (tokens, coords, ins, lengths))
    params = gcn_params_from_numpy(_np_tree(jparams), "cpu")
    return jcfg, jparams, cfg, params, jax_in, torch_in


@pytest.mark.parametrize("adj_norm", ["sym", "row"])
def test_gcn_forward_fused_matches_jax_f32(adj_norm):
    use_highest_f32_precision()
    assert highest_f32_precision_active()
    jcfg, jparams, cfg, params, (jt, jc, ji, jl), (tt, tc, ti, tl) = \
        _gcn_case(adj_norm=adj_norm)
    ref_fused = np.asarray(jax_deepfri.gcn_forward_fused(
        jparams, jcfg, jt, jc, ji, jl, interpret=True))
    ref_dense = np.asarray(jax_deepfri.gcn_forward(
        jparams, jcfg, jt, jax_aligned_contacts(jc, ji, jl), jl))
    out = deepfri.gcn_forward_fused(params, cfg, tt, tc, ti, tl).numpy()
    np.testing.assert_allclose(out, ref_fused, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref_dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("overrides", [
    {}, {"adj_norm": "none", "pool": "mean"},
    {"lm_bidirectional": True, "gc_dims": (32, 16)}])
def test_gcn_forward_dense_matches_jax_f32(overrides):
    jcfg, jparams, cfg, params, (jt, jc, ji, jl), (tt, tc, ti, tl) = \
        _gcn_case(seed=4, **overrides)
    ref = np.asarray(jax_deepfri.gcn_forward(
        jparams, jcfg, jt, jax_aligned_contacts(jc, ji, jl), jl))
    out = deepfri.gcn_forward(params, cfg, tt,
                              aligned_contacts_from_coords(tc, ti, tl), tl)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_gcn_forward_fused_bf16_scores():
    jcfg, jparams, cfg, params, (jt, jc, ji, jl), (tt, tc, ti, tl) = \
        _gcn_case(compute_dtype="bfloat16", seed=1)
    ref = np.asarray(jax_deepfri.gcn_forward_fused(
        jparams, jcfg, jt, jc, ji, jl, interpret=True))
    out = deepfri.gcn_forward_fused(params, cfg, tt, tc, ti, tl)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-2)


def test_module_forward_equals_functions():
    _, _, cfg, params, _, (tt, tc, ti, tl) = _gcn_case(seed=2)
    net = deepfri.DeepFRIGCN(cfg, params)
    assert all(not p.requires_grad for p in net.parameters())
    assert "params.gc.0.kernel" in net.state_dict()
    torch.testing.assert_close(
        net(tt, tc, ti, tl),
        deepfri.gcn_forward_fused(params, cfg, tt, tc, ti, tl),
        rtol=0, atol=0)
    torch.testing.assert_close(
        net.forward_dense(tt, aligned_contacts_from_coords(tc, ti, tl), tl),
        deepfri.gcn_forward(params, cfg, tt,
                            aligned_contacts_from_coords(tc, ti, tl), tl),
        rtol=0, atol=0)


def test_convert_round_trip():
    jcfg = jax_deepfri.GCNConfig(**SMALL, lm_bidirectional=True)
    tree = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(3), jcfg,
                                         gc_bias=True, lm_embed_bias=True))
    back = gcn_params_to_numpy(gcn_params_from_numpy(tree, "cpu"))
    flat_a, def_a = jax.tree_util.tree_flatten(tree)
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_init_gcn_matches_jax_tree_shapes():
    jcfg = jax_deepfri.GCNConfig(**SMALL)
    cfg = deepfri.GCNConfig(**dataclasses.asdict(jcfg))
    ref = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(0), jcfg))
    got = gcn_params_to_numpy(deepfri.init_gcn(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert (jax.tree_util.tree_structure(ref)
            == jax.tree_util.tree_structure(got))
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(got)):
        assert a.shape == b.shape
    assert got["lm"][0]["bias"][16:32].tolist() == [1.0] * 16


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(deepfri.GCNConfig)]
            == [f.name for f in dataclasses.fields(jax_deepfri.GCNConfig)])
    assert deepfri.GCNConfig(n_labels=3) == deepfri.GCNConfig(
        **dataclasses.asdict(jax_deepfri.GCNConfig(n_labels=3)))
    with pytest.raises(ValueError, match="compute_dtype"):
        deepfri.DeepFRIGCN(deepfri.GCNConfig(n_labels=3,
                                             compute_dtype="float16"), {})
