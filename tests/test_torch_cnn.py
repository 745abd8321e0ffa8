"""Port CNN (torch, CPU) against the JAX package, and the CNN engine path.

The same numpy weights (JAX ``init_cnn``) and inputs go to both packages.
Tolerances: float32 scores and pre-softmax logits atol 1e-5; a padded batch
against unpadded single-protein runs atol 1e-6 (the same float32 ops over
zeroed padding).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from metagenomic_deepfri_tpu.batching.engine import \
    BatchedPredictor as JaxPredictor
from metagenomic_deepfri_tpu.batching.engine import \
    ModelHandle as JaxHandle
from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu.ops.contact import \
    calculate_contact_map as jax_contact_map
from metagenomic_deepfri_tpu_torch.batching.engine import (BatchedPredictor,
                                                           ModelHandle)
from metagenomic_deepfri_tpu_torch.models import deepfri
from metagenomic_deepfri_tpu_torch.models.convert import (
    cnn_params_from_numpy, cnn_params_to_numpy, gcn_params_from_numpy)
from metagenomic_deepfri_tpu_torch.ops.one_hot import seq2tokens
from metagenomic_deepfri_tpu_torch.precision import \
    highest_f32_precision_active
from metagenomic_deepfri_tpu_torch.synthetic import AMINO_ACIDS

CNN = dict(n_labels=6, conv_filters=16, conv_kernels=(8, 16), fc_dims=(24,))
LABELS = {"bp": 9, "cc": 4, "mf": 6}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cnn(seed=0, **overrides):
    jcfg = jax_deepfri.CNNConfig(**{**CNN, **overrides})
    cfg = deepfri.CNNConfig(**dataclasses.asdict(jcfg))
    params = _np_tree(jax_deepfri.init_cnn(jax.random.PRNGKey(seed), jcfg))
    # non-zero conv biases, so the zero-padding and masking are exercised
    rng = np.random.default_rng(seed)
    for conv in params["conv"]:
        conv["bias"] = rng.normal(0, 0.1, conv["bias"].shape).astype(
            np.float32)
    return jcfg, cfg, params


def _seqs(rng, lengths):
    return ["".join(rng.choice(list(AMINO_ACIDS), size=n)) for n in lengths]


def _batch(seqs, pad_to):
    tokens = np.zeros((len(seqs), pad_to), np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = seq2tokens(s)
        lengths[i] = len(s)
    return tokens, lengths


def _both(fn_jax, fn_port, jcfg, cfg, params, tokens, lengths):
    ref = fn_jax(params, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))
    out = fn_port(cnn_params_from_numpy(params, "cpu"), cfg,
                  torch.from_numpy(tokens), torch.from_numpy(lengths))
    return out, ref


@pytest.mark.parametrize("fn", ["cnn_forward", "cnn_forward_logits"])
@pytest.mark.parametrize("kernels", [(8, 16), (5,), (3, 8)])
def test_cnn_matches_jax(fn, kernels):
    jcfg, cfg, params = _cnn(seed=len(kernels), conv_kernels=kernels)
    rng = np.random.default_rng(1)
    # length 5 is shorter than the widest kernel; 0 has no valid position
    tokens, lengths = _batch(_seqs(rng, (40, 5, 23, 0)), 48)
    out, ref = _both(getattr(jax_deepfri, fn), getattr(deepfri, fn), jcfg,
                     cfg, params, tokens, lengths)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_cnn_stages_match_jax():
    jcfg, cfg, params = _cnn(seed=3, fc_dims=(24, 12))
    tokens, lengths = _batch(_seqs(np.random.default_rng(3), (31, 17)), 32)
    out, ref = _both(jax_deepfri.cnn_forward_stages,
                     deepfri.cnn_forward_stages, jcfg, cfg, params, tokens,
                     lengths)
    assert list(out) == list(ref) == ["pooled", "fc0", "fc1", "logits",
                                      "scores"]
    for name in ref:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-6, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("width, split", [(8, (3, 4)), (16, (7, 8)),
                                          (5, (2, 2))])
def test_same_padding_split_matches_xla(width, split):
    """XLA's 'SAME' puts the odd pad element high; conv1d after an explicit
    pad of ``same_padding`` equals lax.conv_general_dilated(SAME) with the
    (W, I, O) kernel permuted to (O, I, W) and not flipped."""
    assert deepfri.same_padding(width) == split
    rng = np.random.default_rng(width)
    x = rng.normal(size=(2, 11, 26)).astype(np.float32)
    w = rng.normal(size=(width, 26, 3)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(1,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))
    xt = torch.from_numpy(x).transpose(1, 2)
    out = F.conv1d(F.pad(xt, split), torch.from_numpy(w).permute(2, 1, 0))
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_row_without_valid_position_pools_to_zero():
    _, cfg, params = _cnn(seed=4)
    tokens, lengths = _batch(_seqs(np.random.default_rng(4), (0, 9)), 16)
    tokens[0] = 7  # tokens past the length must not matter
    stages = deepfri.cnn_forward_stages(
        cnn_params_from_numpy(params, "cpu"), cfg, torch.from_numpy(tokens),
        torch.from_numpy(lengths))
    assert torch.equal(stages["pooled"][0], torch.zeros(32))
    assert stages["pooled"][1].abs().sum() > 0


def test_bf16_config_computes_in_float32():
    jcfg, cfg, params = _cnn(seed=5)
    tokens, lengths = _batch(_seqs(np.random.default_rng(5), (20, 12)), 24)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    p = cnn_params_from_numpy(params, "cpu")
    t, l_ = torch.from_numpy(tokens), torch.from_numpy(lengths)
    out = deepfri.cnn_forward(p, bf16, t, l_)
    assert out.dtype == torch.float32
    assert torch.equal(out, deepfri.cnn_forward(p, cfg, t, l_))
    ref = jax_deepfri.cnn_forward(
        params, dataclasses.replace(jcfg, compute_dtype="bfloat16"),
        jnp.asarray(tokens), jnp.asarray(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_padded_batch_equals_unpadded_singles():
    _, cfg, params = _cnn(seed=6)
    p = cnn_params_from_numpy(params, "cpu")
    seqs = _seqs(np.random.default_rng(6), (5, 33, 17, 64))
    tokens, lengths = _batch(seqs, 80)
    batch = deepfri.cnn_forward(p, cfg, torch.from_numpy(tokens),
                                torch.from_numpy(lengths))
    net = deepfri.DeepFRICNN(cfg, p)
    assert torch.equal(net(torch.from_numpy(tokens),
                           torch.from_numpy(lengths)), batch)
    for i, seq in enumerate(seqs):
        single = deepfri.forward_pass_single(p, cfg, seq)
        assert single.shape == (cfg.n_labels,)
        np.testing.assert_allclose(batch[i].numpy(), single.numpy(), rtol=0,
                                   atol=1e-6)


def test_init_cnn_and_convert():
    jcfg, cfg, params = _cnn()
    got = cnn_params_to_numpy(deepfri.init_cnn(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == np.float32
    back = cnn_params_to_numpy(cnn_params_from_numpy(params, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert ([f.name for f in dataclasses.fields(deepfri.CNNConfig)]
            == [f.name for f in dataclasses.fields(jax_deepfri.CNNConfig)])


# -- single-protein and staged GCN forwards -----------------------------------

GCN = dict(n_labels=5, lm_hidden=8, lm_layers=2, embed_dim=16,
           gc_dims=(8, 12), fc_dims=(16,))


def test_gcn_single_and_stages_match_jax():
    jcfg = jax_deepfri.GCNConfig(**GCN)
    cfg = deepfri.GCNConfig(**dataclasses.asdict(jcfg))
    params = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(7)
    (seq,) = _seqs(rng, (37,))
    coords = np.cumsum(rng.normal(size=(37, 3)) * 2.2, 0).astype(np.float32)
    cmap = jax_contact_map(coords, threshold=6.0).astype(np.float32)
    p = gcn_params_from_numpy(params, "cpu")
    np.testing.assert_allclose(
        deepfri.forward_pass_single(p, cfg, seq, cmap).numpy(),
        np.asarray(jax_deepfri.forward_pass_single(params, jcfg, seq, cmap)),
        rtol=0, atol=1e-5)
    ours = deepfri.forward_stages_single(p, cfg, seq, cmap)
    ref = jax_deepfri.forward_stages_single(params, jcfg, seq, cmap)
    assert list(ours) == list(ref)
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# -- the CNN path of the engine ------------------------------------------------

def _cnn_handles():
    jax_h, torch_h = {}, {}
    for i, (mode, n) in enumerate(LABELS.items()):
        jcfg, cfg, params = _cnn(seed=20 + i, n_labels=n)
        jax_h[mode] = JaxHandle("cnn", mode, jcfg, params)
        torch_h[mode] = ModelHandle("cnn", mode, cfg, params)
    return jax_h, torch_h


def _cnn_items():
    rng = np.random.default_rng(11)
    # every standard bucket, plus one sequence beyond the 2048 ceiling
    lengths = list(rng.integers(4, 300, size=9)) + [700, 1500, 2100]
    return [(f"s{i}", s) for i, s in enumerate(_seqs(rng, lengths))]


def test_engine_cnn_matches_jax():
    jax_h, torch_h = _cnn_handles()
    items = _cnn_items()
    ref = JaxPredictor(cnn_models=jax_h, batch_cap=4).predict_cnn(items)
    engine = BatchedPredictor(cnn_models=torch_h, device="cpu", batch_cap=4)
    assert highest_f32_precision_active()
    progress, parts = [], []
    out = engine.predict_cnn(items, progress_cb=progress.append,
                             result_cb=parts.append)
    assert sum(progress) == len(items) and len(parts) == len(progress)
    streamed = {m: {} for m in LABELS}
    n = engine.predict_stream(iter(items), net="cnn",
                              result_cb=lambda p: [streamed[m].update(p[m])
                                                   for m in p])
    assert n == len(items)
    for got in (out, streamed):
        assert set(got) == set(LABELS)
        for mode, n_labels in LABELS.items():
            assert set(got[mode]) == {q for q, _ in items}
            for qid, row in got[mode].items():
                assert row.shape == (n_labels,) and row.dtype == np.float32
                np.testing.assert_allclose(row, ref[mode][qid], rtol=0,
                                           atol=1e-5)


def test_predict_cnn_collapses_standard_buckets(monkeypatch):
    _, torch_h = _cnn_handles()
    engine = BatchedPredictor(cnn_models=torch_h, device="cpu")
    seen = []
    real = engine._run_batch

    def spy(bucket, chunk, batch, *args):
        seen.append((bucket, len(chunk), batch))
        return real(bucket, chunk, batch, *args)

    monkeypatch.setattr(engine, "_run_batch", spy)
    engine.predict_cnn(_cnn_items(), modes=["cc"])
    # the 11 standard-bucket sequences ride bucket 2048 together (the
    # largest needed, for the 1500-residue one), the 2100-residue one its
    # own 2304 bucket
    assert seen == [(2048, 11, 16), (2304, 1, 8)]


def test_engine_keeps_gcn_and_cnn_modes_apart():
    _, torch_h = _cnn_handles()
    engine = BatchedPredictor(cnn_models={"mf": torch_h["mf"]},
                              device="cpu")
    assert engine.predict_cnn([]) == {"mf": {}}
    with pytest.raises(KeyError, match="GCN"):
        engine.predict_stream(iter([]), net="gcn_coords", modes=["mf"])
    with pytest.raises(KeyError, match="CNN"):
        engine.predict_cnn([("a", "ACD")], modes=["bp"])
