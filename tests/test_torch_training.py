"""Port fine-tuning (torch, CPU) against the JAX package's.

The same numpy inputs and weights go through both packages. Tolerances:
batches, labels and adjacencies exact; float32 loss rtol 1e-6 and every
gradient leaf atol 1e-6 + rtol 1e-4 of ``jax.value_and_grad(gcn_loss)``
(sums over the batch, the LSTM steps and the GraphConv products run in
another order); one Adam step from the same gradients at rtol 1e-6 /
atol 1e-8 of ``optax.adam``'s parameters (the same formula, but optax
rounds the bias correction 1 − 0.999ᵗ to float32, 1.3e-5 off at t = 1,
which moves an update of at most the learning rate 1e-3 by 6.4e-6 of
itself through the square root; torch keeps it in double);
a whole ``finetune`` run's parameters at atol 1e-6 of the JAX run's
(2 epochs at learning rate 1e-3, 4 steps: Adam normalises each update to
about the learning rate, so gradient rounding moves a parameter by a small
share of 1e-3 per step; 9e-8 was observed).
"""

import dataclasses
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from metagenomic_deepfri_tpu.data.structures import write_ca_pdb
from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu.models.onnx_import import \
    export_gcn_to_onnx as jax_export_gcn
from metagenomic_deepfri_tpu.models.registry import \
    load_checkpoint as jax_load_checkpoint
from metagenomic_deepfri_tpu.parallel import train as jax_train
from metagenomic_deepfri_tpu.training import \
    FineTuneDataset as JaxFineTuneDataset
from metagenomic_deepfri_tpu.training import finetune as jax_finetune
from metagenomic_deepfri_tpu.training import load_labels as jax_load_labels
from metagenomic_deepfri_tpu_torch import training
from metagenomic_deepfri_tpu_torch.models import deepfri
from metagenomic_deepfri_tpu_torch.models.convert import (
    gcn_params_from_numpy, gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.models.registry import load_checkpoint
from metagenomic_deepfri_tpu_torch.ops import contact
from metagenomic_deepfri_tpu_torch.parallel import train
from metagenomic_deepfri_tpu_torch.precision import use_highest_f32_precision

N_LABELS = 5
GOTERMS = [f"GO:000000{i}" for i in range(N_LABELS)]
AAS = list("ACDEFGHIKLMNPQRSTVWY")
SMALL = dict(n_labels=N_LABELS, lm_hidden=8, lm_layers=2, embed_dim=16,
             gc_dims=(8, 8), fc_dims=(16,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _walk(rng, n):
    steps = rng.normal(size=(n, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


@pytest.fixture()
def corpus(tmp_path):
    """11 CA-trace structures across buckets 128 and 256, labels TSV."""
    rng = np.random.default_rng(21)
    structures = tmp_path / "structs"
    structures.mkdir()
    lines = []
    for i, n in enumerate((30, 41, 52, 63, 74, 85, 96, 107, 131, 150, 160)):
        seq = "".join(rng.choice(AAS, size=n))
        write_ca_pdb(structures / f"p{i}.pdb", seq, _walk(rng, n))
        terms = ";".join(rng.choice(GOTERMS, size=2, replace=False))
        lines.append(f"p{i}\t{terms}")
    lines.append("p3\tGO:9999999")  # unknown term: warns and drops
    labels = tmp_path / "labels.tsv"
    labels.write_text("# comment\n" + "\n".join(lines) + "\n")
    return structures, labels


def test_load_labels_matches_jax(corpus):
    _, labels_path = corpus
    with pytest.warns(UserWarning, match="GO:9999999"):
        ref = jax_load_labels(labels_path, GOTERMS)
    with pytest.warns(UserWarning, match="GO:9999999"):
        got = training.load_labels(labels_path, GOTERMS)
    assert list(got) == list(ref)
    for pid in ref:
        assert got[pid].dtype == ref[pid].dtype
        np.testing.assert_array_equal(got[pid], ref[pid])


@pytest.mark.parametrize("batch_size, seed", [(4, 0), (8, 3)])
def test_iter_batches_match_jax(corpus, batch_size, seed):
    """Same seed → the same batches, exactly, adjacency included."""
    structures, labels_path = corpus
    with pytest.warns(UserWarning):
        labels = jax_load_labels(labels_path, GOTERMS)
    ref_ds = JaxFineTuneDataset(structures, labels)
    ds = training.FineTuneDataset(structures, labels)
    assert len(ds.items) == len(ref_ds.items) == 11
    ref = list(ref_ds.iter_batches(batch_size, np.random.default_rng(seed)))
    contact.contact_map_fused.launches = 0
    got = list(ds.iter_batches(batch_size, np.random.default_rng(seed),
                               "cpu"))
    assert contact.contact_map_fused.launches == 0  # CPU: B3's twin ran
    assert len(got) == len(ref) and {r[0].shape[1] for r in ref} == {128, 256}
    for g, r in zip(got, ref):
        for gt, rt in zip(g, r):
            assert isinstance(gt, torch.Tensor) and gt.device.type == "cpu"
            gt = gt.numpy()
            assert gt.dtype == rt.dtype and gt.shape == rt.shape
            np.testing.assert_array_equal(gt, rt)


def _loss_case(seed, **overrides):
    """JAX config/params and a padded batch; the port's equivalents."""
    jcfg = jax_deepfri.GCNConfig(**{**SMALL, **overrides})
    cfg = deepfri.GCNConfig(**dataclasses.asdict(jcfg))
    jparams = _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(seed), jcfg,
                                            gc_bias=True))
    rng = np.random.default_rng(seed)
    B, L = 3, 40
    lengths = np.array([40, 27, 9], np.int32)
    coords = np.zeros((B, L, 3), np.float32)
    tokens = np.zeros((B, L), np.uint8)
    for b, n in enumerate(lengths):
        coords[b, :n] = _walk(rng, n)
        tokens[b, :n] = rng.integers(1, 25, n)
    adj = contact.batched_contact_maps(torch.from_numpy(coords),
                                       torch.from_numpy(lengths)).numpy()
    labels = (rng.random((B, N_LABELS)) < 0.4).astype(np.int32)
    return jcfg, jparams, cfg, (tokens, adj, lengths, labels)


@pytest.mark.parametrize("overrides", [
    {"adj_norm": "none"}, {"adj_norm": "sym"},
    {"adj_norm": "sym", "lm_bidirectional": True, "pool": "mean"}])
def test_loss_and_gradients_match_jax(overrides):
    use_highest_f32_precision()
    jcfg, jparams, cfg, batch = _loss_case(5, **overrides)
    ref_logits = np.asarray(jax_deepfri.gcn_forward_logits(
        jparams, jcfg, *(jnp.asarray(a) for a in batch[:3])))
    ref_loss, ref_grads = jax.value_and_grad(jax_train.gcn_loss)(
        jparams, jcfg, *(jnp.asarray(a) for a in batch))
    params = gcn_params_from_numpy(jparams, "cpu", requires_grad=True)
    tbatch = [torch.from_numpy(a) for a in batch]
    logits = deepfri.gcn_forward_logits(params, cfg, *tbatch[:3])
    assert logits.shape == (3, N_LABELS, 2)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               rtol=1e-5, atol=1e-6)
    loss = train.gcn_loss(params, cfg, *tbatch)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    grads = torch.autograd.grad(loss, train.param_leaves(params))
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref_grads)
    assert jax.tree_util.tree_structure(
        gcn_params_to_numpy(params)) == ref_def
    got_leaves = jax.tree_util.tree_leaves(_regroup(params, grads))
    for g, r in zip(got_leaves, ref_leaves, strict=True):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-6)


def _regroup(params, grads):
    """The gradient tensors, in ``param_leaves`` order, as a numpy tree of
    the parameters' structure."""
    it = iter(g.numpy() for g in grads)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)

    return walk(params)


def test_adam_step_matches_optax():
    """One update from the same parameters and gradients."""
    _, jparams, cfg, _ = _loss_case(7)
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 10.0 ** rng.integers(
            -9, 1, size=p.shape)).astype(np.float32), jparams)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    ref = _np_tree(optax.apply_updates(jparams, updates))
    state = train.init_train_state(cfg, 1e-3, "cpu", params=jparams)
    leaves = train.param_leaves(state.params)
    for p, g in zip(leaves, train.param_leaves(
            gcn_params_from_numpy(grads, "cpu")), strict=True):
        p.grad = g
    state.opt_state.step()
    got = gcn_params_to_numpy(state.params)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref), strict=True):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-8)


def test_train_step_matches_jax():
    """A whole step (loss, gradients, Adam) from the same state."""
    use_highest_f32_precision()
    jcfg, jparams, cfg, batch = _loss_case(8, adj_norm="sym")
    opt = optax.adam(1e-3)
    jstate = jax_train.init_train_state(None, jcfg, opt, params=jparams)
    loss, grads = jax.value_and_grad(jax_train.gcn_loss)(
        jstate.params, jcfg, *(jnp.asarray(a) for a in batch))
    updates, _ = opt.update(grads, jstate.opt_state, jstate.params)
    ref = _np_tree(optax.apply_updates(jstate.params, updates))
    state = train.init_train_state(cfg, 1e-3, "cpu", params=jparams)
    step = train.make_train_step(cfg)
    state, got_loss = step(state, *(torch.from_numpy(a) for a in batch))
    assert state.step == 1 and not got_loss.requires_grad
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-6)
    for g, r in zip(jax.tree_util.tree_leaves(gcn_params_to_numpy(
            state.params)), jax.tree_util.tree_leaves(ref), strict=True):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=2e-6)


def test_init_train_state_copies_and_initialises():
    _, jparams, cfg, _ = _loss_case(9)
    state = train.init_train_state(cfg, train.adam(0.1), "cpu",
                                   params=jparams)
    leaves = train.param_leaves(state.params)
    assert all(t.requires_grad and t.dtype == torch.float32 for t in leaves)
    assert state.opt_state.defaults["lr"] == 0.1
    assert state.opt_state.defaults["betas"] == (0.9, 0.999)
    assert state.opt_state.defaults["eps"] == 1e-8
    with torch.no_grad():
        leaves[0].add_(1.0)  # the caller's tree is a copy, not shared
    assert not np.array_equal(leaves[0].detach().numpy(),
                              jax.tree_util.tree_leaves(jparams)[0])
    fresh = train.init_train_state(
        cfg, 1e-3, "cpu", generator=torch.Generator().manual_seed(0))
    # init_gcn adds no GraphConv biases; _loss_case's weights have them
    assert (len(train.param_leaves(fresh.params))
            == len(leaves) - len(cfg.gc_dims))
    with pytest.raises(ValueError, match="generator"):
        train.init_train_state(cfg, 1e-3, "cpu")


def test_float64_reference_agrees_with_float32():
    """The float64 compute mode (used on the card to check float32
    training) agrees with float32 to float32 rounding, atol 1e-5."""
    use_highest_f32_precision()
    _, jparams, cfg, batch = _loss_case(10, adj_norm="sym")
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    out = {}
    for c, dtype in ((cfg, torch.float32), (cfg64, torch.float64)):
        params = gcn_params_from_numpy(jparams, "cpu", dtype,
                                       requires_grad=True)
        tb = [torch.from_numpy(a) for a in batch]
        tb[1] = tb[1].to(dtype)
        loss = train.gcn_loss(params, c, *tb)
        assert loss.dtype == dtype
        grads = torch.autograd.grad(loss, train.param_leaves(params))
        out[dtype] = [loss.detach()] + list(grads)
    for a, b in zip(out[torch.float32], out[torch.float64], strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_trainable_module_records_gradients():
    _, jparams, cfg, (tokens, adj, lengths, _) = _loss_case(11)
    params = gcn_params_from_numpy(jparams, "cpu")
    frozen = deepfri.DeepFRIGCN(cfg, params)
    assert not any(p.requires_grad for p in frozen.parameters())
    net = deepfri.DeepFRIGCN(cfg, params, trainable=True)
    assert all(p.requires_grad for p in net.parameters())
    tb = [torch.from_numpy(a) for a in (tokens, adj, lengths)]
    net.forward_dense(*tb).sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    torch.testing.assert_close(
        deepfri.gcn_forward_logits(net.tree(), cfg, *tb).softmax(-1)[..., 0],
        frozen.forward_dense(*tb), rtol=0, atol=0)


def _weights_dir(tmp_path, cfg, seed=0):
    """A weights folder with one mf GCN exported by the JAX exporter."""
    weights = tmp_path / "weights"
    weights.mkdir()
    name = "DeepFRI-MERGED_GraphConv_gcd_8-8_fcd_16_ca_10.0_mf.onnx"
    jax_export_gcn(init_gcn_np(cfg, seed), cfg, str(weights / name))
    with open(weights / (name[:-5] + "_model_params.json"), "w") as f:
        json.dump({"goterms": GOTERMS, "gonames": ["t"] * N_LABELS}, f)
    with open(weights / "model_config.json", "w") as f:
        json.dump({"gcn": {"mf": str(weights / name)}, "cnn": {},
                   "version": "1.0"}, f)
    return weights


def init_gcn_np(cfg, seed):
    return _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(seed), cfg))


def test_finetune_matches_jax(corpus, tmp_path):
    """Both packages fine-tune the same base ONNX on the same corpus."""
    structures, labels_path = corpus
    jcfg = jax_deepfri.GCNConfig(**SMALL, adj_norm="none")
    weights = _weights_dir(tmp_path, jcfg)
    kw = dict(epochs=2, learning_rate=1e-3, batch_size=8, seed=4)
    with pytest.warns(UserWarning):
        ref_ckpt = jax_finetune(weights, "mf", structures, labels_path,
                                tmp_path / "jax_out", **kw)
    steps = []
    contact.contact_map_fused.launches = 0
    with pytest.warns(UserWarning):
        ckpt = training.finetune(
            weights, "mf", structures, labels_path, tmp_path / "out",
            device="cpu", on_step=lambda i, loss: steps.append(
                (i, loss.item())), **kw)
    # corpus: 8 proteins in bucket 128 and 3 in 256 → 2 batches an epoch
    assert [i for i, _ in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(loss) for _, loss in steps)
    assert ckpt.name == ref_ckpt.name == "gcn_mf_finetuned.npz"
    assert sorted(p.name for p in ckpt.parent.iterdir()) == sorted(
        p.name for p in ref_ckpt.parent.iterdir())
    assert (ckpt.with_name("gcn_mf_finetuned_config.json").read_text()
            == ref_ckpt.with_name("gcn_mf_finetuned_config.json").read_text())
    ref_cfg, ref_params = jax_load_checkpoint(ref_ckpt)
    cfg, params = load_checkpoint(ckpt)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    base = init_gcn_np(jcfg, 0)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref_params)
    assert jax.tree_util.tree_structure(params) == ref_def
    for g, r, b in zip(jax.tree_util.tree_leaves(params), ref_leaves,
                       jax.tree_util.tree_leaves(base), strict=True):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
        assert not np.array_equal(g, b)  # training moved every leaf


def test_finetune_rejects_model_parallel(tmp_path):
    """``model_parallel`` must divide the device count (the JAX
    ``make_mesh`` error), checked before anything is read."""
    for device, mp in (("cpu", 2), (["cpu"] * 3, 2), ("cpu,cpu", 0)):
        with pytest.raises(ValueError, match="does not divide"):
            training.finetune(tmp_path, "mf", tmp_path, tmp_path / "l.tsv",
                              tmp_path, device=device, model_parallel=mp)


def test_finetune_model_parallel_matches_jax(corpus, tmp_path):
    """``finetune(model_parallel=2)`` over 4 CPU ranks (data 2 × model 2)
    against the JAX ``finetune(model_parallel=2)`` on its 4×2 mesh, batch 8:
    checkpoint atol 1e-5; the checkpoint loads into the one-device engine."""
    from metagenomic_deepfri_tpu_torch.batching.engine import (
        BatchedPredictor, ModelHandle)
    from metagenomic_deepfri_tpu_torch.synthetic import aligned_items

    structures, labels_path = corpus
    jcfg = jax_deepfri.GCNConfig(**SMALL, adj_norm="none")
    weights = _weights_dir(tmp_path, jcfg)
    kw = dict(epochs=2, learning_rate=1e-3, batch_size=8, seed=4,
              model_parallel=2)
    with pytest.warns(UserWarning):
        ref_ckpt = jax_finetune(weights, "mf", structures, labels_path,
                                tmp_path / "jax_out", **kw)
    steps = []
    ckpt = training.finetune(weights, "mf", structures, labels_path,
                             tmp_path / "out", device=["cpu"] * 4,
                             on_step=lambda i, loss: steps.append(
                                 (i, float(loss))), **kw)
    assert [i for i, _ in steps] == [1, 2, 3, 4]
    assert sorted(p.name for p in ckpt.parent.iterdir()) == sorted(
        p.name for p in ref_ckpt.parent.iterdir())
    _, ref_params = jax_load_checkpoint(ref_ckpt)
    cfg, params = load_checkpoint(ckpt)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(ref_params)
    for g, r in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(ref_params), strict=True):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
    engine = BatchedPredictor({"mf": ModelHandle("gcn", "mf", cfg, params)},
                              device="cpu")
    items = aligned_items(3, seed=2, min_len=20, max_len=60)
    scores = engine.predict_gcn_from_coords(items)["mf"]
    assert all(row.shape == (N_LABELS,) and np.isfinite(row).all()
               for row in scores.values())
