"""Port registry, ONNX import/export and checkpoints against the JAX package.

Weights come from the JAX initialisers (numpy trees). Import must give the
same ``GCNConfig`` and exactly equal parameters; export must write the same
bytes; ``.npz`` checkpoints must load in the other package with equal
arrays and an identical ``_config.json``.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax

from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu.models import onnx_import as jax_onnx
from metagenomic_deepfri_tpu.models import registry as jax_registry
from metagenomic_deepfri_tpu.models.tf2onnx_fixture import \
    export_gcn_tf2onnx_style
from metagenomic_deepfri_tpu_torch.models import deepfri, onnx_import, registry
from metagenomic_deepfri_tpu_torch.models.convert import (
    gcn_params_from_numpy, gcn_params_to_numpy)
from metagenomic_deepfri_tpu_torch.models.onnx_reader import load_onnx
from metagenomic_deepfri_tpu_torch.utils import (get_json_values,
                                                 load_deepfri_config)

N_LABELS = 5
GOTERMS = [f"GO:000000{i}" for i in range(N_LABELS)]
SMALL = dict(n_labels=N_LABELS, lm_hidden=8, lm_layers=2, embed_dim=16,
             gc_dims=(8, 12), fc_dims=(16,))


def _params(cfg, seed=0, **kw):
    return jax.tree_util.tree_map(
        np.asarray, jax_deepfri.init_gcn(jax.random.PRNGKey(seed), cfg, **kw))


def _params_json(tmp_path, name):
    path = tmp_path / f"{name}_model_params.json"
    path.write_text(json.dumps({"goterms": GOTERMS,
                                "gonames": ["t"] * N_LABELS}))
    return path


def _assert_same_handle(got, ref):
    assert dataclasses.asdict(got.config) == dataclasses.asdict(ref.config)
    assert isinstance(got.config, deepfri.GCNConfig)
    assert got.goterms == ref.goterms and got.gonames == ref.gonames
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref.params)
    assert jax.tree_util.tree_structure(got.params) == ref_def
    for g, r in zip(jax.tree_util.tree_leaves(got.params), ref_leaves,
                    strict=True):
        assert g.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("overrides, init_kw", [
    ({}, {}),
    ({"adj_norm": "none", "pool": "mean"}, {"gc_bias": True}),
    ({"lm_layers": 1}, {"lm_embed_bias": True}),
])
def test_load_model_handle_on_jax_export(tmp_path, overrides, init_kw):
    cfg = jax_deepfri.GCNConfig(**{**SMALL, **overrides})
    path = tmp_path / "gcn.onnx"
    jax_onnx.export_gcn_to_onnx(_params(cfg, **init_kw), cfg, str(path))
    pj = _params_json(tmp_path, "gcn")
    ref = jax_registry.load_model_handle("gcn", "mf", path, pj)
    got = registry.load_model_handle("gcn", "mf", path, pj)
    _assert_same_handle(got, ref)
    assert got.config.adj_norm == "none"  # the exporter bakes no norm


@pytest.mark.parametrize("form", [
    dict(), dict(bidir_as_pair=True), dict(bidir_as_revseq=True),
    dict(adj_norm="sym"), dict(adj_norm="row"),
    dict(weights_as_inputs=True)])
def test_load_model_handle_on_tf2onnx_graph(tmp_path, form):
    """The published weights' graph pattern (tf2onnx opset 15, Keras
    Bidirectional LSTM, Gemm dense layers, exporter noise)."""
    cfg = jax_deepfri.GCNConfig(**SMALL, adj_norm="none",
                                lm_bidirectional=True)
    path = tmp_path / "gcn_tf2onnx.onnx"
    export_gcn_tf2onnx_style(_params(cfg, seed=1), cfg, str(path), **form)
    pj = _params_json(tmp_path, "gcn_tf2onnx")
    ref = jax_registry.load_model_handle("gcn", "bp", path, pj)
    got = registry.load_model_handle("gcn", "bp", path, pj)
    _assert_same_handle(got, ref)
    assert got.config.adj_norm == form.get("adj_norm", "none")
    assert got.config.lm_bidirectional


def test_concat_merge_is_refused(tmp_path):
    cfg = jax_deepfri.GCNConfig(**SMALL, adj_norm="none")
    path = tmp_path / "gcn_concat.onnx"
    export_gcn_tf2onnx_style(_params(cfg), cfg, str(path),
                             embed_merge="concat")
    with pytest.raises(ValueError, match="merge"):
        registry.load_model_handle("gcn", "mf", path,
                                   _params_json(tmp_path, "gcn_concat"))


@pytest.mark.parametrize("init_kw", [{}, {"gc_bias": True,
                                          "lm_embed_bias": True}])
def test_export_is_byte_identical(tmp_path, init_kw):
    cfg = jax_deepfri.GCNConfig(**SMALL, pool="mean")
    params = _params(cfg, seed=2, **init_kw)
    jax_onnx.export_gcn_to_onnx(params, cfg, str(tmp_path / "jax.onnx"))
    onnx_import.export_gcn_to_onnx(params, deepfri.GCNConfig(
        **dataclasses.asdict(cfg)), str(tmp_path / "port.onnx"))
    assert ((tmp_path / "port.onnx").read_bytes()
            == (tmp_path / "jax.onnx").read_bytes())
    graph = load_onnx(str(tmp_path / "port.onnx"))
    assert onnx_import.infer_n_labels(graph) == N_LABELS
    assert onnx_import.detect_gcn_pool(graph) == "mean"
    assert onnx_import.detect_embedding_merge(graph) == "add"


def _assert_trees_equal(a, b):
    leaves_b, def_b = jax.tree_util.tree_flatten(b)
    assert jax.tree_util.tree_structure(a) == def_b
    for x, y in zip(jax.tree_util.tree_leaves(a), leaves_b, strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoints_cross_load(tmp_path, direction):
    jcfg = jax_deepfri.GCNConfig(**SMALL, lm_bidirectional=True)
    cfg = deepfri.GCNConfig(**dataclasses.asdict(jcfg))
    params = _params(jcfg, seed=3, gc_bias=True)
    port_path, jax_path = tmp_path / "port.npz", tmp_path / "jax.npz"
    # JAX tree → trainable port tensors → numpy → .npz
    registry.save_checkpoint(port_path, cfg, gcn_params_to_numpy(
        gcn_params_from_numpy(params, "cpu", requires_grad=True)))
    jax_registry.save_checkpoint(jax_path, jcfg, params)
    assert ((tmp_path / "port_config.json").read_text()
            == (tmp_path / "jax_config.json").read_text())
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
    if direction == "port_to_jax":
        got_cfg, got = jax_registry.load_checkpoint(port_path)
        assert got_cfg == jcfg
    else:
        got_cfg, got = registry.load_checkpoint(jax_path)
        assert got_cfg == cfg
    _assert_trees_equal(got, params)


def test_npz_handle_and_cnn_refusal(tmp_path):
    cfg = deepfri.GCNConfig(**SMALL)
    params = _params(jax_deepfri.GCNConfig(**SMALL), seed=4)
    registry.save_checkpoint(tmp_path / "gcn_mf.npz", cfg, params)
    pj = _params_json(tmp_path, "gcn_mf")
    handle = registry.load_model_handle("gcn", "mf", tmp_path / "gcn_mf.npz",
                                        pj)
    assert handle.config == cfg and handle.goterms == GOTERMS
    _assert_trees_equal(handle.params, params)
    # a GCN checkpoint is refused as a CNN, and a CNN one loads as a CNN
    with pytest.raises(ValueError, match="GCNConfig"):
        registry.load_model_handle("cnn", "mf", tmp_path / "gcn_mf.npz", pj)
    cnn_cfg = tmp_path / "cnn_config.json"
    cnn_cfg.write_text(json.dumps({"__class__": "CNNConfig", "n_labels": 3}))
    np.savez(tmp_path / "cnn.npz", x=np.zeros(1))
    got_cfg, got = registry.load_checkpoint(tmp_path / "cnn.npz")
    assert got_cfg == deepfri.CNNConfig(n_labels=3)
    np.testing.assert_array_equal(got["x"], np.zeros(1))


def test_utils_match_jax(tmp_path):
    from metagenomic_deepfri_tpu import utils as jax_utils

    name = "gcn_mf.onnx"
    cfg = jax_deepfri.GCNConfig(**SMALL)
    jax_onnx.export_gcn_to_onnx(_params(cfg), cfg, str(tmp_path / name))
    pj = _params_json(tmp_path, "gcn_mf")
    (tmp_path / "model_config.json").write_text(json.dumps(
        {"gcn": {"mf": name}, "cnn": {}, "version": "1.1"}))
    assert (load_deepfri_config(tmp_path)
            == jax_utils.load_deepfri_config(tmp_path))
    assert get_json_values(pj, "goterms") == GOTERMS
    with pytest.raises(AssertionError, match="not found"):
        load_deepfri_config(tmp_path / "nowhere")
    pj.unlink()
    with pytest.raises(AssertionError, match="missing mf model config"):
        load_deepfri_config(tmp_path)
