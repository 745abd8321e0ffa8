"""The port's CNN import and export, ``load_models``, the tf2onnx-pattern
writers, the ONNX executor oracle, ``verify_weights`` and its command line,
against the JAX package.

Import must give equal configs and exactly equal parameters; export and the
tf2onnx writers must write the same bytes; the two executors must agree on
every traced tensor within rtol 1e-5 / atol 1e-6, taken per tensor:
max |Δ| ≤ atol + rtol · max |tensor|. (numpy's and XLA's matmuls sum in
different orders, so an element that cancels to near zero carries an
absolute error of the sum's scale, ~1e-6 here, not of its own.)
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from metagenomic_deepfri_tpu import parity as jax_parity
from metagenomic_deepfri_tpu.models import deepfri as jax_deepfri
from metagenomic_deepfri_tpu.models import onnx_import as jax_onnx
from metagenomic_deepfri_tpu.models import onnx_reader as jax_reader
from metagenomic_deepfri_tpu.models import registry as jax_registry
from metagenomic_deepfri_tpu.models import tf2onnx_fixture as jax_tf2onnx
from metagenomic_deepfri_tpu_torch import cli, parity, synthetic
from metagenomic_deepfri_tpu_torch.models import (deepfri, onnx_import,
                                                  onnx_reader, registry,
                                                  tf2onnx_fixture)

REPO = Path(__file__).resolve().parent.parent
GCN = dict(lm_hidden=8, lm_layers=2, embed_dim=16, gc_dims=(8, 12),
           fc_dims=(16,), adj_norm="none")
CNN = dict(conv_filters=8, conv_kernels=(8, 16), fc_dims=(16,))
TERMS = synthetic.goterms(5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gcn(seed=0, n_labels=5, **kw):
    cfg = jax_deepfri.GCNConfig(n_labels=n_labels, **{**GCN, **kw})
    return cfg, _np_tree(jax_deepfri.init_gcn(jax.random.PRNGKey(seed), cfg))


def _cnn(seed=0, n_labels=5, **kw):
    cfg = jax_deepfri.CNNConfig(n_labels=n_labels, **{**CNN, **kw})
    params = _np_tree(jax_deepfri.init_cnn(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for conv in params["conv"]:
        conv["bias"] = rng.normal(0, 0.1, conv["bias"].shape).astype(
            np.float32)
    return cfg, params


def _port_cfg(cfg):
    cls = deepfri.CNNConfig if isinstance(
        cfg, jax_deepfri.CNNConfig) else deepfri.GCNConfig
    return cls(**dataclasses.asdict(cfg))


def _params_json(path: Path):
    pj = path.with_name(path.stem + "_model_params.json")
    pj.write_text(json.dumps({"goterms": TERMS, "gonames": TERMS}))
    return pj


def _assert_same_handle(got, ref):
    assert dataclasses.asdict(got.config) == dataclasses.asdict(ref.config)
    assert type(got.config).__name__ == type(ref.config).__name__
    assert got.goterms == ref.goterms and got.net_type == ref.net_type
    _assert_trees_equal(got.params, ref.params)


def _assert_trees_equal(a, b):
    leaves_b, def_b = jax.tree_util.tree_flatten(b)
    assert jax.tree_util.tree_structure(a) == def_b
    for x, y in zip(jax.tree_util.tree_leaves(a), leaves_b, strict=True):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, np.asarray(y))


# -- CNN import, export and checkpoints ----------------------------------------

@pytest.mark.parametrize("writer", ["export_cnn_to_onnx",
                                    "export_cnn_tf2onnx_style"])
@pytest.mark.parametrize("kernels", [(8, 16), (5,)])
def test_cnn_load_matches_jax(tmp_path, writer, kernels):
    cfg, params = _cnn(seed=1, conv_kernels=kernels, fc_dims=(16, 12))
    path = tmp_path / "cnn.onnx"
    module = jax_onnx if writer == "export_cnn_to_onnx" else jax_tf2onnx
    getattr(module, writer)(params, cfg, str(path))
    pj = _params_json(path)
    ref = jax_registry.load_model_handle("cnn", "bp", path, pj)
    got = registry.load_model_handle("cnn", "bp", path, pj)
    _assert_same_handle(got, ref)
    assert got.config == _port_cfg(cfg)
    graph = onnx_import.normalize_graph(onnx_reader.load_onnx(str(path)))
    assert registry.infer_cnn_config(graph, 5) == got.config


def test_cnn_export_is_byte_identical(tmp_path):
    cfg, params = _cnn(seed=2)
    jax_onnx.export_cnn_to_onnx(params, cfg, str(tmp_path / "jax.onnx"))
    onnx_import.export_cnn_to_onnx(params, _port_cfg(cfg),
                                   str(tmp_path / "port.onnx"))
    assert ((tmp_path / "port.onnx").read_bytes()
            == (tmp_path / "jax.onnx").read_bytes())


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cnn_checkpoints_cross_load(tmp_path, direction):
    cfg, params = _cnn(seed=3)
    registry.save_checkpoint(tmp_path / "port.npz", _port_cfg(cfg), params)
    jax_registry.save_checkpoint(tmp_path / "jax.npz", cfg, params)
    assert ((tmp_path / "port_config.json").read_text()
            == (tmp_path / "jax_config.json").read_text())
    if direction == "port_to_jax":
        got_cfg, got = jax_registry.load_checkpoint(tmp_path / "port.npz")
        assert got_cfg == cfg
    else:
        got_cfg, got = registry.load_checkpoint(tmp_path / "jax.npz")
        assert got_cfg == _port_cfg(cfg)
    _assert_trees_equal(got, params)
    path = tmp_path / ("port.npz" if direction == "port_to_jax"
                       else "jax.npz")
    handle = registry.load_model_handle("cnn", "cc", path, _params_json(
        tmp_path / "cnn.onnx"))
    assert handle.config == _port_cfg(cfg)


# -- the tf2onnx-pattern writers ------------------------------------------------

@pytest.mark.parametrize("form", [
    dict(), dict(bidir_as_pair=True), dict(bidir_as_revseq=True),
    dict(adj_norm="sym"), dict(adj_norm="row"), dict(weights_as_inputs=True),
    dict(embed_merge="concat"), "cnn"])
def test_tf2onnx_writers_byte_identical(tmp_path, form):
    if form == "cnn":
        cfg, params = _cnn(seed=4)
        jax_tf2onnx.export_cnn_tf2onnx_style(params, cfg,
                                             str(tmp_path / "jax.onnx"))
        tf2onnx_fixture.export_cnn_tf2onnx_style(
            params, _port_cfg(cfg), str(tmp_path / "port.onnx"))
    else:
        cfg, params = _gcn(seed=4, lm_bidirectional=True, pool="mean")
        params["gc"][0]["bias"] = np.ones(8, np.float32)
        jax_tf2onnx.export_gcn_tf2onnx_style(params, cfg,
                                             str(tmp_path / "jax.onnx"),
                                             **form)
        tf2onnx_fixture.export_gcn_tf2onnx_style(
            params, _port_cfg(cfg), str(tmp_path / "port.onnx"), **form)
    assert ((tmp_path / "port.onnx").read_bytes()
            == (tmp_path / "jax.onnx").read_bytes())


def _model_set(tmp_path, modes=("bp", "mf")):
    """A weights folder with a GCN and a CNN per mode, written by the
    port; the GCNs share their LSTM-LM."""
    gcn, cnn = {}, {}
    for i, mode in enumerate(modes):
        gcfg, gp = _gcn(seed=10 + i, n_labels=5 + i)
        if gcn:
            gp["lm"] = next(iter(gcn.values()))[1]["lm"]
        ccfg, cp = _cnn(seed=20 + i, n_labels=5 + i)
        terms = synthetic.goterms(5 + i)
        gcn[mode] = (_port_cfg(gcfg), gp, terms)
        cnn[mode] = (_port_cfg(ccfg), cp, terms)
    return synthetic.write_model_set(tmp_path / "weights", gcn, cnn), gcn, cnn


def test_load_models_matches_jax(tmp_path):
    weights, gcn, cnn = _model_set(tmp_path)
    got_gcn, got_cnn, got_config = registry.load_models(weights,
                                                        ["bp", "mf", "cc"])
    ref_gcn, ref_cnn, ref_config = jax_registry.load_models(
        weights, ["bp", "mf", "cc"])
    assert got_config == ref_config
    assert set(got_gcn) == set(got_cnn) == {"bp", "mf"}
    for got, ref, written in ((got_gcn, ref_gcn, gcn),
                              (got_cnn, ref_cnn, cnn)):
        for mode, handle in got.items():
            _assert_same_handle(handle, ref[mode])
            assert handle.config == written[mode][0]
            _assert_trees_equal(handle.params, written[mode][1])


# -- the executor oracle --------------------------------------------------------

def _graph_cases(tmp_path):
    gcfg, gp = _gcn(seed=5)
    bcfg, bp = _gcn(seed=6, lm_bidirectional=True)
    ccfg, cp = _cnn(seed=7)
    writers = {
        "gcn_export": lambda p: jax_onnx.export_gcn_to_onnx(gp, gcfg, p),
        "gcn_tf2onnx": lambda p: jax_tf2onnx.export_gcn_tf2onnx_style(
            gp, gcfg, p, adj_norm="sym"),
        "gcn_tf2onnx_bidir": lambda p: jax_tf2onnx.export_gcn_tf2onnx_style(
            bp, bcfg, p, bidir_as_revseq=True),
        "cnn_export": lambda p: jax_onnx.export_cnn_to_onnx(cp, ccfg, p),
        "cnn_tf2onnx": lambda p: jax_tf2onnx.export_cnn_tf2onnx_style(
            cp, ccfg, p),
    }
    paths = {}
    for name, write in writers.items():
        paths[name] = tmp_path / f"{name}.onnx"
        write(str(paths[name]))
    return paths


@pytest.mark.parametrize("case", ["gcn_export", "gcn_tf2onnx",
                                  "gcn_tf2onnx_bidir", "cnn_export",
                                  "cnn_tf2onnx", "cnn_same_lower"])
def test_executor_matches_jax(tmp_path, case):
    path = _graph_cases(tmp_path)[case.replace("same_lower", "export")]
    ours = onnx_reader.load_onnx(str(path))
    theirs = jax_reader.load_onnx(str(path))
    if case == "cnn_same_lower":
        # both executors pad SAME_LOWER as XLA's SAME (odd element high)
        for graph in (ours, theirs):
            for node in graph.nodes:
                if node.op_type == "Conv":
                    node.attributes["auto_pad"] = b"SAME_LOWER"
    seq, cmap = jax_parity._random_protein(np.random.default_rng(3), 20, 60)
    roles = onnx_import.graph_input_roles(ours)
    feeds = {roles["S"]: jax_onnx_seq2onehot(seq)[None]}
    if case.startswith("gcn"):
        feeds[roles["A"]] = cmap[None]
    got, got_trace = onnx_import.OnnxExecutor(ours).run(feeds, trace=True)
    ref, ref_trace = jax_onnx.OnnxExecutor(theirs).run(feeds, trace=True)
    assert set(got_trace) == set(ref_trace)
    for name, val in [*ref_trace.items(), ("output", ref[0])]:
        val = np.asarray(val)
        ours = got_trace.get(name, got[0])
        assert ours.shape == val.shape, name
        if val.dtype.kind == "f":
            err = float(np.abs(ours - val).max(initial=0.0))
            assert err <= 1e-6 + 1e-5 * float(np.abs(val).max(initial=0.0)), \
                (name, err)
        else:
            np.testing.assert_array_equal(ours, val, name)


def jax_onnx_seq2onehot(seq):
    from metagenomic_deepfri_tpu.ops.one_hot import seq2onehot

    return seq2onehot(seq)


def test_executor_ops_are_numerically_safe():
    x = np.array([[-1000.0, -1.0, 0.0, 1.0, 1000.0]], np.float32)
    with np.errstate(over="raise", invalid="raise"):
        sig = onnx_import._sigmoid(x)
        soft = onnx_import._softmax(x, -1)
    np.testing.assert_allclose(
        sig, 0.5 * (1.0 + np.tanh(x.astype(np.float64) / 2)), rtol=1e-6,
        atol=0)
    assert np.isclose(soft.sum(), 1.0) and soft[0, -1] == 1.0


# -- verify-weights -------------------------------------------------------------

def test_verify_weights_all_ok(tmp_path):
    weights, _, _ = _model_set(tmp_path)
    results = parity.verify_weights(weights, device="cpu", n_proteins=2)
    ref = jax_parity.verify_weights(weights, n_proteins=2)
    assert [(r.net, r.mode) for r in results] == [(r.net, r.mode)
                                                   for r in ref]
    assert len(results) == 4 and all(r.ok for r in results), results
    assert all(r.tolerance == r.logit_tolerance == 1e-4 for r in results)


@pytest.mark.parametrize("net", ["gcn", "cnn"])
def test_localize_divergence_stages_match_jax(tmp_path, net):
    weights, _, _ = _model_set(tmp_path, modes=("mf",))
    model = next(weights.glob(
        ("DeepFRI" if net == "gcn" else "DeepCNN") + "*.onnx"))
    pj = model.with_name(model.stem + "_model_params.json")
    seq, cmap = jax_parity._random_protein(np.random.default_rng(1), 30, 60)
    if net == "cnn":
        cmap = None
    handle = registry.load_model_handle(net, "mf", model, pj)
    got = parity.localize_divergence(net, handle, model, seq, cmap,
                                     device="cpu")
    ref = jax_parity.localize_divergence(
        net, jax_registry.load_model_handle(net, "mf", model, pj), model,
        seq, cmap)
    assert [s for s, _ in got] == [s for s, _ in ref]
    assert got[0][0] == ("embed" if net == "gcn" else "pooled")
    assert all(d <= 1e-4 for _, d in got), got
    # a corrupted layer shows as the first stage that diverges
    layer = handle.params["gc"][1] if net == "gcn" else handle.params["fc"][0]
    layer["kernel"] = layer["kernel"] + np.float32(0.5)
    bad = dict(parity.localize_divergence(net, handle, model, seq, cmap,
                                          device="cpu"))
    first_bad, clean = (("gc1", ("embed", "gc0")) if net == "gcn"
                        else ("fc0", ("pooled",)))
    assert bad[first_bad] > 1e-2 and bad["logits"] > 1e-2
    assert all(bad[s] <= 1e-4 for s in clean)


def test_cli_verify_weights(tmp_path, monkeypatch, capsys):
    weights, _, _ = _model_set(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomic_deepfri_tpu_torch.cli",
         "verify-weights", "-w", str(weights), "--device", "cpu",
         "--n-proteins", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "All 4 models within 0.0001." in proc.stdout
    assert proc.stdout.count("(OK)") == 4

    real_import = registry.import_cnn_params

    def corrupted_head(graph, config):
        params = real_import(graph, config)
        params["head"]["bias"] = params["head"]["bias"] + 0.5
        return params

    monkeypatch.setattr(registry, "import_cnn_params", corrupted_head)
    assert cli.main(["verify-weights", "-w", str(weights), "--device",
                     "cpu", "--n-proteins", "2", "--trace"]) == 1
    out = capsys.readouterr()
    assert out.out.count("(FAIL)") == 2 and "2/4 models exceed" in out.err
    # --device defaults to cuda: without a card, an error naming it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["verify-weights", "-w", str(weights)]) == 1
    assert "Error: --device cuda: cuda not found" in capsys.readouterr().err
