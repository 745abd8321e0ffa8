"""The ``stream_esmc`` driver on a tiny cell on the CPU: correct as the
program runs, not correct with the control in its place or with the
trunk's output altered underneath; the new readers read a value in a
traced run and nothing in an untraced one; each reader's and FLOP count's
arithmetic on spans made by hand; and the configuration and mix files."""

import json
import time
import types

import pytest

from conftest import REPO, tiny_mix, write_root
from portbench import flops, flops_esmc, harness
from portbench.readers import (esmc_qkln_roofline, trunk_gemm_roofline,
                               trunk_mfu, trunk_sdpa_roofline)

SEED = 2 ** 31 + 31
READERS = ("model.esmc_attn_s_per_kp.esmc", "model.esmc_ffn_s_per_kp.esmc",
           "kernel.esmc_sdpa_roofline", "kernel.esmc_gemm_roofline",
           "kernel.esmc_qkln_roofline", "model_mfu.esmc")
# The stream cells' engine, idle and model-step metrics, which list the
# cell beside the LSTM-LM's.
SHARED = ("device_idle.stream", "device_idle.engine_host.stream",
          "engine.pack_s_per_kp.stream", "engine.unpack_s_per_kp.stream",
          "engine.pad_share.stream", "model.lm_s_per_kp.stream",
          "model.graph_s_per_kp.stream", "model.head_s_per_kp.stream")
H100 = "NVIDIA H100 80GB HBM3"
CONFIG = REPO / "portbench" / "configs" / "esmc_600m_set3.json"
MIX = REPO / "portbench" / "traffic" / "stream_esmc.json"


def _esmc_config() -> dict:
    config = json.loads(CONFIG.read_text())
    config.update(embed_dim=32, gc_dims=[16, 16, 16], fc_dims=[32])
    config["esmc"].update(layers=2, dim=128, heads=2, ffn=192)
    config["modes"] = {m: t // 50 + 3 for m, t in config["modes"].items()}
    # The tiny widths' scores move less than the published widths' under
    # the same rounding, so the tiny cell's limit lies between its own
    # readings (program below 1e-6, TF32 control above 1e-3 here).
    config["limits"] = {"score_gap": 1e-4}
    return config


def _mix() -> dict:
    mix = json.loads(MIX.read_text())
    mix.update({k: v for k, v in tiny_mix().items()
                if k in ("pool", "sample", "lengths")})
    return mix


@pytest.fixture
def esmc_root(tmp_path):
    return write_root(tmp_path, _esmc_config(), _mix(),
                      [("tiny.esmc", "tiny", "tinystream")],
                      like="esmc_set3.stream")


def _run(root, trace=False, control=False):
    return harness.run_cell(root, "tiny.esmc", SEED, 0.5, trace, "cpu",
                            time.perf_counter(), control=control)


def test_esmc_cell_correct(esmc_root):
    out = _run(esmc_root)
    assert out["correct"], out["checks"]
    rec = out["record"]
    assert rec["attempted"] > 0 and rec["completed"] == rec["attempted"]
    assert set(out["metrics"]) == {"setup_s", "stream_proteins_per_s"}
    assert out["checks"]["score_gap"]["value"] < 1e-5


def test_esmc_control_fails(esmc_root):
    out = _run(esmc_root, control=True)
    limit = out["checks"]["score_gap"]["limit"]
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > limit
    assert out["record"]["program_gap"] < limit


def test_altered_trunk_output_is_not_correct(esmc_root, monkeypatch):
    import dataclasses

    from metagenomic_deepfri_tpu_torch.models import deepfri

    trunk = deepfri.TRUNKS[deepfri.ESMCGCNConfig]
    monkeypatch.setitem(deepfri.TRUNKS, deepfri.ESMCGCNConfig,
                        dataclasses.replace(trunk, forward=lambda *a, **k:
                                            trunk.forward(*a, **k) * 1.01))
    out = _run(esmc_root)
    assert not out["correct"]
    assert out["checks"]["missing"]["value"] == 0


def test_slot_budget_other_than_the_engines_stops(esmc_root):
    path = esmc_root / "portbench" / "traffic" / "tinystream.json"
    mix = json.loads(path.read_text())
    mix["token_slots"] = 65536
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="token slots"):
        _run(esmc_root)


def test_new_readers_read_traced_runs_only(esmc_root, monkeypatch):
    """With a peak for the CPU in the table, each new metric reads a value
    in a traced run (the shares within (0, 100]), none untraced; so do the
    stream cells' engine, idle and model-step metrics."""
    monkeypatch.setitem(flops.PEAKS, "cpu",
                        {"flops": 1e12, "bytes_per_s": 1e11})
    traced = _run(esmc_root, trace=True)
    assert traced["correct"]
    assert set(READERS) | set(SHARED) <= set(traced["metrics"])
    assert all(traced["metrics"][m]["value"] > 0 for m in READERS)
    for m in READERS[2:]:
        assert traced["metrics"][m]["value"] <= 100
    assert not [m for m in traced["metrics"]
                if ".esm_" in m or ".t5" in m or m.endswith((".esm2",
                                                             ".prott5"))]
    untraced = _run(esmc_root)
    assert not (set(READERS) | set(SHARED)) & set(untraced["metrics"])


# -- the configuration and the mix --------------------------------------------

def test_configuration_at_published_widths():
    """Every width as ``ESMC(d_model=1152, n_heads=18, n_layers=36)``
    builds it, SwiGLU's hidden width by ``swiglu_correction_fn``, nothing
    reduced, and the trunk's parameter count from those widths."""
    from portbench import reference_esmc

    config = json.loads(CONFIG.read_text())
    e, pub = config["esmc"], config["esmc_published"]
    assert e == {"layers": 36, "dim": 1152, "heads": 18, "ffn": 3072,
                 "vocab": 64, "rope_base": 10000.0, "ln_eps": 1e-05}
    assert (pub["n_layers"], pub["d_model"], pub["n_heads"]) == (36, 1152,
                                                                 18)
    assert reference_esmc.swiglu_width(1152) == e["ffn"] == 3072
    assert pub["fc1_width"] == 2 * e["ffn"]
    d, f = e["dim"], e["ffn"]
    assert pub["trunk_parameters"] == (e["layers"] * (4 * d * d + 3 * d * f
                                                      + 6 * d)
                                       + e["vocab"] * d + d)
    assert config["reduced"] == []
    assert {"junction", "tokenizer", "layer_norms", "state_dict", "weights",
            "compute_dtype", "head_init_scale"} <= set(config["assumed"])
    assert config["modes"] == {"bp": 3992, "cc": 320, "mf": 489}


def test_mix_is_the_protein_lm_stream():
    """The mix is ProtT5's and ESM-2's stream, under its own driver."""
    mix = json.loads(MIX.read_text())
    other = json.loads((REPO / "portbench" / "traffic"
                        / "stream_prott5.json").read_text())
    assert mix["driver"] == "stream_esmc"
    for key in ("lengths", "length_seed", "pool", "indel_rate", "sample",
                "token_slots"):
        assert mix[key] == other[key]


# -- the readers' arithmetic on spans made by hand ----------------------------

ESMC = {"layers": 2, "dim": 128, "heads": 2, "ffn": 192}


def _spans(batches, layers, gemm=4, sdpa=1, qkln=1, device_s=1e-3):
    span = types.SimpleNamespace
    out = []
    for tokens, pairs in batches:
        out.append(span(name="model/lm", device_s=1.0,
                        counts={"tokens": tokens, "attn_pairs": pairs}))
        out += [span(name="model/esmc/sdpa", device_s=device_s, counts={})
                for _ in range(sdpa * layers)]
        out += [span(name="model/esmc/qkln", device_s=device_s,
                     counts={"tokens": tokens})
                for _ in range(qkln * layers)]
        out += [span(name="model/esmc/gemm", device_s=device_s,
                     counts={"rows": 1000, "k": 128, "n": 384, "split": 1})
                for _ in range(gemm * layers)]
    return out


def _spec(metric: str) -> dict:
    """The spec of a metric of the cell, as its file gives it."""
    name = {"gemm": "kernel.esmc_gemm_roofline",
            "sdpa": "kernel.esmc_sdpa_roofline", "mfu": "model_mfu.esmc"}
    return json.loads((REPO / "portbench" / "metrics"
                       / f"{name[metric]}.json").read_text())


def _record(config=None):
    return {"device_kind": H100, "config": config or {"esmc": ESMC},
            "window_s": 2.0, "modes": [], "lengths": []}


def test_trunk_flops_of_the_published_widths():
    """36·(2·(4d² + 3dF)·tokens + 4d·pairs): 1.147 GFLOP a token in the
    projections at ESM C 600M's widths, 0.88 of ESM-2 650M's."""
    from portbench import flops_esm2

    e = json.loads(CONFIG.read_text())["esmc"]
    per_token = flops_esmc.trunk_flops(e, 1, 0)
    assert per_token == 36 * 2.0 * (4 * 1152 ** 2 + 3 * 1152 * 3072)
    assert per_token / 1e9 == pytest.approx(1.147, abs=1e-3)
    esm2 = json.loads((REPO / "portbench" / "configs"
                       / "esm2_650m_set3.json").read_text())["esm"]
    assert per_token / flops_esm2.trunk_flops(esm2, 1, 0) == pytest.approx(
        0.884, abs=1e-3)
    assert flops_esmc.trunk_flops(e, 0, 1) == 36 * 4.0 * 1152
    assert flops_esmc.trunk_flops(ESMC, 10, 100) == pytest.approx(
        2 * (2.0 * (4 * 128 ** 2 + 3 * 128 * 192) * 10 + 4.0 * 128 * 100))


@pytest.mark.parametrize("per_batch,reads", [(4, True), (3, False)])
def test_gemm_roofline_reader(monkeypatch, per_batch, reads):
    got_spans = _spans([(10, 100), (20, 400)], 2, gemm=per_batch)
    monkeypatch.setattr(trunk_gemm_roofline.spans, "windowed",
                        lambda rec: got_spans)
    got = trunk_gemm_roofline.read(_record(), _spec("gemm"))
    if not reads:
        assert got is None
        return
    want = 100.0 * (2.0 * 1000 * 128 * 384 / 989e12) / 1e-3
    assert got == pytest.approx(want)


@pytest.mark.parametrize("per_layer,reads", [(1, True), (2, False)])
def test_sdpa_roofline_reader(monkeypatch, per_layer, reads):
    """Σ layers × max(4·d·pairs / peak, 16·d·tokens / bandwidth) over the
    spans' device seconds; nothing unless one span a layer and a batch."""
    batches = [(10, 100), (2000, 40000)]
    got_spans = _spans(batches, 2, sdpa=per_layer)
    monkeypatch.setattr(trunk_sdpa_roofline.spans, "windowed",
                        lambda rec: got_spans)
    got = trunk_sdpa_roofline.read(_record(), _spec("sdpa"))
    if not reads:
        assert got is None
        return
    bound = 2 * sum(max(4.0 * 128 * p / 989e12, 16.0 * 128 * t / 3.35e12)
                    for t, p in batches)
    assert got == pytest.approx(100.0 * bound / (4 * 1e-3))


@pytest.mark.parametrize("per_layer,reads", [(1, True), (2, False)])
def test_qkln_roofline_reader(monkeypatch, per_layer, reads):
    """Σ over the spans of 16·d·tokens / bandwidth, over their device
    seconds; nothing unless one span a layer and a batch."""
    batches = [(10, 100), (2000, 40000)]
    got_spans = _spans(batches, 2, qkln=per_layer)
    monkeypatch.setattr(esmc_qkln_roofline.spans, "windowed",
                        lambda rec: got_spans)
    got = esmc_qkln_roofline.read(_record(), {"span": "model/esmc/qkln"})
    if not reads:
        assert got is None
        return
    bound = 2 * sum(16.0 * 128 * t / 3.35e12 for t, _ in batches)
    assert got == pytest.approx(100.0 * bound / (4 * 1e-3))


def test_qkln_roofline_reader_needs_tokens(monkeypatch):
    got_spans = _spans([(10, 100)], 2)
    for s in got_spans:
        if s.name == "model/esmc/qkln":
            s.counts = {}
    monkeypatch.setattr(esmc_qkln_roofline.spans, "windowed",
                        lambda rec: got_spans)
    assert esmc_qkln_roofline.read(_record(),
                                   {"span": "model/esmc/qkln"}) is None


def test_mfu_reader(monkeypatch):
    """The trunk's FLOPs from the counters, plus the merge and the tails
    at each finished length, over the window at the peak."""
    config = _esmc_config()
    got_spans = _spans([(10, 100), (20, 400)], 2)
    monkeypatch.setattr(trunk_mfu.spans, "windowed", lambda rec: got_spans)
    record = _record(config)
    record.update(modes=list(config["modes"]), lengths=[8, 18])
    got = trunk_mfu.read(record, _spec("mfu"))
    total = flops_esmc.trunk_flops(config["esmc"], 30, 500) + sum(
        flops_esmc.junction_flops(config, n)
        + flops_esmc.tails_flops(config, n, record["modes"])
        for n in (8, 18))
    assert got == pytest.approx(100.0 * total / (2.0 * 989e12))
    monkeypatch.setattr(trunk_mfu.spans, "windowed", lambda rec: None)
    assert trunk_mfu.read(record, _spec("mfu")) is None
