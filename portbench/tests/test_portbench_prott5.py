"""The ``stream_prott5`` driver on a tiny cell on the CPU: correct as the
program runs, not correct with the control in its place or with the
encoder's output altered underneath; the new readers read a value in a
traced run and nothing in an untraced one; and each reader's and FLOP
count's arithmetic on spans made by hand."""

import json
import time
import types

import pytest

from conftest import REPO, tiny_mix, write_root
from portbench import flops, flops_prott5, harness
from portbench.readers import t5_gemm_roofline, t5_mfu, t5_sdpa_roofline

SEED = 2 ** 31 + 29
READERS = ("model.t5_attn_s_per_kp.prott5", "model.t5_ffn_s_per_kp.prott5",
           "kernel.t5_sdpa_roofline", "kernel.t5_gemm_roofline",
           "model_mfu.prott5")
H100 = "NVIDIA H100 80GB HBM3"


def _t5_config() -> dict:
    config = json.loads((REPO / "portbench" / "configs"
                         / "prott5_xl_u50_set3.json").read_text())
    config.update(embed_dim=32, gc_dims=[16, 16, 16], fc_dims=[32])
    config["t5"].update(layers=2, dim=64, heads=4, d_kv=32, ffn=256)
    config["modes"] = {m: t // 50 + 3 for m, t in config["modes"].items()}
    # The tiny widths' scores move less than the published widths' under
    # the same rounding, so the tiny cell's limit lies between its own
    # readings (program 4e-7 to 1e-6, TF32 control 1.5e-3 to 3.4e-3 here).
    config["limits"] = {"score_gap": 1e-4}
    return config


def _mix() -> dict:
    mix = json.loads((REPO / "portbench" / "traffic" / "stream_prott5.json")
                     .read_text())
    mix.update({k: v for k, v in tiny_mix().items()
                if k in ("pool", "sample", "lengths")})
    return mix


@pytest.fixture
def t5_root(tmp_path):
    return write_root(tmp_path, _t5_config(), _mix(),
                      [("tiny.t5", "tiny", "tinystream")],
                      like="prott5_set3.stream")


def _run(root, trace=False, control=False):
    return harness.run_cell(root, "tiny.t5", SEED, 0.5, trace, "cpu",
                            time.perf_counter(), control=control)


def test_t5_cell_correct(t5_root):
    out = _run(t5_root)
    assert out["correct"], out["checks"]
    rec = out["record"]
    assert rec["attempted"] > 0 and rec["completed"] == rec["attempted"]
    assert set(out["metrics"]) == {"setup_s", "stream_proteins_per_s"}
    assert out["checks"]["score_gap"]["value"] < 1e-5


def test_t5_control_fails(t5_root):
    out = _run(t5_root, control=True)
    limit = out["checks"]["score_gap"]["limit"]
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > limit
    assert out["record"]["program_gap"] < limit


def test_altered_encoder_output_is_not_correct(t5_root, monkeypatch):
    from metagenomic_deepfri_tpu_torch.models import deepfri

    real = deepfri.prott5_forward
    monkeypatch.setattr(deepfri, "prott5_forward",
                        lambda *a, **k: real(*a, **k) * 1.01)
    out = _run(t5_root)
    assert not out["correct"]
    assert out["checks"]["missing"]["value"] == 0


def test_slot_budget_other_than_the_engines_stops(t5_root):
    path = t5_root / "portbench" / "traffic" / "tinystream.json"
    mix = json.loads(path.read_text())
    mix["token_slots"] = 65536
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="token slots"):
        _run(t5_root)


def test_new_readers_read_traced_runs_only(t5_root, monkeypatch):
    """With a peak for the CPU in the table, each new metric reads a value
    in a traced run (the shares within (0, 100]), none untraced."""
    monkeypatch.setitem(flops.PEAKS, "cpu",
                        {"flops": 1e12, "bytes_per_s": 1e11})
    traced = _run(t5_root, trace=True)
    assert traced["correct"]
    assert set(READERS) <= set(traced["metrics"])
    assert all(traced["metrics"][m]["value"] > 0 for m in READERS)
    for m in ("kernel.t5_sdpa_roofline", "kernel.t5_gemm_roofline",
              "model_mfu.prott5"):
        assert traced["metrics"][m]["value"] <= 100
    assert not [m for m in traced["metrics"] if ".esm" in m]
    untraced = _run(t5_root)
    assert not set(READERS) & set(untraced["metrics"])


# -- the readers' arithmetic on spans made by hand ----------------------------

T5 = {"layers": 2, "dim": 64, "heads": 4, "d_kv": 32, "ffn": 256}


def _spans(batches, layers, gemm=4, sdpa=1, device_s=1e-3):
    span = types.SimpleNamespace
    out = []
    for tokens, pairs in batches:
        out.append(span(name="model/lm", device_s=1.0,
                        counts={"tokens": tokens, "attn_pairs": pairs}))
        out += [span(name="model/t5/sdpa", device_s=device_s, counts={})
                for _ in range(sdpa * layers)]
        out += [span(name="model/t5/gemm", device_s=device_s,
                     counts={"rows": 1000, "k": 64, "n": 32, "split": 1})
                for _ in range(gemm * layers)]
    return out


def _record(config=None):
    return {"device_kind": H100, "config": config or {"t5": T5},
            "window_s": 2.0, "modes": [], "lengths": []}


def test_trunk_flops_count_the_inner_width():
    """24·(2·(4·d·I + 2·d·F)·tokens + 4·I·pairs) with I = H·d_kv; at
    ProtT5-XL's widths 2.416 GFLOP a token in the projections."""
    t5 = json.loads((REPO / "portbench" / "configs"
                     / "prott5_xl_u50_set3.json").read_text())["t5"]
    assert flops_prott5.trunk_flops(t5, 1, 0) == pytest.approx(
        24 * 2.0 * (4 * 1024 * 4096 + 2 * 1024 * 16384))
    assert flops_prott5.trunk_flops(t5, 1, 0) / 1e9 == pytest.approx(
        2.416, abs=1e-3)
    assert flops_prott5.trunk_flops(t5, 0, 1) == 24 * 4.0 * 4096
    assert flops_prott5.trunk_flops(T5, 10, 100) == pytest.approx(
        2 * (2.0 * (4 * 64 * 128 + 2 * 64 * 256) * 10 + 4.0 * 128 * 100))


@pytest.mark.parametrize("per_batch,reads", [(4, True), (3, False)])
def test_gemm_roofline_reader(monkeypatch, per_batch, reads):
    got_spans = _spans([(10, 100), (20, 400)], 2, gemm=per_batch)
    monkeypatch.setattr(t5_gemm_roofline.spans, "windowed",
                        lambda rec: got_spans)
    got = t5_gemm_roofline.read(_record(), {"span": "model/t5/gemm"})
    if not reads:
        assert got is None
        return
    want = 100.0 * (2.0 * 1000 * 64 * 32 / 989e12) / 1e-3
    assert got == pytest.approx(want)


@pytest.mark.parametrize("per_layer,reads", [(1, True), (2, False)])
def test_sdpa_roofline_reader(monkeypatch, per_layer, reads):
    """Σ layers × max(4·I·pairs / peak, 16·I·tokens / bandwidth) over the
    spans' device seconds; nothing unless one span a layer and a batch."""
    batches = [(10, 100), (2000, 40000)]
    got_spans = _spans(batches, 2, sdpa=per_layer)
    monkeypatch.setattr(t5_sdpa_roofline.spans, "windowed",
                        lambda rec: got_spans)
    got = t5_sdpa_roofline.read(_record(), {"span": "model/t5/sdpa"})
    if not reads:
        assert got is None
        return
    inner = 128
    bound = 2 * sum(max(4.0 * inner * p / 989e12,
                        16.0 * inner * t / 3.35e12) for t, p in batches)
    assert got == pytest.approx(100.0 * bound / (4 * 1e-3))


def test_mfu_reader(monkeypatch):
    """The encoder's FLOPs from the counters, plus the merge and the tails
    at each finished length, over the window at the peak."""
    config = _t5_config()
    got_spans = _spans([(10, 100), (20, 400)], 2)
    monkeypatch.setattr(t5_mfu.spans, "windowed", lambda rec: got_spans)
    record = _record(config)
    record.update(modes=list(config["modes"]), lengths=[9, 19])
    got = t5_mfu.read(record, {})
    total = flops_prott5.trunk_flops(config["t5"], 30, 500) + sum(
        flops_prott5.junction_flops(config, n)
        + flops_prott5.tails_flops(config, n, record["modes"])
        for n in (9, 19))
    assert got == pytest.approx(100.0 * total / (2.0 * 989e12))
    monkeypatch.setattr(t5_mfu.spans, "windowed", lambda rec: None)
    assert t5_mfu.read(record, {}) is None
