"""The ``stream_esm2`` and ``stream_dp`` drivers on tiny cells on the CPU:
correct as the program runs, not correct with the control in its place or
with the trunk's output altered underneath, and the new readers read a
value in a traced run and nothing in an untraced one."""

import json
import time

import pytest

from conftest import REPO, tiny_config, tiny_mix, write_root
from portbench import flops, harness

SEED = 2 ** 31 + 23
READERS = ("model.esm_attn_s_per_kp.esm2", "model.esm_ffn_s_per_kp.esm2",
           "kernel.esm_sdpa_roofline", "model_mfu.esm2")


def _esm_config() -> dict:
    config = json.loads((REPO / "portbench" / "configs"
                         / "esm2_650m_set3.json").read_text())
    config.update(embed_dim=32, gc_dims=[16, 16, 16], fc_dims=[32])
    config["esm"].update(layers=2, dim=64, heads=4, ffn=256)
    config["modes"] = {m: t // 50 + 3 for m, t in config["modes"].items()}
    # The tiny widths' scores move less than the published widths' under
    # the same rounding (program gap ~5e-7, TF32 control ~2e-3 here), so
    # the tiny cell's limit lies between its own readings.
    config["limits"] = {"score_gap": 1e-4}
    return config


def _mix(name: str) -> dict:
    mix = json.loads((REPO / "portbench" / "traffic" / f"{name}.json")
                     .read_text())
    mix.update({k: v for k, v in tiny_mix().items()
                if k in ("pool", "sample", "lengths")})
    return mix


@pytest.fixture
def esm_root(tmp_path):
    return write_root(tmp_path, _esm_config(), _mix("stream_esm2"),
                      [("tiny.esm", "tiny", "tinystream")],
                      like="esm2_set3.stream")


@pytest.fixture
def dp_root(tmp_path):
    return write_root(tmp_path, tiny_config(), _mix("stream_dp4"),
                      [("tiny.dp", "tiny", "tinystream")],
                      like="set3.stream")


def _run(root, cell, trace=False, control=False):
    return harness.run_cell(root, cell, SEED, 0.5, trace, "cpu",
                            time.perf_counter(), control=control)


def test_esm_cell_correct(esm_root):
    out = _run(esm_root, "tiny.esm")
    assert out["correct"], out["checks"]
    rec = out["record"]
    assert rec["attempted"] > 0 and rec["completed"] == rec["attempted"]
    assert set(out["metrics"]) == {"setup_s", "stream_proteins_per_s"}
    assert out["checks"]["score_gap"]["value"] < 1e-5


def test_esm_control_fails(esm_root):
    out = _run(esm_root, "tiny.esm", control=True)
    limit = out["checks"]["score_gap"]["limit"]
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > limit
    assert out["record"]["program_gap"] < limit


def test_altered_trunk_output_is_not_correct(esm_root, monkeypatch):
    from metagenomic_deepfri_tpu_torch.models import deepfri

    real = deepfri.esm2_forward
    monkeypatch.setattr(deepfri, "esm2_forward",
                        lambda *a, **k: real(*a, **k) * 1.01)
    out = _run(esm_root, "tiny.esm")
    assert not out["correct"]
    assert out["checks"]["missing"]["value"] == 0


def test_slot_budget_other_than_the_engines_stops(esm_root):
    mix = json.loads((esm_root / "portbench" / "traffic"
                      / "tinystream.json").read_text())
    mix["token_slots"] = 65536
    (esm_root / "portbench" / "traffic" / "tinystream.json").write_text(
        json.dumps(mix))
    with pytest.raises(ValueError, match="token slots"):
        _run(esm_root, "tiny.esm")


def test_new_readers_read_traced_runs_only(esm_root, monkeypatch):
    """With a peak for the CPU in the table, each new metric reads a
    value in a traced run (the roofline within (0, 100]), none untraced."""
    monkeypatch.setitem(flops.PEAKS, "cpu",
                        {"flops": 1e12, "bytes_per_s": 1e11})
    traced = _run(esm_root, "tiny.esm", trace=True)
    assert traced["correct"]
    assert set(READERS) <= set(traced["metrics"])
    assert all(traced["metrics"][m]["value"] > 0 for m in READERS)
    assert traced["metrics"]["kernel.esm_sdpa_roofline"]["value"] <= 100
    untraced = _run(esm_root, "tiny.esm")
    assert not set(READERS) & set(untraced["metrics"])


def test_dp_cell_correct_and_control_fails(dp_root):
    """Four CPU replicas: the steady batch is four times one device's and
    the run is correct; the control is not."""
    out = _run(dp_root, "tiny.dp", trace=True)
    assert out["correct"], out["checks"]
    assert out["record"]["batches"][0][0] == 4 * 2048
    assert {"engine.pack_s_per_kp.stream", "engine.unpack_s_per_kp.stream",
            "engine.pad_share.stream"} <= set(out["metrics"])
    control = _run(dp_root, "tiny.dp", control=True)
    assert not control["correct"]
