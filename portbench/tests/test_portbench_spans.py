"""The readers of the program's spans (``span_total``, ``span_share``,
``span_idle``) on synthetic spans and device traces, and in traced tiny
runs of a stream and a pipeline cell."""

import json
import math
import time

import numpy as np
import pytest

from conftest import REPO, tiny_config, write_root
from metagenomic_deepfri_tpu_torch import profiling
from metagenomic_deepfri_tpu_torch.profiling import Span
from portbench import harness
from portbench.trace import DeviceTrace

READERS = {}


def _reader(name):
    if name not in READERS:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            f"test_reader_{name}", REPO / "portbench" / "readers" /
            f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        READERS[name] = mod
    return READERS[name]


def _span(name, start, end, device_s=None, **counts):
    return Span(name, 0, start_ns=start, end_ns=end, counts=counts,
                device_s=device_s, on_device=device_s is not None)


def _trace(window, busy=()):
    tr = DeviceTrace()
    tr.window = window
    tr.dev_start = np.asarray([s for s, _ in busy], np.int64)
    tr.dev_end = np.asarray([e for _, e in busy], np.int64)
    tr.dev_name = ["k"] * len(busy)
    return tr


@pytest.fixture
def recorded(monkeypatch):
    """Replace the program's span buffer with the test's list."""
    got = []
    monkeypatch.setattr(profiling, "spans", lambda: list(got))
    return got


def test_span_total_windows_and_sums(recorded):
    s = 10 ** 9
    recorded += [
        _span("engine/pack", 1 * s, 2 * s),
        _span("engine/pack", 3 * s, 3 * s + s // 2),
        _span("engine/pack", 9 * s, 11 * s),          # ends past the window
        _span("engine/pack", 0, s // 2),               # starts before it
        _span("model/lm", 2 * s, 4 * s, device_s=1.25),
        _span("engine/batch", 2 * s, 5 * s, input_wait_s=0.5),
        _span("engine/batch", 6 * s, 7 * s)]
    record = {"trace": _trace((s, 10 * s)), "completed": 500,
              "attempted": 250}
    read = _reader("span_total").read
    spec = {"span": "engine/pack", "value": "host_s", "per": "completed"}
    assert read(record, spec) == pytest.approx(1000 * 1.5 / 500)
    spec = {"span": "model/lm", "value": "device_s", "per": "completed"}
    assert read(record, spec) == pytest.approx(1000 * 1.25 / 500)
    spec = {"span": "engine/batch", "value": "input_wait_s",
            "per": "attempted"}
    assert read(record, spec) == pytest.approx(1000 * 0.5 / 250)
    assert read(record, {**spec, "span": "nw/rescore"}) is None
    assert read({**record, "trace": None}, spec) is None
    assert read({**record, "trace": DeviceTrace()}, spec) is None
    assert read({**record, "attempted": 0}, spec) is None


def test_readers_give_nothing_for_a_program_without_spans(monkeypatch):
    """The parent program has no ``profiling.spans``: every reader reads
    None and raises nothing."""
    monkeypatch.delattr(profiling, "spans")
    record = {"trace": _trace((0, 100)), "completed": 5}
    assert _reader("span_total").read(record, {
        "span": "engine/pack", "value": "host_s", "per": "completed"}) is None
    assert _reader("span_share").read(record, {
        "span": "engine/batch", "part": "residues",
        "whole": "slots"}) is None
    assert _reader("span_idle").read(record, {
        "spans": ["engine/pack"]}) is None


def test_span_share(recorded):
    recorded += [_span("engine/batch", 10, 20, residues=300, slots=512),
                 _span("engine/batch", 30, 40, residues=100, slots=512),
                 _span("engine/batch", 200, 300, residues=1, slots=10 ** 6)]
    read = _reader("span_share").read
    spec = {"span": "engine/batch", "part": "residues", "whole": "slots"}
    assert read({"trace": _trace((0, 100))}, spec) == pytest.approx(
        100 * (1 - 400 / 1024))
    assert read({"trace": _trace((0, 5))}, spec) is None
    assert read({"trace": None}, spec) is None


def test_span_idle_by_hand(recorded):
    """Window [0, 100]; the device busy on [10, 20] and [30, 60]; the
    engine's host work on [5, 25], [50, 70] and [65, 80] (one overlap):
    inside it 20 + 30 = 50, of which 10 + 10 with the device busy, so idle
    30 % of the window, against 60 % idle in all."""
    recorded += [_span("engine/pack", 5, 25), _span("engine/unpack", 50, 70),
                 _span("engine/emit", 65, 80), _span("model/lm", 0, 100)]
    tr = _trace((0, 100), busy=[(10, 20), (30, 45), (40, 60)])
    record = {"trace": tr}
    spec = {"spans": ["engine/pack", "engine/unpack", "engine/emit"]}
    got = _reader("span_idle").read(record, spec)
    assert got == pytest.approx(30.0)
    whole = _reader("device_idle").read(record, {})
    assert whole == pytest.approx(60.0) and got <= whole
    assert _reader("span_idle").read(record, {"spans": ["nw/rescore"]}) \
        is None
    assert _reader("span_idle").read({"trace": None}, spec) is None


def _values(out, names):
    return {n: out["metrics"][n]["value"] for n in names}


STREAM = ["engine.pack_s_per_kp.stream", "engine.unpack_s_per_kp.stream",
          "engine.pad_share.stream", "device_idle.engine_host.stream",
          "model.lm_s_per_kp.stream", "model.graph_s_per_kp.stream",
          "model.head_s_per_kp.stream"]
PIPELINE = ["pipeline.prefilter_s_per_kq", "pipeline.rescore_s_per_kq",
            "pipeline.traceback_s_per_kq", "pipeline.align_wait_s_per_kq"]


def test_traced_stream_reads_the_spans(tiny_root):
    out = harness.run_cell(tiny_root, "tiny.stream", 2 ** 31 + 7, 0.5, True,
                           "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    got = _values(out, STREAM)
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert 0 < got["engine.pad_share.stream"] < 100
    assert got["device_idle.engine_host.stream"] <= \
        out["metrics"]["device_idle.stream"]["value"]
    untraced = harness.run_cell(tiny_root, "tiny.stream", 2 ** 31 + 7, 0.5,
                                False, "cpu", time.perf_counter())
    assert not set(STREAM) & set(untraced["metrics"])


def test_traced_pipeline_reads_the_spans(tmp_path):
    mix = json.loads((REPO / "portbench" / "traffic" / "pipeline.json")
                     .read_text())
    mix.update(sample_hits=4, sample_others=2, threads=2,
               lengths={"median": 90, "sigma": 0.4, "min": 40, "max": 200})
    config = tiny_config("deepfri_set3", db_structures=40, queries_per_call=9,
                         cnn={"conv_filters": 8, "conv_kernels": [8, 16],
                              "fc_dims": [16]})
    root = write_root(tmp_path, config, {}, [("tiny.pipe", "tiny", "tp")],
                      like="set3.pipeline")
    (root / "portbench" / "traffic" / "tp.json").write_text(json.dumps(mix))
    out = harness.run_cell(root, "tiny.pipe", 2 ** 31 + 29, 0.1, True, "cpu",
                           time.perf_counter())
    assert out["correct"], out["checks"]
    got = _values(out, PIPELINE)
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    search = out["metrics"]["pipeline.search_s_per_kq"]["value"]
    assert (got["pipeline.prefilter_s_per_kq"]
            + got["pipeline.rescore_s_per_kq"]
            + got["pipeline.traceback_s_per_kq"]) <= search
