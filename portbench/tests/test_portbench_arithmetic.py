"""The model-FLOP, roofline and trace arithmetic on hand-worked cases."""

import numpy as np
import pytest

from portbench import flops
from portbench.trace import DeviceTrace
from portbench.readers import agg_roofline, device_idle, model_mfu

ONE = dict(vocab=2, lm_hidden=1, lm_layers=1, embed_dim=1, gc_dims=[1],
           fc_dims=[1], modes={"a": 1, "b": 2}, share_trunk=True,
           cnn={"conv_filters": 1, "conv_kernels": [2], "fc_dims": [1]})
CHIP = {"flops": 1.0, "bytes_per_s": 1.0}


def test_gcn_flops_by_hand():
    # LSTM 3·2·2·4 + 3·2·1·4, lm_embed 3·2·1·1, aa_embed 3·2·2·1
    assert flops.gcn_trunk_flops(ONE, 3) == 48 + 24 + 6 + 12
    # A·X 2·9·1, X·W 2·3·1·1, fc 2·1·1, head 2·1·2·terms
    assert flops.gcn_mode_flops(ONE, 3, 1) == 18 + 6 + 2 + 4
    assert flops.gcn_mode_flops(ONE, 3, 2) == 18 + 6 + 2 + 8
    assert flops.gcn_flops(ONE, 3, ["a", "b"]) == 90 + 30 + 34
    assert flops.gcn_flops(dict(ONE, share_trunk=False), 3,
                           ["a", "b"]) == 2 * 90 + 30 + 34


def test_cnn_flops_by_hand():
    # conv 3·2·2·2·1, fc 2·1·1, head 2·1·2·terms
    assert flops.cnn_flops(ONE, 3, ["a"]) == 24 + 2 + 4


def test_aggregation_bound_by_hand():
    # ops 2·4·3 = 24; bytes 8·2·3 + 13·2 + 4·1 = 78
    assert flops.aggregation_bound_s(2, 4, 1, 3, CHIP) == 78
    assert flops.aggregation_bound_s(2, 100, 1, 3, CHIP) == 600


class _Trace:
    traced = True

    def __init__(self, launches, seconds, busy=1.0, window=4.0):
        self._k, self._busy, self._window = (launches, seconds), busy, window

    def kernel_time(self, names):
        return self._k

    def busy_s(self):
        return self._busy

    def window_s(self):
        return self._window


@pytest.fixture
def chip(monkeypatch):
    monkeypatch.setitem(flops.PEAKS, "test chip", CHIP)


def test_readers_by_hand(chip):
    cfg = dict(ONE, embed_dim=3, gc_dims=[3, 3, 3])
    rec = {"device_kind": "test chip", "config": cfg, "modes": ["a"],
           "batches": [(1, 2, 4)], "trace": _Trace(3, 78 * 3 * 2.0)}
    # three layers at D = 3: 78 bytes each; the kernels took twice that
    assert agg_roofline.read(rec, {"kernels": ["k"]}) == pytest.approx(50.0)
    rec["trace"] = _Trace(4, 1.0)   # a launch too many: nothing to read
    assert agg_roofline.read(rec, {"kernels": ["k"]}) is None
    assert device_idle.read({"trace": _Trace(0, 0)}, {}) == 75.0
    mfu = {"device_kind": "test chip", "config": ONE, "modes": ["a", "b"],
           "lengths": [3], "cnn_lengths": [3], "window_s": 1000.0}
    want = 100.0 * (154 + 30 + 34) / 1000.0
    assert model_mfu.read(mfu, {}) == pytest.approx(want)
    assert model_mfu.read(dict(mfu, device_kind="other"), {}) is None


def test_trace_union_and_gaps():
    tr = DeviceTrace()
    tr.window = (0, 10_000_000_000)
    tr.dev_start = np.array([0, 1, 5], np.int64) * 10 ** 9
    tr.dev_end = np.array([2, 3, 6], np.int64) * 10 ** 9
    tr.dev_name = ["k1", "k2", "k1"]
    tr.samples = [(t * 10 ** 8, name) for t, name in
                  [(35, "copy"), (40, "copy"), (45, "pack"), (70, "pack"),
                   (80, "pack"), (95, "copy")]]
    assert tr.busy_s() == 4.0
    assert tr.idle_gaps() == [["pack", 4.0], ["copy", 2.0]]
    assert tr.kernel_time(["k1"]) == (2, 3.0)
    assert tr.device_ops() == [["k1", 3.0], ["k2", 2.0]]
