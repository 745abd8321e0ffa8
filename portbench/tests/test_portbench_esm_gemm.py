"""``kernel.esm_gemm_roofline`` on the tiny ESM-2 cell on the CPU: a value
in (0, 100] in a traced run, where the program's ``model/esm/gemm`` spans
number four a layer and a batch, and nothing in an untraced one."""

import time

import pytest

from conftest import write_root
from portbench import flops, harness
from test_portbench_esm2 import SEED, _esm_config, _mix

METRIC = "kernel.esm_gemm_roofline"


@pytest.fixture
def esm_root(tmp_path):
    return write_root(tmp_path, _esm_config(), _mix("stream_esm2"),
                      [("tiny.esm", "tiny", "tinystream")],
                      like="esm2_set3.stream")


def _run(root, trace):
    return harness.run_cell(root, "tiny.esm", SEED, 0.5, trace, "cpu",
                            time.perf_counter())


def test_gemm_roofline_reads_traced_runs_only(esm_root, monkeypatch):
    monkeypatch.setitem(flops.PEAKS, "cpu",
                        {"flops": 1e12, "bytes_per_s": 1e11})
    traced = _run(esm_root, True)
    assert traced["correct"]
    assert 0 < traced["metrics"][METRIC]["value"] <= 100
    assert traced["metrics"][METRIC]["unit"] == "%"
    assert METRIC not in _run(esm_root, False)["metrics"]
