"""A run loads neither JAX nor the JAX package, and the command refuses to
run without the card."""

import json
import subprocess
import sys

from conftest import REPO

_RUN_TINY = """
import sys, time, json, tempfile
from pathlib import Path
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/portbench/tests")
from conftest import tiny_config, tiny_mix, write_root
from portbench import harness
root = write_root(Path(tempfile.mkdtemp()), tiny_config(), tiny_mix(),
                  [("tiny.stream", "tiny", "tinystream")])
out = harness.run_cell(root, "tiny.stream", 3, 0.3, True, "cpu",
                       time.perf_counter())
print(json.dumps({"correct": out["correct"],
                  "forbidden": harness.loaded_forbidden(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _RUN_TINY, str(REPO)],
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["forbidden"] == []
    assert "metagenomic_deepfri_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "metagenomic_deepfri_tpu"} & set(
        got["tops"])


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "metagenomic_deepfri_tpu_torch.x",
                        sys.modules["json"])
    assert "metagenomic_deepfri_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    assert harness.loaded_forbidden() == ["jax"]


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits with 3 and prints nothing."""
    import torch

    if torch.cuda.is_available():
        return
    run = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"),
                          "--workload", "gcn_mf.stream", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path)
    assert run.returncode == 3 and run.stdout == ""
