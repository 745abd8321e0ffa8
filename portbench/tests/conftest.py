"""Fixtures of the benchmark's CPU tests: a root holding a tiny cell.

Run from the repository's root:
``python -m pytest portbench/tests -q -p no:cacheprovider``.
"""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_WIDTHS = dict(lm_hidden=16, embed_dim=32, gc_dims=[16, 16, 16],
                   fc_dims=[32])


def write_root(root: Path, config: dict, mix: dict, cells: list,
               per_layer=None, like: str = "gcn_mf.stream") -> Path:
    """A benchmark root under ``root``: BENCHMARK.json with ``cells``
    ((name, config, mix)), the configuration and the mix as files; the
    metrics of the repository's BENCHMARK.json, those of the cell ``like``
    listed for the new cells."""
    (root / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(config))
    (root / "portbench" / "traffic" / "tinystream.json").write_text(
        json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [c[0] for c in cells]
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t,
                           "chips": 1, "why": "test"} for n, c, t in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"] = names
    bench["per_layer"] += per_layer or []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def tiny_config(name: str = "deepfri_set3", **over) -> dict:
    config = json.loads(
        (REPO / "portbench" / "configs" / f"{name}.json").read_text())
    config.update(TINY_WIDTHS)
    config["modes"] = {m: t // 50 + 3 for m, t in config["modes"].items()}
    config.update(over)
    return config


def tiny_mix(**over) -> dict:
    mix = json.loads((REPO / "portbench" / "traffic" / "stream.json")
                     .read_text())
    mix.update(pool=48, sample=6,
               lengths={"median": 60, "sigma": 0.5, "min": 20, "max": 160})
    mix.update(over)
    return mix


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path, tiny_config(), tiny_mix(),
                      [("tiny.stream", "tiny", "tinystream")])
