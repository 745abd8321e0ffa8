"""Every cell, configuration, mix and metric file parses and keeps to the
benchmark's rules for names, units and lengths."""

import json
import re

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    groups = [BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"],
              BENCH["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("portbench/")
        config = json.loads((REPO / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert all(k in config for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert "score_gap" in config["limits"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((REPO / "portbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (REPO / "portbench" / "drivers"
                / f"{mix['driver']}.py").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_files_and_coverage():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        spec = json.loads((REPO / "portbench" / "metrics"
                           / f"{m['name']}.json").read_text())
        assert (REPO / "portbench" / "readers"
                / f"{spec['reader']}.py").is_file()
        for key in ("unit", "better", "source", "layer", "moves"):
            assert spec.get(key) == m.get(key), (m["name"], key)
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        mine = [m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", [])]
        assert layer and all(m["moves"] in mine for m in layer)


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_file_names_under_paths():
    for p in (REPO / "portbench").rglob("*"):
        rel = p.relative_to(REPO).as_posix()
        if "__pycache__" in rel or rel.startswith("portbench/cache"):
            continue
        assert PATH.match(rel), rel
