"""The benchmark's core: find a cell's files by name, run its driver, read
its metrics, judge its output, print the result.

Everything a cell needs is found by name under ``<root>/portbench/``:

- ``BENCHMARK.json`` (at ``<root>``) names the cell's configuration and
  traffic mix and lists the metrics;
- ``configs/<file>``: the configuration (the ``file`` of its entry);
- ``traffic/<mix>.json``: the mix, whose ``driver`` names
  ``drivers/<driver>.py``;
- ``metrics/<metric>.json``: each metric, whose ``reader`` names
  ``readers/<reader>.py``.

Drivers and readers are looked for under ``<root>/portbench/`` first and
then beside this file, so a new cell, configuration, mix or metric is a new
file. A driver's ``run(ctx)`` returns a record (a dict) of what the run
measured; a reader's ``read(record, spec)`` returns a metric's value or
None when the run gave it nothing to read.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Modules that must not be loaded in a run, by whole top-level name: JAX
# and the JAX package that the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "metagenomic_deepfri_tpu")


class Cell:
    """One cell's entries and files, read from a root."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(self.file(
            "traffic", self.entry["traffic"] + ".json").read_text())

    def file(self, kind: str, name: str) -> Path:
        """``portbench/<kind>/<name>`` under the root, else beside this
        file."""
        for base in (self.root / "portbench", HERE):
            path = base / kind / name
            if path.is_file():
                return path
        raise FileNotFoundError(f"portbench/{kind}/{name}")

    def module(self, kind: str, name: str):
        path = self.file(kind, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in a run with or without
        the trace: those that list it, or that list no cells and move (or
        are) an end-to-end metric that it reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def read(self, entry: dict, record: dict):
        spec = json.loads(self.file(
            "metrics", entry["name"] + ".json").read_text())
        value = self.module("readers", spec["reader"]).read(record, spec)
        if value is None:
            return None
        return {"value": float(value), "unit": spec["unit"]}


class Context:
    """What a driver is given: the cell, the run's arguments, the device,
    and :meth:`started`, to be called when the measured window opens."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, control: bool = False):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start, self.control = device, t_start, control
        self.setup_s = None

    def started(self) -> float:
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        return now


def _device_kind(device: str) -> str:
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False,
             traffic: dict | None = None) -> dict:
    """Run one cell; returns ``{"record", "metrics", "checks", "correct"}``.
    ``traffic`` overrides parameters of the mix (a rate sweep). Off the
    card only tests call this (with ``device="cpu"``)."""
    cell = Cell(root, name)
    cell.traffic.update(traffic or {})
    ctx = Context(cell, seed, seconds, trace, device, t_start, control)
    driver = cell.module("drivers", cell.traffic["driver"])
    record = driver.run(ctx)
    record.setdefault("setup_s", ctx.setup_s)
    record["device_kind"] = _device_kind(device)
    metrics = {}
    for entry in cell.metrics(trace):
        got = cell.read(entry, record)
        if got is not None:
            metrics[entry["name"]] = got
    checks = record["checks"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return {"record": record, "metrics": metrics, "checks": checks,
            "correct": correct, "cell": cell}


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: Path, t_start: float) -> int:
    args = _args(argv)
    import torch

    cell = Cell(root, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", t_start)
    found = loaded_forbidden()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 4
    record = out["record"]
    device = {"platform": "gpu", "kind": record["device_kind"],
              "count": chips,
              "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": out["correct"], "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": out["metrics"],
              "device": device}
    tr = record.get("trace")
    if args.trace:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s()
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = out["checks"]
    for name, value in record.get("notes", {}).items():
        print(f"note {name}: {value!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
