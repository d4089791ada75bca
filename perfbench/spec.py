"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the ``file`` of its ``configs`` entry,
whose ``check`` names the comparison that decides ``correct``,
``perfbench/checks/<check>.py``; the traffic mix is
``perfbench/traffic/<traffic>.json``, whose ``entry`` names the entry
``perfbench/entries/<entry>.py``; a per-layer metric is read by
``perfbench/metrics/<name>.py``. Adding a cell, a configuration, its
check, a traffic mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def name_ok(name: str) -> bool:
    return isinstance(name, str) and bool(NAME.match(name))


def unit_ok(unit: str) -> bool:
    return isinstance(unit, str) and bool(UNIT.match(unit))


def bad_names(bench: dict) -> list[str]:
    """Every name, config, traffic, reduced key and unit in `bench` that
    breaks the character rules, as 'where: value'."""
    bad = []
    for c in bench.get("configs", []):
        bad += [f"config: {c.get('name')}"] * (not name_ok(c.get("name")))
        bad += [f"reduced: {k}" for k in c.get("reduced", [])
                if not name_ok(k)]
    for w in bench.get("workloads", []):
        for key in ("name", "config", "traffic"):
            bad += [f"workload {key}: {w.get(key)}"] * (not name_ok(w.get(key)))
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        bad += [f"metric: {m.get('name')}"] * (not name_ok(m.get("name")))
        bad += [f"unit: {m.get('unit')}"] * (not unit_ok(m.get("unit")))
    return bad


def load_benchmark(root: Path = ROOT) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bad = bad_names(bench)
    if bad:
        raise ValueError(f"BENCHMARK.json breaks the name rules: {bad}")
    return bench


def _by_name(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload with everything the harness reads for it."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        self.root = root
        self.workload = _by_name(bench["workloads"], workload, "workload")
        self.name = workload
        cfg_entry = _by_name(bench["configs"], self.workload["config"],
                             "config")
        self.config = json.loads((root / cfg_entry["file"]).read_text())
        if not name_ok(self.config.get("check")):
            raise ValueError(
                f"configuration {cfg_entry['file']}: its \"check\" is "
                f"{self.config.get('check')!r}; it has to name "
                f"perfbench/checks/<check>.py, the module that decides "
                f"`correct` for it")
        self.traffic = json.loads(
            (root / "perfbench" / "traffic"
             / f"{self.workload['traffic']}.json").read_text())
        self.chips = self.workload["chips"]

        def here(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        self.per_layer = [m for m in bench["per_layer"] if here(m)]

    def entry(self):
        """The traffic's entry module, perfbench/entries/<entry>.py."""
        return load_module(self.root / "perfbench" / "entries"
                           / f"{self.traffic['entry']}.py")

    def check(self):
        """The configuration's check module, perfbench/checks/<check>.py:
        check(cell, window, device) -> ({name: (value, limit)}, failed,
        lines for stderr)."""
        return load_module(self.root / "perfbench" / "checks"
                           / f"{self.config['check']}.py")

    def metric_reader(self, name: str):
        """perfbench/metrics/<name>.py's read(trace) function."""
        return load_module(self.root / "perfbench" / "metrics"
                           / f"{name}.py").read


def load_module(path: Path):
    """Import a file by path (a metric's name may hold a dot)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench._by_name." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
