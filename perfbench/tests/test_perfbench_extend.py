"""A configuration, a traffic mix and a per-layer metric added with new
files and new BENCHMARK.json entries alone, on a copy of the benchmark:
no file that was there is edited, and the harness finds all three. Also
a simulation cell with no mesh, camera or sky: its configuration, check,
traffic and entry (perfbench/tests/sim_cell/) added as new files, run
on the CPU, and refused with a fault planted in its steps."""

import hashlib
import io
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]
SIM = Path(__file__).resolve().parent / "sim_cell"
SIM_FILES = ["configs/life64.json", "traffic/life_steps.json",
             "entries/life_step.py", "checks/life.py"]


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def copy_benchmark(tmp_path: Path) -> dict:
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return digests(tmp_path)


def test_add_config_traffic_and_metric(tmp_path):
    before = copy_benchmark(tmp_path)

    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "rast512_cube_p.json").read_text())
    cfg.update(name="rast512_cube_p_bg3", background=3)
    (pb / "configs" / "rast512_cube_p_bg3.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "viewer_orbit.json").read_text())
    traffic.update(fps=30, sample_frames=3)
    (pb / "traffic" / "viewer_orbit_30fps.json").write_text(
        json.dumps(traffic))
    (pb / "metrics" / "device_ms_per_op.py").write_text(
        "def read(t):\n"
        "    n = len(t.session.device)\n"
        "    return t.session.busy_s() * 1e3 / n if n else None\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "rast512_cube_p_bg3", "source": "https://example.org/x",
        "file": "perfbench/configs/rast512_cube_p_bg3.json", "reduced": [],
        "why": "a test configuration"})
    bench["workloads"].append({
        "name": "rast512.cube_p_bg3.orbit30", "config": "rast512_cube_p_bg3",
        "traffic": "viewer_orbit_30fps", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "device_ms_per_op", "unit": "ms/op", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "frame_ms",
        "workloads": ["rast512.cube_p_bg3.orbit30"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digests(tmp_path)
    changed = [k for k in before if after[k] != before[k]]
    assert changed == ["BENCHMARK.json"]
    assert set(after) - set(before) == {
        "perfbench/configs/rast512_cube_p_bg3.json",
        "perfbench/traffic/viewer_orbit_30fps.json",
        "perfbench/metrics/device_ms_per_op.py"}

    cell = spec.Cell(spec.load_benchmark(tmp_path),
                     "rast512.cube_p_bg3.orbit30", tmp_path)
    assert cell.config["background"] == 3 and cell.traffic["fps"] == 30
    assert "device_ms_per_op" in [m["name"] for m in cell.per_layer]
    ev = SimpleNamespace(time_range=SimpleNamespace(start=0.0, end=4.0))
    fake = SimpleNamespace(session=SimpleNamespace(
        device=[ev, ev], busy_s=lambda: 4e-6))
    assert cell.metric_reader("device_ms_per_op")(fake) == 2e-3

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, 99, 0.3, False, torch.device("cpu"),
                          time.perf_counter(), out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"], err.getvalue()


def add_sim_cell(tmp_path: Path) -> None:
    """The Life cell's files and BENCHMARK.json entries, on the copy."""
    for f in SIM_FILES:
        (tmp_path / "perfbench" / f).parent.mkdir(exist_ok=True)
        shutil.copy(SIM / f, tmp_path / "perfbench" / f)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "life64", "source": "https://example.org/life",
        "file": "perfbench/configs/life64.json", "reduced": [],
        "why": "a test configuration with no mesh, camera or sky"})
    bench["workloads"].append({
        "name": "life64.steps", "config": "life64", "traffic": "life_steps",
        "chips": 1, "why": "a test cell: one Life step a frame"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def run_sim(tmp_path: Path, entry=None):
    cell = spec.Cell(spec.load_benchmark(tmp_path), "life64.steps", tmp_path)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, 2**31 + 21, 0.3, False, torch.device("cpu"),
                          time.perf_counter(), entry=entry, out=out, err=err)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


def test_add_a_simulation_cell(tmp_path):
    before = copy_benchmark(tmp_path)
    add_sim_cell(tmp_path)
    after = digests(tmp_path)
    assert [k for k in before if after[k] != before[k]] == ["BENCHMARK.json"]
    assert set(after) - set(before) == {f"perfbench/{f}" for f in SIM_FILES}

    cell = spec.Cell(spec.load_benchmark(tmp_path), "life64.steps", tmp_path)
    names = {m["name"] for m in cell.per_layer}
    assert not names & {"setup_host_ms_per_frame", "shade_host_ms_per_frame"}
    rc, line, err = run_sim(tmp_path)
    assert rc == 0 and line["correct"] and line["failed"] == 0, err
    assert line["attempted"] > 4
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert line["checks"] == {"cells_off": {"value": 0, "limit": 0},
                              "steps_not_run": {"value": 0, "limit": 0}}
    assert err.strip().splitlines()[-3].startswith("sampled steps [")


class BrokenLife:
    """The Life cell's own entry with its steps broken as `how` says."""

    def __init__(self, tmp_path: Path, how: str):
        cell = spec.Cell(spec.load_benchmark(tmp_path), "life64.steps",
                         tmp_path)
        self.inner = cell.entry().Entry(cell.config, cell.traffic,
                                        torch.device("cpu"), seed=5)
        self.how, self.first = how, None

    def launches(self):
        return self.inner.launches()

    def frame(self, tick):
        if self.how == "frozen" and self.first is not None:
            return self.first  # step 1 handed back again, nothing run
        (before, after), flag = self.inner.frame(tick)
        if self.how == "frozen":
            self.first = (before, after), flag
        elif self.how == "altered":  # one cell mis-written
            after = after.clone()
            after[7, 9] ^= 1
        return (before, after), flag

    def start_counting(self):
        pass

    def stop_counting(self):
        return None

    def close(self):
        pass


@pytest.mark.parametrize("how,number", [("frozen", "steps_not_run"),
                                        ("altered", "cells_off")])
def test_broken_simulation_is_not_correct(tmp_path, how, number):
    copy_benchmark(tmp_path)
    add_sim_cell(tmp_path)
    rc, line, err = run_sim(tmp_path, BrokenLife(tmp_path, how))
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] > 0
    assert line["checks"][number]["value"] > 0, err


def test_configuration_without_check_is_refused(tmp_path):
    copy_benchmark(tmp_path)
    add_sim_cell(tmp_path)
    path = tmp_path / "perfbench" / "configs" / "life64.json"
    cfg = json.loads(path.read_text())
    del cfg["check"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match='"check"'):
        spec.Cell(spec.load_benchmark(tmp_path), "life64.steps", tmp_path)
