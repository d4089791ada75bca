"""A configuration, a traffic mix and a per-layer metric added with new
files and new BENCHMARK.json entries alone, on a copy of the benchmark:
no file that was there is edited, and the harness finds all three."""

import hashlib
import io
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from perfbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_add_config_traffic_and_metric(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digests(tmp_path)

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
