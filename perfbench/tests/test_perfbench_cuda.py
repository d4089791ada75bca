"""On the card: each cell's command end to end, untraced and traced, the
control refused, and a frozen frame refused by the kernels' launch
counts. Skips where torch sees no CUDA device.

    python3 -m pytest perfbench/tests -q -m cuda -p no:cacheprovider
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def command(*args, module="perfbench.run"):
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    return [json.loads(x) for x in res.stdout.strip().splitlines()
            if x.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    card()
    c = spec.Cell(spec.load_benchmark(), cell)
    line = command("--workload", cell, "--seed", str(2**31 + 11),
                   "--seconds", "3", "--trace", "0")[-1]
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced(cell):
    card()
    c = spec.Cell(spec.load_benchmark(), cell)
    line = command("--workload", cell, "--seed", str(2**31 + 12),
                   "--seconds", "4", "--trace", "1")[-1]
    assert line["correct"]
    assert set(line["metrics"]) == {m["name"] for m in c.per_layer}
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
    for name, m in line["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100
    assert len(line["breakdown"]["device_ops"]) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_refused_on_the_card(cell):
    card()
    lines = command("--workload", cell, "--seeds", str(2**31 + 13),
                    "--seconds", "1", module="perfbench.control")
    assert lines and not any(x["correct"] for x in lines)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".bench")])
def test_frozen_frame_refused_on_the_card(cell):
    """At a fixed eye a frame returned again is the right picture: only
    the program's launch counts show that nothing was rendered."""
    card()
    import io
    import time

    from perfbench import harness
    from perfbench.tests.test_perfbench_runs import Broken

    dev = torch.device("cuda", 0)
    c = spec.Cell(spec.load_benchmark(), cell)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(c, 2**31 + 14, 2.0, False, dev, time.perf_counter(),
                          entry=Broken(cell, "frozen", dev), out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, err.getvalue()
    assert line["checks"]["px_off"]["value"] == 0
    assert line["checks"]["frames_not_rendered"]["value"] > 0
