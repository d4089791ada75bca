"""On the card: the exact all-pairs N-body cell end to end in a short
traced window, correct, its two per-layer metrics in the line, one B5
step at 131,072 bodies against the reference within the limits, and both
of the all-pairs check's controls refused (test_perfbench_cuda.py runs
every cell untraced too). Skips where torch sees no CUDA device.

    python3 -m pytest perfbench/tests/test_perfbench_brute_cuda.py -q \
        -m cuda -p no:cacheprovider
"""

import pytest
import torch

from perfbench import spec
from perfbench.checks import nbody_brute as check
from perfbench.tests.test_perfbench_cuda import card, command

CELL = "nbody.brute131k"
METRICS = {"brute_force_device_ms_per_frame", "b5_roofline"}


@pytest.mark.cuda
def test_cell_traced():
    """A traced run: correct with every number under the configuration's
    limit, B5 launched in every step, the two metrics read."""
    card()
    c = spec.Cell(spec.load_benchmark(), CELL)
    line = command("--workload", CELL, "--seed", str(2**31 + 261),
                   "--seconds", "4", "--trace", "1")[-1]
    assert line["correct"] and line["failed"] == 0
    limits = c.config["correct_limits"]
    assert {k: v["limit"] for k, v in line["checks"].items()} == limits
    assert line["checks"]["steps_not_run"]["value"] == 0
    assert set(line["metrics"]) == METRICS == {m["name"] for m in c.per_layer}
    assert 0 < line["metrics"]["b5_roofline"]["value"] <= 100


@pytest.mark.cuda
def test_one_b5_step_within_the_limits():
    """The Experiment's first theta-0 step at 131,072 bodies, two B5
    launches, against the reference."""
    card()
    from rustexp_tpu_torch.ops import nbody_pallas

    c = spec.Cell(spec.load_benchmark(), CELL)
    dev = torch.device("cuda", 0)
    entry = c.entry().Entry(c.config, c.traffic, dev, seed=2**31 + 262)
    before = nbody_pallas.forces_pallas_cuda.launches
    (prev, after), _ = entry.frame(0.0)
    assert nbody_pallas.forces_pallas_cuda.launches - before == 2
    got = check.compare(c.config, prev, after, 0)
    limits = c.config["correct_limits"]
    for k in check.NAMES:
        assert got[k] <= limits[k], (k, got)
    entry.close()


@pytest.mark.cuda
def test_controls_refused_on_the_card():
    card()
    lines = command("--workload", CELL, "--seeds", str(2**31 + 263),
                    "--seconds", "1", module="perfbench.control_brute")
    assert len(lines) == 2 and not any(x["correct"] for x in lines)
