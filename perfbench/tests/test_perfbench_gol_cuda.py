"""On the card: the Game of Life cell end to end in a short traced
window, correct with no static sample, its three per-layer metrics in
the line; kernel B4 at 2048^2 and 64 generations bit-equal to the
reference, through the Experiment's step; and the four controls of the
GoL check refused (test_perfbench_cuda.py runs every cell untraced
too). Skips where torch sees no CUDA device.

    python3 -m pytest perfbench/tests/test_perfbench_gol_cuda.py -q \
        -m cuda -p no:cacheprovider
"""

import pytest
import torch

from perfbench import control_gol, spec
from perfbench.reference import gol as ref
from perfbench.tests.test_perfbench_cuda import card, command

CELL = "gol.2048"
METRICS = {"gol_pack_device_ms_per_frame", "gol_host_ms_per_frame",
           "b4_roofline"}


@pytest.mark.cuda
def test_cell_traced():
    """A traced run: correct, every number at its limit of 0 (no sampled
    step static), B4 launched in every step, the three metrics read."""
    card()
    c = spec.Cell(spec.load_benchmark(), CELL)
    line = command("--workload", CELL, "--seed", str(2**31 + 281),
                   "--seconds", "4", "--trace", "1")[-1]
    assert line["correct"] and line["failed"] == 0
    assert line["checks"] == {k: {"value": 0, "limit": 0} for k in
                              ("cells_off", "static_samples",
                               "steps_not_run")}
    assert set(line["metrics"]) == METRICS == {m["name"] for m in c.per_layer}
    assert 0 < line["metrics"]["b4_roofline"]["value"] <= 100


@pytest.mark.cuda
def test_b4_step_at_2048_equals_reference():
    """The Experiment's step of a 2048^2 soup: B4's four tiled launches of
    16 generations, cell for cell the reference's 64."""
    card()
    from rustexp_tpu_torch.ops import gol_bits

    c = spec.Cell(spec.load_benchmark(), CELL)
    dev = torch.device("cuda", 0)
    entry = c.entry().Entry(c.config, c.traffic, dev, seed=2**31 + 282)
    before = gol_bits.multi_step_packed_cuda.launches
    (prev, after), _ = entry.frame(0.0)
    assert gol_bits.multi_step_packed_cuda.launches - before == 4
    want = ref.run(prev, 64)
    assert torch.equal(after, want) and not torch.equal(want, prev)
    entry.close()


@pytest.mark.cuda
def test_controls_refused_on_the_card():
    card()
    lines = command("--seeds", str(2**31 + 283), "--seconds", "1",
                    module="perfbench.control_gol")
    assert len(lines) == len(control_gol.CONTROLS)
    assert not any(x["correct"] for x in lines)
    assert all(x["checks"]["cells_off"]["value"] > 0 for x in lines)
