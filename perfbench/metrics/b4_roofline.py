"""b4_roofline: the least time of one step of the configuration's grid
(perfbench/roofline_gol.py: its words and generations through a 12-gate
circuit, never B4's plan) over kernel B4's device ms a profiled step: its
kernel (csrc/gol_swar.cu swar_kernel, both forms), matched by name
whatever namespace and template arguments the profiler prints with it.
None where B4 did not run. Layer: kernel B4. Moves frame_ms."""

import re

from perfbench import roofline_gol

KERNEL = re.compile(r"(?:.*[\s:])?swar_kernel(?:<[^>]*>)?\(.*\)")


def read(t):
    s = sum(e.time_range.end - e.time_range.start
            for e in t.session.device if KERNEL.fullmatch(e.name)) / 1e6
    if s <= 0:
        return None
    bound, _ = roofline_gol.step_bound_s(t.cell.config)
    return 100.0 * bound / (s / t.session.frames)
