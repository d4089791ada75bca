"""b5_roofline: the least time of one step's all-pairs forces of the
configuration's N (perfbench/roofline_brute.py, never B5's plan) over
kernel B5's device ms a profiled step: its two kernels, the split sums
and their combine (csrc/nbody_forces.cu forces_kernel, combine_kernel),
matched by name whatever namespace the profiler prints before them. None
where B5 did not run. Layer: kernel B5. Moves frame_ms."""

import re

from perfbench import roofline_brute

KERNEL = re.compile(
    r"(?:.*::)?(?:forces_kernel(?:<[^>]*>)?|combine_kernel)\(.*\)")


def read(t):
    s = sum(e.time_range.end - e.time_range.start
            for e in t.session.device if KERNEL.fullmatch(e.name)) / 1e6
    if s <= 0:
        return None
    bound, _ = roofline_brute.force_bound_s(t.cell.config)
    return 100.0 * bound / (s / t.session.frames)
