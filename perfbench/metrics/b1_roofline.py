"""b1_roofline: the least time of one raster call (perfbench/
roofline.py, from the plain reference's set-up at the profiled frames'
eyes) over kernel B1's device ms per launch (torch.profiler, the
activities named below). None where B1 did not run. Layer: kernel B1.
Moves frame_ms."""

KERNELS = ("queue_raster_kernel",)


def read(t):
    seconds, calls = t.session.kernel_s(KERNELS)
    if not calls or seconds <= 0:
        return None
    return 100.0 * t.raster_bound_ms() / (seconds * 1e3 / calls)
