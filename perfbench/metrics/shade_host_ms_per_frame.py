"""shade_host_ms_per_frame: the host ms the program spent in its span
raster.shade (vertex colours, the compacted or full-frame shade, the
pack and the cube-map cross; its own spans, rustexp_tpu_torch/core/
trace.py) over its `frame` spans, whole process totals read at the end
of the run. None where the program has no spans or the span never ran.
Layer: shading and pack. Moves frame_ms."""

SPAN = "raster.shade"


def read(t):
    try:
        from rustexp_tpu_torch.core.trace import span_totals
    except ImportError:
        return None
    tot = span_totals()
    frames = tot.get("frame", (0, 0))[0]
    if not frames or SPAN not in tot:
        return None
    return tot[SPAN][1] / 1e6 / frames
