"""setup_host_ms_per_frame: the host ms the program spent in its span
raster.setup (transform, triangle setup and attribute channels; its own
spans, rustexp_tpu_torch/core/trace.py) over its `frame` spans, whole
process totals read at the end of the run. None where the program has no
spans or the span never ran. Layer: setup. Moves frame_ms."""

SPAN = "raster.setup"


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
