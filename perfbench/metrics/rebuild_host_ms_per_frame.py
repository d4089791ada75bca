"""rebuild_host_ms_per_frame: the host ms the Experiment spent rebuilding
a stale structure (its span experiment.rebuild: the queue or bins built
again at the frame's eye, their host reads included; rustexp_tpu_torch/
core/trace.py) over its `frame` spans, whole process totals read at the
end of the run; 0 where no frame went stale. None where the program has
no spans or the Experiment never read a stale flag (sync.read.stale).
Layer: structure build. Moves frame_ms."""


def read(t):
    try:
        from rustexp_tpu_torch.core.trace import span_totals
    except ImportError:
        return None
    tot = span_totals()
    frames = tot.get("frame", (0, 0))[0]
    if not frames or "sync.read.stale" not in tot:
        return None
    return tot.get("experiment.rebuild", (0, 0))[1] / 1e6 / frames
