"""device_idle_pct: the share of a frame's wall time in which the card ran
nothing. 1 - (union of the card's activity intervals per profiled frame,
torch.profiler) / (wall ms per frame of the traced run's unprofiled part,
host clock; the profiler stretches a profiled frame). Layer: device.
Moves frame_ms."""


def read(t):
    busy = t.session.busy_s() * 1e3 / t.session.frames
    if busy <= 0 or t.wall_ms_per_frame <= 0:
        return None
    return (1.0 - busy / t.wall_ms_per_frame) * 100.0
