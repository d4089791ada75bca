"""device_busy_ms_per_frame: the union of the card's activity intervals
over the profiled frames (torch.profiler), per frame. Layer: device.
Moves frame_ms."""


def read(t):
    busy = t.session.busy_s() * 1e3 / t.session.frames
    return busy if busy > 0 else None
