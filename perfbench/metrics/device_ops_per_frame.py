"""device_ops_per_frame: the card's activities (kernels, copies, sets)
that torch.profiler recorded over the profiled frames, per frame. Layer:
frame orchestration (each one is a launch the host made). Moves
frame_ms."""


def read(t):
    return len(t.session.device) / t.session.frames
