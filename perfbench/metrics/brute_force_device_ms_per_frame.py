"""brute_force_device_ms_per_frame: the card's ms a profiled step
launched inside the program's span nbody.brute (ops/nbody_pallas.py
step_brute_pallas: kernel B5's call and the target-mass multiplies),
each activity put down to the span around the runtime call that launched
it (perfbench/span_device.py). None where the program has no such span.
Layer: brute forces. Moves frame_ms."""

from perfbench.span_device import device_ms_per_frame


def read(t):
    return device_ms_per_frame(t, "nbody.brute")
