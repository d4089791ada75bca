"""gol_pack_device_ms_per_frame: the card's ms a profiled step launched
inside the program's spans gol.pack and gol.unpack (ops/gol_bits.py
multi_step_swar: the uint8 grid packed to 32 cells a word before kernel
B4, and unpacked after it), each activity put down to the span around
the runtime call that launched it (perfbench/span_device.py). None where
the program has no such span. Layer: GoL packing. Moves frame_ms."""

from perfbench.span_device import device_s_by_span

SPANS = ("gol.pack", "gol.unpack")


def read(t):
    s = sum(device_s_by_span(t.session, SPANS).values())
    return s * 1e3 / t.session.frames if s > 0 else None
