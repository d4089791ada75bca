"""Leveled tracing/logging, and the program's spans.

The logger is a copy of rustexp_tpu/core/trace.py (it imports no jax;
the port keeps its own). It re-expresses the reference's Trace subsystem
(hs-src/Trace.hs): global settings, levels None/Error/Warn/Info, optional
file sink + stdout echo, ANSI-colored level tags, thread-id and timestamp
message header.

The spans are the port's own: ``with span("raster.setup"):`` adds one
call and the host nanoseconds inside (``time.perf_counter_ns``) to
process-wide totals under that name, read by span_totals() and cleared
by reset_spans(). A span's nanoseconds include those of the spans it
encloses. While a torch.profiler session records, a span is also a
record-function range, so it lies among the profiler's host events, on
the clock of the card's activities, with its enclosing span as its
``cpu_parent``. Outside a session a span costs two clock reads and a
dict update. The names are ``frame`` (one per frame of an entry point,
or per step of the N-body or GoL Experiment), ``experiment.*``,
``raster.*``, ``structure.*``, ``nbody.*`` (the N-body step's stages: the
Barnes-Hut route's in ops/nbody_bh.py, the brute route's ``nbody.brute``
and ``nbody.integrate`` in ops/nbody_pallas.py and ops/nbody_forces.py),
``gol.*`` (kernel B4's route in ops/gol_bits.py multi_step_swar:
``gol.pack``, ``gol.swar`` around B4's call, ``gol.unpack``; and the R
key's random fill, ``gol.randomize``, in sims/gol.py) and ``sync.*``: each
``sync.*`` span is one place where the host waits for the card without
an explicit synchronize (a read of a device value, or a pageable
host-to-device copy through upload()).
"""

from __future__ import annotations

import datetime
import enum
import sys
import threading
import time

import torch


class TraceLevel(enum.IntEnum):
    NONE = 0
    ERROR = 1
    WARN = 2
    INFO = 3


_ANSI = {
    TraceLevel.ERROR: "\x1b[31m",  # red
    TraceLevel.WARN: "\x1b[33m",   # yellow
    TraceLevel.INFO: "\x1b[36m",   # cyan
}
_RESET = "\x1b[0m"

_lock = threading.Lock()
_settings = {"level": TraceLevel.WARN, "file": None, "echo": True, "color": True}


def setup(level: TraceLevel = TraceLevel.INFO, file_path: str | None = None,
          echo: bool = True, color: bool = True) -> None:
    with _lock:
        _settings["level"] = level
        _settings["echo"] = echo
        _settings["color"] = color
        if _settings["file"]:
            _settings["file"].close()
            _settings["file"] = None
        if file_path:
            _settings["file"] = open(file_path, "a")


def trace(level: TraceLevel, msg: str) -> None:
    with _lock:
        if level > _settings["level"] or level == TraceLevel.NONE:
            return
        tid = threading.get_ident() % 10000
        ts = datetime.datetime.now().strftime("%H:%M:%S.%f")[:-3]
        tag = level.name
        if _settings["color"]:
            tag = _ANSI.get(level, "") + tag + _RESET
        line = f"{tag} [{tid:04d}] {ts} | {msg}"
        if _settings["echo"]:
            print(line, file=sys.stderr)
        if _settings["file"]:
            _settings["file"].write(line + "\n")
            _settings["file"].flush()


def trace_error(msg: str) -> None:
    trace(TraceLevel.ERROR, msg)


def trace_warn(msg: str) -> None:
    trace(TraceLevel.WARN, msg)


def trace_info(msg: str) -> None:
    trace(TraceLevel.INFO, msg)


def trace_and_raise(msg: str):
    """Reference Trace.hs:111-112."""
    trace_error(msg)
    raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

# name -> [calls, ns]. A plain dict, not locked: two spans that close at
# the same moment on two threads may lose an update. The program opens
# its spans on the thread that renders; the viewer's N-body SimWorker
# opens its steps' spans on its own thread.
_span_totals: dict[str, list[int]] = {}
_profiling = torch.autograd._profiler_enabled
# A function-scope range: one host event. torch.profiler.record_function
# opens a user-scope range, for which the profiler also records a device
# activity (a "gpu_user_annotation") from the range's first launch to its
# last, which a reader of the card's activities would count as busy.
_record = torch._C._profiler._RecordFunctionFast


class span:
    """Context manager: one call and its host ns under `name` (above)."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = _record(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        tot = _span_totals.get(self.name)
        if tot is None:
            _span_totals[self.name] = [1, ns]
        else:
            tot[0] += 1
            tot[1] += ns
        return False


def span_totals() -> dict[str, tuple[int, int]]:
    """A copy of the totals: {name: (calls, ns)}."""
    return {k: (v[0], v[1]) for k, v in list(_span_totals.items())}


def reset_spans() -> None:
    _span_totals.clear()


def upload(name: str, t: torch.Tensor, device) -> torch.Tensor:
    """`t` copied to `device` under the span ``sync.upload.<name>``: from
    pageable host memory the copy makes the host wait for the card's
    queue to drain (one call a copy, whatever the device)."""
    with span("sync.upload." + name):
        return t.to(device)
