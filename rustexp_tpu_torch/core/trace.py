"""Leveled tracing/logging.

A copy of rustexp_tpu/core/trace.py (it imports no jax; the port keeps
its own). Re-expresses the reference's Trace subsystem (hs-src/Trace.hs):
global settings, levels None/Error/Warn/Info, optional file sink + stdout
echo, ANSI-colored level tags, thread-id and timestamp message header.
"""

from __future__ import annotations

import datetime
import enum
import sys
import threading


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
