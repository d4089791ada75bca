"""Interactive terminal viewer: the engine's "window".

Port of rustexp_tpu/app/viewer.py. It replaces the reference's
GLFW/OpenGL shell (hs-src/Main.hs:48-76, App.hs:155-215) with an ANSI
truecolor terminal renderer: each character cell shows two framebuffer
pixels through the upper-half-block glyph, the status bar mirrors the
reference's overlay (App.hs:106-129), and the reference's keybindings
work unchanged:

  global:  - / =  switch experiment (App.hs:65-66)   ESC ESC quit
           t      screenshot PNG    (App.hs:60-62)   v vsync toggle
  GoL:     r randomize, g gun, a acorn, f spacefill, k ark,
           T/Y steps-per-frame up/down (threads analog)
  N-body:  q orbits-10k, w disk-10k, e orbits-5, x/X dt, a/A theta
  Raster:  m mode, p per-pixel, q/w mesh, a/s shader, z/x envmap, 1/2 bg,
           b benchmark

Everything runs on the card unless ``--device cpu`` asks for the CPU.
On the card a Prewarmer builds the six kernel libraries on its thread
from before the first frame, so a switch of experiment does not wait for
nvcc. The ANSI pump is the Python loop only (the JAX package's optional
native pump is not ported).

Run:  python -m rustexp_tpu_torch.app.viewer [--size 192] [--fps 30]
"""

from __future__ import annotations

import argparse
import copy
import inspect
import json
import select
import sys
import threading
import time

import numpy as np

from ..core.framebuffer import to_rgb8_topleft, write_png
from ..core.platform import require_live_device
from ..core.prewarm import Prewarmer
from ..core import trace
from ..core.timing import FrameTimes, median
from ..runtime import CSRC_DIR, load_kernel_lib


def fb_to_ansi(rgb: np.ndarray) -> str:
    """uint8 RGB [h, w, 3] (top-left origin, even h) -> ANSI half-block
    rows (rustexp_tpu/app/viewer.py:47 fb_to_ansi_py)."""
    h, w, _ = rgb.shape
    top = rgb[0 : h - 1 : 2].astype(np.uint32)
    bot = rgb[1:h:2].astype(np.uint32)
    rows = []
    for y in range(top.shape[0]):
        t, b = top[y], bot[y]
        cells = [
            f"\x1b[38;2;{t[x,0]};{t[x,1]};{t[x,2]}m"
            f"\x1b[48;2;{b[x,0]};{b[x,1]};{b[x,2]}m▀"
            for x in range(w)
        ]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def _experiments(device):
    from ..sims.gol import GoLExperiment
    from ..sims.nbody import NBodyExperiment
    from ..sims.rasterizer import RasterizerExperiment

    return [GoLExperiment(device), NBodyExperiment(device),
            RasterizerExperiment(device)]


def kernel_prewarmer() -> Prewarmer:
    """A Prewarmer with a request in for every kernel library: each is
    built (nvcc, at first use) on its thread. A build that fails there is
    built again, and raises, where the main path first needs it."""
    pw = Prewarmer(lambda name, tick: load_kernel_lib(name))
    for src in sorted(CSRC_DIR.glob("*.cu")):
        pw.request(src.stem, 0.0)
    return pw


class SimWorker:
    """Free-running sim thread: the reference's golWorker + MVar pattern
    (RustGoLExperiment.hs:43-65, 96-108). A dedicated thread steps the
    simulation as fast as the device allows while the render loop shows
    the latest published state. The lock serializes step, read and key
    as the reference's MVar serializes Rust access."""

    def __init__(self, exp, state):
        self.exp = exp
        self._lock = threading.Lock()
        self._state = state
        self._stop = threading.Event()
        self._running = threading.Event()
        self._running.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self._running.wait(timeout=0.5)
            if not self._running.is_set():
                continue  # paused: the current experiment owns the device
            with self._lock:
                self._state = self.exp.step(self._state)
            # Python locks are unfair: without a yield the tight
            # release/reacquire can starve the render thread's read()
            # and key() for many iterations.
            time.sleep(0.001)

    def read(self):
        """A snapshot of the latest published state: a shallow dataclass
        copy taken under the lock. Safe to read at leisure because a step
        rebinds the worker's fields to new tensors and writes into none
        that a snapshot holds (sims/base.py), and a step ends in a
        synchronize, so a published tensor is complete."""
        with self._lock:
            return copy.copy(self._state)

    def key(self, k):
        with self._lock:
            self._state = self.exp.handle_key(self._state, k)

    def pause(self):
        """Stop stepping (keeps the state): the viewer switched away, and
        a background sim must not contend with the active one."""
        self._running.clear()

    def resume(self):
        self._running.set()

    def stop(self):
        self._stop.set()
        self._running.set()
        self._thread.join(timeout=5)


class _RawTerm:
    """Raw, non-blocking stdin for key polling; restores settings on exit.

    When stdin is not a tty (piped or redirected, a headless --frames
    run), key polling is a no-op.
    """

    def __enter__(self):
        self.tty = sys.stdin.isatty()
        if self.tty:
            import termios
            import tty

            self.fd = sys.stdin.fileno()
            self.saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        if self.tty:
            import termios

            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def poll_key(self):
        if not self.tty:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1)
        return None


def run_viewer(size: int = 192, fps: float = 30.0, frames: int | None = None,
               start: int = 2, vsync: bool = True,
               inject_every: tuple[int, str] | None = None,
               report: bool = False, device=None):
    """Main loop (App.hs:196-214): tick, events, draw, present, on
    `device` (the card by default).

    ``report=True`` prints one JSON line of the sustained loop stats (the
    60-ring the header shows, first 3 frames dropped) to stderr at exit,
    with each program span's calls and host ms per viewed frame
    (core/trace.py, totals cleared when the loop starts);
    ``inject_every=(K, ch)`` feeds key ``ch`` through the real key path
    every K frames and records keypress-to-presented-frame latency.
    Returns the frames presented.
    """
    dev = require_live_device("cuda" if device is None else str(device))
    prewarm = kernel_prewarmer() if dev.type == "cuda" else None
    exps = _experiments(dev)
    cur = start  # the reference starts on the rasterizer (App.hs:163)
    states = [None] * len(exps)
    workers = [None] * len(exps)  # free-running sims (GoL: decoupled)
    t0 = time.perf_counter()
    frame = 0
    shot = 0

    def ensure(i):
        if states[i] is None:
            states[i] = exps[i].init()
        if workers[i] is None and getattr(exps[i], "decoupled", False):
            workers[i] = SimWorker(exps[i], states[i])
        elif workers[i] is not None:
            workers[i].resume()
        return workers[i]

    def switch(to):
        # pause the outgoing free-runner; ensure() resumes it on return
        if workers[cur] is not None:
            workers[cur].pause()
        return to % len(exps)

    sys.stdout.write("\x1b[2J")  # clear once
    esc_armed = False  # double-ESC guard against an accidental exit
    key_lat: list[float] = []  # keypress -> presented-frame latencies
    # FPS header over a 60-deep ring, the first 3 frames dropped as
    # warm-up outliers (reference App.hs:135-150, 211)
    ftimes = FrameTimes(limit=60)
    trace.reset_spans()
    t_prev = time.perf_counter()
    try:
        with _RawTerm() as term:
            while frames is None or frame < frames:
                tick = time.perf_counter() - t0

                key = term.poll_key()
                t_key = None
                if key is None and inject_every and frame >= 3 \
                        and frame % inject_every[0] == 0:
                    key = inject_every[1]
                    t_key = time.perf_counter()
                if key == "\x1b":
                    if esc_armed:  # a second consecutive ESC exits
                        break
                    esc_armed = True
                elif key:
                    esc_armed = False
                if key == "\x1b":
                    pass
                elif key == "=":
                    cur = switch(cur + 1)
                elif key == "-":
                    cur = switch(cur - 1)
                elif key == "v":
                    vsync = not vsync
                elif key and key != "t":  # 't' screenshots after render
                    w_ = ensure(cur)
                    # raw key: N-body's x/X and a/A are case-sensitive
                    if w_ is not None:
                        w_.key(key)
                    else:
                        states[cur] = exps[cur].handle_key(states[cur], key)

                exp = exps[cur]
                worker = ensure(cur)
                if worker is not None:
                    states[cur] = worker.read()  # the free-runner's latest
                else:
                    states[cur] = exp.step(states[cur])
                if "tick" in inspect.signature(exp.render).parameters:
                    fb = exp.render(states[cur], size, size, tick)
                else:
                    fb = exp.render(states[cur], size, size)
                rgb = to_rgb8_topleft(fb)
                if key == "t":
                    write_png(f"rustexp_shot_{shot:03d}.png", rgb)
                    shot += 1

                t_now = time.perf_counter()
                if frame >= 3:
                    ftimes.push(t_now - t_prev)
                t_prev = t_now
                head = f"{ftimes.status_string()} | " if ftimes.times else ""
                status = f"{head}[{exp.name}] {exp.status(states[cur])}"
                if esc_armed:
                    status = "ESC again to exit | " + status
                if not vsync:
                    status = "VSYNC OFF | " + status
                status = status[: size - 1]
                sys.stdout.write("\x1b[H" + fb_to_ansi(rgb) + "\n\x1b[K"
                                 + status)
                sys.stdout.flush()
                if t_key is not None:
                    key_lat.append(time.perf_counter() - t_key)

                frame += 1
                budget = frame / fps - (time.perf_counter() - t0)
                if vsync and budget > 0:
                    time.sleep(budget)
    finally:
        for w_ in workers:
            if w_ is not None:
                w_.stop()
        if prewarm is not None:
            prewarm.stop()
    sys.stdout.write("\x1b[0m\n")
    if report:
        fps_, med, lo, hi = ftimes.stats()
        rec = {
            "experiment": exps[cur].name,
            "size": size,
            "frames": frame,
            "vsync": vsync,
            "device": str(dev),
            "fps_median": round(fps_, 2),
            "frame_ms_median": round(med * 1e3, 3),
            "frame_ms_best": round(lo * 1e3, 3),
            "frame_ms_worst": round(hi * 1e3, 3),
        }
        per = max(frame, 1)
        rec["spans"] = {
            name: {"calls": round(calls / per, 3),
                   "host_ms": round(ns / 1e6 / per, 4)}
            for name, (calls, ns) in sorted(trace.span_totals().items())}
        if key_lat:
            rec["key_to_frame_ms_median"] = round(median(key_lat) * 1e3, 3)
            rec["key_to_frame_ms_worst"] = round(max(key_lat) * 1e3, 3)
            rec["keys_injected"] = len(key_lat)
        print(json.dumps(rec), file=sys.stderr)
    return frame


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or, when asked, the CPU")
    p.add_argument("--size", type=int, default=192,
                   help="square framebuffer edge (terminal needs size x size/2 cells)")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until ESC ESC)")
    p.add_argument("--start", type=int, default=2,
                   help="starting experiment index (0 GoL, 1 NBody, 2 Raster)")
    p.add_argument("--no-vsync", action="store_true",
                   help="uncapped loop (the 'v' toggle, pre-toggled)")
    p.add_argument("--report", action="store_true",
                   help="print one JSON line of sustained loop stats to "
                        "stderr at exit (60-ring, first 3 frames dropped; "
                        "each span's calls and host ms per frame)")
    p.add_argument("--inject-key", default=None, metavar="K:CH",
                   help="feed key CH through the real key path every K "
                        "frames and record keypress-to-frame latency")
    args = p.parse_args(argv)
    inject = None
    if args.inject_key:
        k, _, ch = args.inject_key.partition(":")
        inject = (max(1, int(k)), ch or " ")
    run_viewer(args.size, args.fps, args.frames, args.start,
               vsync=not args.no_vsync, inject_every=inject,
               report=args.report, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
