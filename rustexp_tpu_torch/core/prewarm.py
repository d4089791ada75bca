"""Background warm-up of keyed work on a daemon thread.

Port of rustexp_tpu/core/prewarm.py. The JAX package warms XLA programs
there, one per rasterizer or N-body configuration, because each first
compile costs seconds. Eager PyTorch compiles nothing per configuration;
what a user of the port waits for is the first-use nvcc build of the
kernel libraries (runtime.load_kernel_lib, about 3 s for the six). The
viewer hands those builds to a Prewarmer before its first frame
(app/viewer.py). The class is the JAX package's: a caller-supplied warm
function runs ONCE per requested key; `urgent` requests drain before
speculative ones; `mark_warm` records what the caller did itself.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


class Prewarmer:
    """Daemon-thread warm-up of config keys via a caller-supplied fn.

    `warm_fn(cfg, tick)` does the work `cfg` names, discarding the
    result. An exception is swallowed: the warm is only ahead of the main
    path, which does the same work itself when it needs it and raises
    there (runtime.load_kernel_lib caches no failure).
    """

    def __init__(self, warm_fn):
        import queue as _queue
        import threading

        self._warm_fn = warm_fn
        self._urgent: _queue.Queue = _queue.Queue()
        self._spec: _queue.Queue = _queue.Queue()
        self._lock = threading.Lock()
        self._warmed: set = set()
        self._queued: set = set()
        self._stop = threading.Event()
        self._thread = None

    def _start(self):
        import atexit
        import threading

        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
            # Drain at exit, bounded by one in-flight warm, rather than
            # kill the daemon thread in the middle of a build.
            atexit.register(self.stop)

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def is_warm(self, cfg) -> bool:
        with self._lock:
            return cfg in self._warmed

    def request(self, cfg, tick: float, urgent: bool = False):
        with self._lock:
            if cfg in self._warmed or cfg in self._queued:
                return
            self._queued.add(cfg)
        (self._urgent if urgent else self._spec).put((cfg, tick))
        self._start()

    def mark_warm(self, cfg):
        """Record a key whose work the caller itself just did: the main
        path is its own warm-up."""
        with self._lock:
            self._warmed.add(cfg)

    def _run(self):
        import queue as _queue

        while not self._stop.is_set():
            try:
                cfg, tick = self._urgent.get_nowait()
            except _queue.Empty:
                try:
                    cfg, tick = self._spec.get(timeout=0.25)
                except _queue.Empty:
                    continue
            try:
                self._warm_fn(cfg, tick)
            except Exception:
                # the main path repeats the work and raises there
                log.debug("warm of %r failed", cfg, exc_info=True)
            with self._lock:
                self._warmed.add(cfg)
                self._queued.discard(cfg)
