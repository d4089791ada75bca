"""PyTorch port vs the JAX package: the app shell (ROADMAP A15).

The CLI, the turntable, the viewer and its SimWorker, checkpoints, the
Prewarmer, the device probe, and the core modules they stand on (color
add/unpack, PNG, font, GIF, trace), run on the CPU (``--device cpu``) at
64-128 px. Frames, PNG bytes, GIF bytes and colors are held against the
JAX package's at 0 differing bits; checkpoints resume bit for bit.
"""

import glob
import json
import os
import sys
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.app import animate as janimate
from rustexp_tpu.app import viewer as jviewer
from rustexp_tpu.core import colors as jcolors
from rustexp_tpu.core import font as jfont
from rustexp_tpu.core import framebuffer as jfb
from rustexp_tpu.core import gif as jgif
from rustexp_tpu_torch.app import cli, viewer
from rustexp_tpu_torch.core import colors, font, framebuffer as fbm, gif, trace
from rustexp_tpu_torch.core.checkpoint import load_state, save_state
from rustexp_tpu_torch.core.platform import require_live_device
from rustexp_tpu_torch.core.prewarm import Prewarmer
from rustexp_tpu_torch.sims.base import EmptyExperiment, Experiment
from rustexp_tpu_torch.sims.gol import GoLExperiment
from rustexp_tpu_torch.sims.nbody import NBodyExperiment
from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment
from rustexp_tpu_torch.sims.sine import SineExperiment

CPU = torch.device("cpu")


def _frame(seed: int, h: int = 40, w: int = 56) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (h, w), dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32)).view(torch.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


# ------------------------------------------------------- colors, PNG, font

def test_add_and_unpack_abgr32_match_jax():
    a, b = _frame(1).ravel(), _frame(2).ravel()
    a[:4] = [0, 0xFFFFFFFF, 0x80808080, 0x7F7F7F7F]
    b[:4] = [0xFFFFFFFF, 0xFFFFFFFF, 0x80808080, 0x01010101]
    want = np.asarray(jcolors.add_abgr32(jnp.asarray(a), jnp.asarray(b)))
    got = colors.add_abgr32(_t(a), _t(b))
    assert got.dtype == torch.uint32 and np.array_equal(_np(got), want)
    for x, y in zip(jcolors.unpack_abgr32(jnp.asarray(a)),
                    colors.unpack_abgr32(_t(a))):
        assert np.array_equal(np.asarray(x).astype(np.int64),
                              y.numpy().astype(np.int64))


def test_png_bytes_and_round_trip_match_jax(tmp_path):
    fb = _frame(3)
    want = jfb.to_rgb8_topleft(fb)
    got = fbm.to_rgb8_topleft(_t(fb))
    assert np.array_equal(got, want)
    pj, pt = tmp_path / "j.png", tmp_path / "t.png"
    jfb.save_framebuffer_png(str(pj), fb)
    fbm.save_framebuffer_png(str(pt), _t(fb))
    assert pt.read_bytes() == pj.read_bytes()
    assert np.array_equal(fbm.read_png(str(pt)), want)
    assert np.array_equal(_np(fbm.clear(4, 6, CPU, 0x80FF00FF)),
                          np.asarray(jfb.clear(4, 6, 0x80FF00FF)))


@pytest.mark.parametrize("text,x,y,bg", [
    ("60.0FPS | 16.67ms | Mode: Fill", 4, 4, 0x80000000),
    ("clipped at the right edge: [R]nd %", 30, 10, 0x80000000),
    ("no dimming", 2, 0, None),
    ("too tall", 4, 36, 0x80000000)])
def test_draw_text_matches_jax(text, x, y, bg):
    fb = _frame(4)
    want = jfont.draw_text(fb, text, x=x, y=y, bg=bg)
    got = font.draw_text(_t(fb), text, x=x, y=y, bg=bg)
    assert got.dtype == torch.uint32 and np.array_equal(_np(got), want)
    assert np.array_equal(font.text_mask(text), jfont.text_mask(text))


def test_gif_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    pal = rng.integers(0, 256, (300, 3), np.uint8)
    frames = [pal[rng.integers(0, len(pal), (24, 40))] for _ in range(3)]
    pj, pt = tmp_path / "j.gif", tmp_path / "t.gif"
    jgif.write_gif(str(pj), frames, fps=20.0)
    gif.write_gif(str(pt), frames, fps=20.0)
    assert pt.read_bytes() == pj.read_bytes()
    idx = rng.integers(0, 256, 5000).astype(np.uint8)
    assert gif._lzw_encode(idx, 8) == jgif._lzw_encode_py(idx, 8)
    with pytest.raises(ValueError, match="one shape"):
        gif.write_gif(str(pt), [frames[0], frames[1][:8]])


# ------------------------------------------------------------------ trace

@pytest.fixture
def trace_reset():
    yield
    trace.setup(level=trace.TraceLevel.WARN, file_path=None, echo=True)


def test_trace_levels_and_file_sink(tmp_path, capsys, trace_reset):
    log = str(tmp_path / "t.log")
    trace.setup(level=trace.TraceLevel.WARN, file_path=log, echo=True,
                color=False)
    trace.trace_error("boom")
    trace.trace_warn("careful")
    trace.trace_info("chatty")  # above the level: dropped
    err = capsys.readouterr().err
    assert "boom" in err and "careful" in err and "chatty" not in err
    with open(log) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("ERROR [") and lines[0].endswith("| boom")
    assert lines[1].startswith("WARN [")


def test_trace_none_color_and_raise(capsys, trace_reset):
    trace.setup(level=trace.TraceLevel.NONE, echo=True, color=False)
    trace.trace_error("invisible")
    assert "invisible" not in capsys.readouterr().err
    trace.setup(level=trace.TraceLevel.INFO, echo=True, color=True)
    trace.trace_info("tinted")
    err = capsys.readouterr().err
    assert "\x1b[36m" in err and "\x1b[0m" in err
    with pytest.raises(RuntimeError, match="fatal thing"):
        trace.trace_and_raise("fatal thing")


# JAX's N-body replan line ends with a clause the port drops: it compiles
# nothing per theta (ROADMAP C, "No pending state").
JAX_RECOMPILE_CLAUSE = " (recompiles on first step if K changed)"


def _traced(mod, level, path, run) -> list[str]:
    """The messages run() writes through trace module `mod` to a file
    sink at `level` (the header before " | " dropped)."""
    mod.setup(level=level, file_path=str(path), echo=False)
    try:
        run()
    finally:
        mod.setup(level=mod.TraceLevel.WARN, file_path=None, echo=True)
    return [line.split(" | ", 1)[1] for line in path.read_text().splitlines()]


def _stale_rebuild(exp_cls, **kw):
    """A Rasterizer Experiment at 128^2 whose queue goes stale at tick 3
    (test_torch_frame.test_experiment_rebuilds_stale_queue)."""
    def run():
        exp = exp_cls(**kw)
        st = exp.init(per_pixel=True)
        exp.render(st, 128, 128, 0.0)
        exp.render(st, 128, 128, 3.0)
    return run


def _theta_keys(exp_cls, **kw):
    """a/A on N-body states of both routes: BH at 4,096 bodies (a, A),
    brute once theta reaches 0 (a from 0.05) and below BH_MIN_N (A)."""
    def run():
        exp = exp_cls(**kw)
        for n, theta, key in ((4096, 0.85, "a"), (4096, 0.85, "A"),
                              (4096, 0.05, "a"), (1024, 0.85, "A")):
            exp.handle_key(exp.init(mode="orbits", n=n, theta=theta), key)
    return run


def test_experiments_trace_jaxs_lines(tmp_path, trace_reset):
    """ROADMAP C6: the Rasterizer's stale rebuild and N-body's a/A replan
    go through core.trace's trace_info with JAX's text, so a file sink at
    INFO holds them; at the default WARN neither appears."""
    from rustexp_tpu.core import trace as jtrace
    from rustexp_tpu.sims.nbody import NBodyExperiment as JNBody
    from rustexp_tpu.sims.rasterizer import RasterizerExperiment as JRaster

    info, warn = trace.TraceLevel.INFO, trace.TraceLevel.WARN
    got = _traced(trace, info, tmp_path / "raster.log",
                  _stale_rebuild(RasterizerExperiment, device=CPU))
    want = _traced(jtrace, jtrace.TraceLevel.INFO, tmp_path / "jraster.log",
                   _stale_rebuild(JRaster))
    assert got == want == ["raster structure stale at tick 3.00; rebuilding"]

    got = _traced(trace, info, tmp_path / "nbody.log",
                  _theta_keys(NBodyExperiment, device=CPU))
    want = _traced(jtrace, jtrace.TraceLevel.INFO, tmp_path / "jnbody.log",
                   _theta_keys(JNBody))
    assert got == [w.removesuffix(JAX_RECOMPILE_CLAUSE) for w in want]
    assert got[0].startswith("theta=0.80: block-BH K=")
    assert got[1].startswith("theta=0.90: block-BH K=")
    assert got[2:] == ["theta=0.00: routing to brute force",
                       "theta=0.90: routing to brute force"]
    assert all(w.endswith(JAX_RECOMPILE_CLAUSE) for w in want[:2])

    for name, run in (("raster", _stale_rebuild(RasterizerExperiment,
                                                device=CPU)),
                      ("nbody", _theta_keys(NBodyExperiment, device=CPU))):
        assert _traced(trace, warn, tmp_path / f"{name}_warn.log", run) == []


# ------------------------------------------------------------ checkpoints

def test_gol_resume_bit_exact_with_r_after_resume(tmp_path):
    """Interrupted and resumed == uninterrupted, an 'R' key (a draw from
    the saved prng key) on each side of the save included."""
    exp = GoLExperiment(CPU)
    ref = exp.handle_key(exp.init(pattern="gun"), "R")
    for _ in range(3):
        ref = exp.step(ref)
    st = exp.handle_key(exp.init(pattern="gun"), "R")
    for _ in range(3):
        st = exp.step(st)
    p = save_state(tmp_path / "gol.npz", st)
    ref = exp.handle_key(ref, "R")
    for _ in range(3):
        ref = exp.step(ref)
    st2 = load_state(p, exp)
    assert st2.generations == 3 and st2.grid.device == CPU
    st2 = exp.handle_key(st2, "R")
    for _ in range(3):
        st2 = exp.step(st2)
    assert torch.equal(st2.grid, ref.grid)
    assert torch.equal(st2.key, ref.key)


def test_nbody_resume_exact_arrays(tmp_path):
    exp = NBodyExperiment(CPU)
    st = exp.init(mode="orbits", n=256)
    st = exp.step(exp.step(st))
    st.dt, st.theta = 0.02, 0.0  # brute route
    p = save_state(tmp_path / "nb.npz", st)
    st2 = load_state(p, exp)
    assert st2.dt == 0.02 and st2.theta == 0.0 and st2.steps == st.steps
    for name in ("px", "py", "vx", "vy", "m"):
        assert torch.equal(getattr(st2, name), getattr(st, name)), name
    assert torch.equal(exp.step(st).px, exp.step(st2).px)


def test_raster_state_roundtrip(tmp_path):
    exp = RasterizerExperiment(CPU)
    st = exp.init()
    for k in "WSPM":
        st = exp.handle_key(st, k)
    exp.render(st, 64, 64)
    p = save_state(tmp_path / "rast.npz", st)
    st2 = load_state(p, exp)
    assert (st2.mesh_idx, st2.shader_idx, st2.per_pixel, st2.mode) == (
        1, 6, True, 0)
    assert st2._scene_cache is None  # transient, rebuilt lazily


def test_extensionless_path_and_wrong_experiment(tmp_path):
    exp = GoLExperiment(CPU)
    st = exp.init(pattern="acorn")
    written = save_state(tmp_path / "bare", st)
    assert str(written).endswith("bare.npz")
    st2 = load_state(tmp_path / "bare", exp)  # the extensionless alias
    assert torch.equal(st2.grid, st.grid)
    with pytest.raises(ValueError, match="GoLState"):
        load_state(written, NBodyExperiment(CPU))


# -------------------------------------------------------------------- CLI

def test_cli_gol_grid_steps_keys_png(tmp_path, capsys):
    out = str(tmp_path / "g")
    rc = cli.main(["gol", "--device", "cpu", "--frames", "2", "--grid", "64",
                   "--steps-per-frame", "2", "--keys", "G", "--size", "128",
                   "--out", out])
    assert rc == 0
    assert os.path.exists(f"{out}_000.png") and os.path.exists(f"{out}_001.png")
    text = capsys.readouterr().out
    assert "64x64 Grid" in text and "4 Gens" in text


def test_cli_sine_nbody_and_gif(tmp_path, capsys):
    g = str(tmp_path / "s.gif")
    assert cli.main(["sine", "--device", "cpu", "--frames", "2", "--size",
                     "64", "--gif", g]) == 0
    with open(g, "rb") as f:
        assert f.read(6) == b"GIF89a"
    assert cli.main(["nbody", "--device", "cpu", "--frames", "1", "--size",
                     "64", "--keys", "E"]) == 0
    text = capsys.readouterr().out
    assert "frames in" in text and f"wrote {g}" in text
    assert "5 Bodies" in text


def test_cli_rasterizer_keys_and_png_matches_experiment(tmp_path, capsys):
    """QQQA walks back to the Cube (12 triangles) and shader 4; the PNG
    is the experiment's frame under its status overlay."""
    out = str(tmp_path / "r")
    assert cli.main(["rasterizer", "--device", "cpu", "--frames", "1",
                     "--size", "128", "--keys", "QQQA", "--out", out,
                     "--no-overlay"]) == 0
    text = capsys.readouterr().out
    assert "Cube" in text and "12 Tri" in text
    exp = RasterizerExperiment(CPU)
    st = exp.init(mesh_idx=9, shader_idx=4)
    want = fbm.to_rgb8_topleft(exp.render(st, 128, 128, 0.0))
    assert np.array_equal(fbm.read_png(f"{out}_000.png"), want)


def test_cli_save_load_resumes_gol(tmp_path, capsys):
    path = str(tmp_path / "st")
    cli.main(["gol", "--device", "cpu", "--frames", "2", "--grid", "64",
              "--size", "64", "--save-state", path])
    cli.main(["gol", "--device", "cpu", "--frames", "2", "--size", "64",
              "--load-state", path, "--save-state", path + "2"])
    cli.main(["gol", "--device", "cpu", "--frames", "4", "--grid", "64",
              "--size", "64", "--save-state", path + "4"])
    text = capsys.readouterr().out
    assert "resumed from" in text and "64x64 Grid, 4 Gens" in text
    exp = GoLExperiment(CPU)
    a, b = load_state(path + "2", exp), load_state(path + "4", exp)
    assert a.generations == b.generations == 4
    assert torch.equal(a.grid, b.grid)


def test_cli_animate_matches_jax_turntable(tmp_path, capsys):
    """--animate 4 on the Cube at 128^2 (a queue rebuilt every frame)
    writes JAX's render_turntable frames, overlay included."""
    prefix = str(tmp_path / "t")
    assert cli.main(["rasterizer", "--device", "cpu", "--animate", "4",
                     "--size", "128", "--keys", "QQQ", "--out", prefix]) == 0
    assert "4 frames, median" in capsys.readouterr().out
    jprefix = str(tmp_path / "j")
    janimate.render_turntable(mesh_idx=9, n_frames=4, w=128, h=128,
                              out_prefix=jprefix, overlay=True)
    got = sorted(glob.glob(prefix + "_*.png"))
    assert [os.path.basename(p) for p in got] == [
        f"t_{i:04d}.png" for i in range(4)]
    frames = [fbm.read_png(p) for p in got]
    for i, f in enumerate(frames):
        assert np.array_equal(f, jfb.read_png(f"{jprefix}_{i:04d}.png")), i
    assert (frames[0] != frames[3]).any(), "the camera did not move"


def test_turntable_untileable_takes_the_auto_backend(tmp_path):
    from rustexp_tpu_torch.app.animate import render_turntable

    times = render_turntable(mesh_idx=9, shader_idx=2, n_frames=2, fps=4.0,
                             w=64, h=64, out_prefix=str(tmp_path / "t"),
                             device=CPU)
    janimate.render_turntable(mesh_idx=9, shader_idx=2, n_frames=2, fps=4.0,
                              w=64, h=64, out_prefix=str(tmp_path / "j"))
    assert len(times) == 2 and all(t > 0 for t in times)
    for i in range(2):
        assert np.array_equal(fbm.read_png(str(tmp_path / f"t_{i:04d}.png")),
                              jfb.read_png(str(tmp_path / f"j_{i:04d}.png")))


def test_cli_refuses_what_it_cannot_run(monkeypatch, capsys):
    """--devices 2 runs (two gloo CPU ranks) and --animate with --devices
    is refused; --animate needs the rasterizer; the benchmark refuses the
    CPU; and without --device cpu, on a machine with no card, the CLI
    exits non-zero rather than run on the CPU."""
    assert cli.main(["sine", "--device", "cpu", "--devices", "2",
                     "--frames", "1", "--size", "64"]) == 0
    assert "on 2 ranks (cpu)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="drop --devices"):
        cli.main(["rasterizer", "--device", "cpu", "--devices", "2",
                  "--animate", "2"])
    with pytest.raises(SystemExit, match="rasterizer"):
        cli.main(["gol", "--device", "cpu", "--animate", "2"])
    with pytest.raises(ValueError, match="times the card"):
        cli.main(["bench", "--device", "cpu", "--runs", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["sine", "--frames", "1"], ["bench"],
                 ["sine", "--devices", "2"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code not in (None, 0) and "--device cpu" in str(
            e.value.code)
    with pytest.raises(SystemExit):
        viewer.main(["--frames", "1"])
    assert require_live_device("cpu") == CPU


def test_experiments_follow_the_protocol(monkeypatch):
    for exp in (GoLExperiment(CPU), NBodyExperiment(CPU),
                RasterizerExperiment(CPU), SineExperiment(CPU),
                EmptyExperiment(CPU)):
        assert isinstance(exp, Experiment), exp.name
    e = EmptyExperiment(CPU)
    fb = e.render(e.step(e.init()), 8, 4)
    assert fb.dtype == torch.uint32 and fb.shape == (4, 8)
    assert not fb.view(torch.int32).any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EmptyExperiment()


# ------------------------------------------------------------------ viewer

class _FakeTerm:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def poll_key(self):
        return None


@pytest.mark.parametrize("start", [0, 1, 2])
def test_viewer_headless(monkeypatch, capsys, start):
    """Each experiment as the start, two keys injected through the real
    key path, the report line on stderr."""
    monkeypatch.setattr(viewer, "_RawTerm", _FakeTerm)
    monkeypatch.setattr(sys.stdout, "write", lambda s: len(s))
    n = viewer.run_viewer(size=64, fps=1000.0, frames=6, start=start,
                          inject_every=(4, "M" if start == 2 else "T"),
                          report=True, device="cpu")
    assert n == 6
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec["frames"] == 6 and rec["device"] == "cpu"
    assert rec["experiment"] == ("GoL", "NBody", "Rasterizer")[start]
    assert rec["keys_injected"] == 1 and rec["frame_ms_median"] > 0


def test_fb_to_ansi_matches_jax():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (6, 5, 3), np.uint8)
    assert viewer.fb_to_ansi(rgb) == jviewer.fb_to_ansi_py(rgb)
    assert viewer.fb_to_ansi(rgb).count("▀") == 15


def test_sim_worker_free_runs_and_serializes():
    exp = GoLExperiment(CPU)
    assert exp.decoupled
    w = viewer.SimWorker(exp, exp.init())
    try:
        deadline = time.time() + 10.0
        while time.time() < deadline and w.read().generations < 3:
            time.sleep(0.02)
        assert w.read().generations >= 3
        w.key("R")  # randomize through the lock
        assert w.read().grid.shape == (256, 256)
    finally:
        w.stop()
    assert not w._thread.is_alive()
    n_after = w.read().generations
    time.sleep(0.1)
    assert w.read().generations == n_after


def test_sim_worker_snapshot_and_pause():
    """read() returns a snapshot whose grid the worker never writes into:
    it stays equal to a copy taken at once while the worker steps on."""
    def advances_past(g):
        deadline = time.time() + 10.0
        while time.time() < deadline and w.read().generations <= g:
            time.sleep(0.01)
        return w.read().generations > g

    exp = GoLExperiment(CPU)
    w = viewer.SimWorker(exp, exp.init(pattern="gun"))
    try:
        snap = w.read()
        g0, grid0 = snap.generations, snap.grid.clone()
        assert advances_past(g0 + 2)
        assert snap.generations == g0 and torch.equal(snap.grid, grid0)
        w.pause()
        time.sleep(0.05)  # a step in flight finishes
        g1 = w.read().generations
        time.sleep(0.1)
        assert w.read().generations == g1
        w.resume()
        assert advances_past(g1)
    finally:
        w.stop()


def test_nbody_raw_key_routing():
    """The viewer hands raw chars on: the resets are shift-insensitive,
    x/X and a/A case-directed (tests/test_nbody.py, on the port)."""
    exp = NBodyExperiment(CPU)
    for k, n in (("q", 10_000), ("W", 10_000), ("e", 5), ("E", 5)):
        assert exp.handle_key(exp.init(n=64), k).n == n, k
    st = exp.init(n=64)
    dt0, th0 = st.dt, st.theta
    st = exp.handle_key(st, "X")
    assert st.dt == dt0 * 2
    st = exp.handle_key(st, "x")
    assert st.dt == dt0
    st = exp.handle_key(st, "a")
    assert st.theta == th0 - 0.05
    st = exp.handle_key(st, "A")
    assert abs(st.theta - th0) < 1e-9


# ---------------------------------------------------------------- prewarm

def test_prewarmer_dedup_urgent_priority_and_failure_swallowed():
    order = []
    gate = threading.Event()
    started = threading.Event()

    def warm(cfg, tick):
        started.set()
        gate.wait(10)
        order.append(cfg)
        if cfg == "boom":
            raise RuntimeError("a failed warm is swallowed")

    pw = Prewarmer(warm)
    pw.request("spec1", 0.0)            # starts the thread, waits at the gate
    assert started.wait(10)
    pw.request("spec2", 0.0)
    pw.request("boom", 0.0, urgent=True)
    pw.request("spec2", 0.0)            # dedup: queued already
    gate.set()
    deadline = time.time() + 10
    while len(order) < 3 and time.time() < deadline:
        time.sleep(0.02)
    assert order == ["spec1", "boom", "spec2"]
    assert pw.is_warm("boom") and pw.is_warm("spec1") and pw.is_warm("spec2")
    pw.request("spec2", 0.0)            # dedup: warm already
    pw.stop()
    assert len(order) == 3 and not pw._thread.is_alive()


def test_prewarmer_mark_warm_and_the_viewer_libraries(monkeypatch):
    calls = []
    pw = Prewarmer(lambda cfg, tick: calls.append(cfg))
    pw.mark_warm("done")
    pw.request("done", 0.0)              # no thread, no call
    assert pw.is_warm("done") and pw._thread is None and calls == []

    built = []
    monkeypatch.setattr(viewer, "load_kernel_lib", built.append)
    pw = viewer.kernel_prewarmer()
    deadline = time.time() + 10
    while len(built) < 7 and time.time() < deadline:
        time.sleep(0.02)
    pw.stop()
    assert sorted(built) == ["gol_stencil", "gol_swar", "nbody_forces",
                             "raster_bins", "raster_queue", "raster_shade",
                             "sort_radix"]
