"""Whole runs of each cell on the CPU, past the harness's look for a card.

A sound run comes out correct; with the timed path broken underneath (no
raster work done, a frozen frame, half the triangles left out, an answer
altered where it is produced) `correct` comes out false. A traced run
whose profiler sessions all lose their records fails without a result.
"""

import io
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, profiling, spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["rast512.sphere_p.bench", "rast512.sphere_p.orbit",
         "rast512.cube_p.bench", "rast512.cube_p.orbit"]
CPU = torch.device("cpu")


def run(cell_name, entry=None, seconds=0.4, trace=False, seed=2**31 + 7):
    cell = spec.Cell(spec.load_benchmark(), cell_name)
    cell.traffic["warmup_frames"] = 1  # CPU frames are slow; the window
    # and the check are the traffic's own
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, seed, seconds, trace, CPU,
                          time.perf_counter(), entry=entry, out=out,
                          err=err)
    line = out.getvalue().strip().splitlines()
    return rc, (json.loads(line[-1]) if line else None), err.getvalue()


class Broken:
    """The cell's own entry, with its frames broken as `how` says."""

    def __init__(self, cell_name, how, device=CPU):
        cell = spec.Cell(spec.load_benchmark(), cell_name)
        self.inner = cell.entry().Entry(cell.config, cell.traffic, device)
        self.show_cm, self.how, self.first = self.inner.show_cm, how, None

    def launches(self):
        return self.inner.launches()

    def frame(self, tick):
        from rustexp_tpu_torch.raster import pipeline as pp

        if self.how == "frozen" and self.first is not None:
            return self.first  # frame 1 returned again, nothing rendered
        fb, flag = self.inner.frame(tick)
        if self.how == "no_raster":  # the frame buffer left as cleared
            fb = pp.background(0, fb.shape[1], fb.shape[0],
                               fb.device).view(torch.uint32)
        elif self.how == "frozen":  # the state never moves past frame 1
            self.first = fb, flag
        elif self.how == "altered":  # one 32x128 tile mis-written
            fb = fb.view(torch.int32).clone()
            fb[:32, :128] ^= 0x00010101
            fb = fb.view(torch.uint32)
        return fb, flag

    def start_counting(self):
        self.inner.start_counting()

    def stop_counting(self):
        return self.inner.stop_counting()

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rc, line, err = run(cell)
    assert rc == 0 and line["correct"] and line["failed"] == 0, err
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check ")


# The checks a raster cell's line carries, in order: a fixed eye adds the
# checksum and flag counts to the pixels and the launch count.
CHECKS = {
    "rast512.sphere_p.bench": ["px_off", "frames_unlike_sample",
                               "stale_frames", "frames_not_rendered"],
    "rast512.sphere_p.orbit": ["px_off", "frames_not_rendered"],
    "rast512.cube_p.bench": ["px_off", "frames_unlike_sample",
                             "stale_frames", "frames_not_rendered"],
    "rast512.cube_p.orbit": ["px_off", "frames_not_rendered"],
}


@pytest.mark.parametrize("cell", CELLS)
def test_raster_check_lines(cell):
    """The raster check's numbers, names and limits, on a fixed seed, and
    its stderr: the sampled frames, then each number beside its limit."""
    rc, line, err = run(cell, seed=2**31 + 3)
    assert rc == 0 and line["correct"] and line["failed"] == 0, err
    assert list(line["checks"]) == CHECKS[cell]
    limits = spec.Cell(spec.load_benchmark(), cell).config["correct_limits"]
    for name, got in line["checks"].items():
        assert got == {"value": 0, "limit": limits[name]}, (name, err)
    tail = err.strip().splitlines()[-1 - len(CHECKS[cell]):]
    assert tail[0].startswith("sampled frames [")
    kept = min(line["attempted"], spec.Cell(
        spec.load_benchmark(), cell).traffic["sample_frames"])
    assert tail[0].endswith(f"pixels off the reference {[0] * kept}")
    assert tail[1:] == [f"check {k} 0 limit {limits[k]}"
                        for k in CHECKS[cell]]


# A fixed eye renders one frame over and over, so a frozen frame is the
# right picture there: the launch counts show that it was never rendered.
BREAKS = [(c, h) for c in CELLS for h in ("no_raster", "frozen", "altered")]


@pytest.mark.parametrize("cell,how", BREAKS)
def test_broken_frames_are_not_correct(cell, how):
    rc, line, err = run(cell, entry=Broken(cell, how))
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] > 0
    if how == "frozen":
        assert line["checks"]["frames_not_rendered"]["value"] > 0, err


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place (the control)."""
    from perfbench.control import ControlEntry

    c = spec.Cell(spec.load_benchmark(), cell)
    rc, line, err = run(cell, entry=ControlEntry(
        c.config, c.entry().Entry.show_cm, CPU))
    assert rc == 0 and line["correct"] is False, err
    px = line["checks"]["px_off"]
    assert px["value"] > px["limit"], err


@pytest.mark.parametrize("cell", ["rast512.sphere_p.bench",
                                  "rast512.cube_p.orbit"])
def test_half_the_triangles_is_not_correct(cell, monkeypatch):
    from rustexp_tpu_torch.raster import pipeline as pp

    make = pp.make_scene

    def half(mesh, cm_set, device):
        import copy

        m = copy.copy(mesh)
        m.tris = mesh.tris[::2]
        return make(m, cm_set, device)

    monkeypatch.setattr(pp, "make_scene", half)
    rc, line, err = run(cell)
    assert rc == 0 and line["correct"] is False, err


def test_traced_run_that_loses_every_session_prints_no_result(monkeypatch):
    def lost(fn, frames):
        raise RuntimeError(f"{profiling.TRIES} profiling sessions in a row "
                           f"lost their records")

    monkeypatch.setattr(profiling, "profile_frames", lost)
    with pytest.raises(RuntimeError, match="lost their records"):
        run("rast512.cube_p.bench", trace=True)


def test_profiler_losses_are_retried_then_refused(monkeypatch):
    """Sessions that keep no pad are thrown away, never read as idle."""
    import torch.profiler as tp

    class NoRecords:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return []

    monkeypatch.setattr(tp, "profile", NoRecords)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, "SETTLE_S", 0.0)
    monkeypatch.setattr(profiling, "SETTLE_MAX_S", 0.0)
    calls = []
    with pytest.raises(RuntimeError, match="no device metric"):
        profiling.profile_frames(lambda: calls.append(1), 3)
    assert len(calls) == 3 * profiling.TRIES


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


_MODULES = """
import io, sys, time, torch
from perfbench import harness, spec
cell = spec.Cell(spec.load_benchmark(), "rast512.cube_p.orbit")
harness.run_cell(cell, 3, 0.2, False, torch.device("cpu"),
                 time.perf_counter(), out=io.StringIO(), err=io.StringIO())
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = """
import sys
from perfbench.reference import assets, raster
cm, cross = assets.procedural_sky()
raster.render(assets.cube(), cm, cross, assets.eye("orbit", 0.0), w=128,
              h=128, per_pixel=True, shader=5, bg=0, show_cm=True,
              device="cpu")
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_and_the_reference_load_no_jax():
    for code, program in ((_MODULES, True), (_REFERENCE, False)):
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        top = set(res.stdout.split())
        assert not top & {"jax", "jaxlib", "flax", "rustexp_tpu"}, top
        assert ("rustexp_tpu_torch" in top) == program
