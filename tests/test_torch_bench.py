"""The port's two top-level surfaces against the JAX package's:
rustexp_tpu_torch.bench (the root bench.py's one JSON line) and
rustexp_tpu_torch.graft_entry (__graft_entry__.py's flagship frame), and
the benchmark API they sit on (bench_scene's backends, run_suite's table).

compose_summary is held to bench.py's on every branch (equal dicts but
for the commit, the engine hash and the wording of backend_unavailable's
error); both mains run with stubbed benches and must make the same calls
in the same order under the same budgets. Frames: the port's CPU frames
against JAX's at 512x512, each backend on KillerooP and CubeV and the
flagship frame; bound 0.3% of pixels (the golden bound,
tests/test_golden.py), measured 0 px in every case.
"""

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustexp_tpu.app import benchmark as jbench
from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.core import platform as jplatform
from rustexp_tpu.raster import camera, pipeline as jpp
from rustexp_tpu_torch import bench as tb
from rustexp_tpu_torch import graft_entry
from rustexp_tpu_torch import runtime
from rustexp_tpu_torch.app import benchmark as tbench
from rustexp_tpu_torch.app import multidev
from rustexp_tpu_torch.ops import raster_queue

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
W = H = 512
GOLDEN_FRAC = 0.003


def _load(name: str, file: str):
    """A root module of the JAX package's repo (bench.py,
    __graft_entry__.py), loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, ROOT / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    return _load("jax_root_bench", "bench.py")


# ---------------------------------------------------------------------------
# compose_summary
# ---------------------------------------------------------------------------


def _results(seed: int = 0) -> dict:
    """One payload of every step, shaped as the steps record them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, _, _, ref in tbench.SCENES:
        us = float(rng.uniform(5e3, 2e4))
        out[f"scene:{name}"] = {
            "us": us, "ref_us": ref, "speedup": round(ref / us, 3),
            "us_median": round(us * 1.1, 1),
            "spread_pct": float(rng.uniform(0, 40)), "n_runs": 20}
        out[f"moving:{name}"] = {
            "value": float(rng.uniform(1.5e4, 3e4)), "unit": "us",
            "spread_pct": float(rng.uniform(0, 5))}
    out["gol_256"] = {"value": float(rng.uniform(1e11, 2e11)),
                      "gens_per_s": float(rng.uniform(1e6, 3e6)),
                      "spread_pct": 1.3, "note": "one SM's work"}
    out["gol_2048"] = {"value": float(rng.uniform(6e12, 7e12)),
                       "spread_pct": 0.4}
    out["nbody_bh"] = {"value": float(rng.uniform(25, 35)),
                       "spread_pct": 0.2}
    out["nbody_brute"] = {"value": float(rng.uniform(150, 180))}
    return out


def _subset(which: str) -> dict:
    full = _results()
    names = [s[0] for s in tbench.SCENES]
    if which == "full":
        return full
    if which == "scenes":
        return {k: v for k, v in full.items() if k.startswith("scene:")}
    if which == "five_scenes":
        return {f"scene:{n}": full[f"scene:{n}"] for n in names[2:7]}
    if which == "gol":
        return {"gol_256": full["gol_256"]}
    if which == "sine":
        return {"sine": {"metric": "sine_fill_Mpix_per_s", "value": 2345.6,
                         "unit": "Mpix/s", "vs_baseline": None}}
    if which == "nothing":
        return {}
    if which == "moving_without_killeroo":
        out = {k: dict(v) for k, v in full.items()
               if k.startswith("moving:") and k != "moving:KillerooP"}
        del out["moving:HandV"]["spread_pct"]  # a record without a spread
        out["gol_256"] = {"value": 1.5e11, "gens_per_s": 2.2e6}
        return out
    raise ValueError(which)


@pytest.mark.parametrize("which,partial", [
    ("full", False), ("scenes", False), ("five_scenes", False),
    ("gol", False), ("sine", False), ("nothing", False),
    ("moving_without_killeroo", False), ("full", True)])
def test_compose_summary_matches_bench_py(jax_bench, which, partial):
    results = _subset(which)
    stand_in = types.SimpleNamespace(results=results, reused=[],
                                     git_sha="jaxsha", sha="jaxhash")
    want = jax_bench.compose_summary(stand_in, partial=partial)
    rec = tb.Recorder()
    rec.results = results
    got = tb.compose_summary(rec, partial=partial)
    assert isinstance(got.pop("sha"), str) and want.pop("sha") == "jaxsha"
    assert len(got.pop("engine_hash")) == 12
    want.pop("engine_hash")
    if want["metric"] == "backend_unavailable":
        assert "CUDA" in got.pop("error") and "error" in want
        want.pop("error")
    assert got == want
    assert json.loads(json.dumps(got)) == got
    expect = {"full": "raster_suite_Mpix_per_s",
              "scenes": "raster_suite_Mpix_per_s",
              "five_scenes": "raster_suite_partial_Mpix_per_s",
              "gol": "gol_cell_updates_per_s",
              "sine": "sine_fill_Mpix_per_s",
              "nothing": "backend_unavailable",
              "moving_without_killeroo": "gol_cell_updates_per_s"}
    assert got["metric"] == expect[which]
    assert got.get("partial") is (True if partial else None)


def test_chip_smoke_summary_keys_are_bench_pys(jax_bench):
    """chip_smoke's surfaces phase requires every key of bench.py's full
    summary; its list must be exactly that summary's keys."""
    stand_in = types.SimpleNamespace(results=_results(), reused=[],
                                     git_sha="x", sha="y")
    assert set(chip_smoke.SUMMARY_KEYS) == set(
        jax_bench.compose_summary(stand_in))


# ---------------------------------------------------------------------------
# main: the steps, their order and budgets, and the exit
# ---------------------------------------------------------------------------


def _stub_benches(log: list, fail: str | None = None,
                  launch: dict | None = None) -> dict:
    """Stand-ins for bench_gol, bench_nbody, bench_scene and
    bench_scene_moving that log each call (without the port's device) and
    return a payload of the real record's keys; `fail` names one to raise,
    and `launch` maps a name to the B1 launches each of its calls adds."""

    def stub(fname, payload):
        def fn(*args, **kwargs):
            kwargs.pop("device", None)
            log.append(("call", fname, args, tuple(sorted(kwargs.items()))))
            raster_queue.raster_attrs_queue_cuda.launches += (
                launch or {}).get(fname, 0)
            if fname == fail:
                raise RuntimeError(f"{fname} stub fault")
            return dict(payload)
        return fn

    return {
        "bench_gol": stub("bench_gol", {"value": 1.2e11, "gens_per_s": 1e6,
                                        "spread_pct": 1.0}),
        "bench_nbody": stub("bench_nbody", {"value": 30.0,
                                            "spread_pct": 0.5}),
        "bench_scene": stub("bench_scene", {"best": 0.009, "median": 0.01,
                                            "spread_pct": 3.0, "n_runs": 20}),
        "bench_scene_moving": stub("bench_scene_moving", {
            "value": 23000.0, "spread_pct": 2.0}),
    }


class _Beats:
    def __init__(self, log):
        self.log = log

    def __call__(self, emit, budget_s=900.0):
        self.log.append(("watchdog", budget_s))
        return self

    def beat(self, budget_s):
        self.log.append(("beat", budget_s))


def _run_jax_main(jax_bench, monkeypatch, capsys) -> tuple[list, dict]:
    log = []

    class Rec:
        sha = git_sha = "jax"

        def __init__(self):
            self.results, self.reused = {}, []
            self.fallback, self.fallback_shas = {}, {}

        def set_backend(self, backend):
            pass

        def done(self, name):
            return False

        def record(self, name, payload):
            log.append(("record", name))
            self.results[name] = payload

    monkeypatch.setattr(jax_bench, "Recorder", Rec)
    monkeypatch.setattr(jax_bench, "Watchdog", _Beats(log))
    monkeypatch.setattr(jplatform, "probe_backend", lambda timeout_s: "tpu")
    monkeypatch.setattr(jplatform, "honor_jax_platforms_env", lambda: None)
    for name, fn in _stub_benches(log).items():
        monkeypatch.setattr(jbench, name, fn)
    jax_bench.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return log, json.loads(line)


def _run_port_main(monkeypatch, capsys, fail=None, launch=None):
    log = []

    class Rec(tb.Recorder):
        def record(self, name, payload):
            log.append(("record", name))
            super().record(name, payload)

    monkeypatch.setattr(tb, "Recorder", Rec)
    monkeypatch.setattr(tb, "Watchdog", _Beats(log))
    monkeypatch.setattr(tb, "card_line", lambda: "a stand-in card, 700 W")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(runtime, "device", lambda kind=None: CPU)
    for name, fn in _stub_benches(log, fail, launch).items():
        monkeypatch.setattr(tbench, name, fn)
    rc = tb.main()
    out = capsys.readouterr()
    line = out.out.strip().splitlines()[-1]
    return log, json.loads(line), rc, out.err


def test_main_runs_bench_pys_steps_in_its_order(jax_bench, monkeypatch,
                                                capsys):
    """Both mains with stubbed benches: the same bench calls (arguments
    and all), recorded under the same names, in the same order and under
    the same watchdog budgets (bench.py:338-390), and the same line."""
    want_log, want = _run_jax_main(jax_bench, monkeypatch, capsys)
    got_log, got, rc, err = _run_port_main(monkeypatch, capsys)
    assert rc == 0
    # bench.py's probe gets a budget of its own; the port has no probe
    assert want_log[:2] == [("watchdog", 900.0), ("beat", 1000.0)]
    assert got_log[0] == ("watchdog", 900.0)
    assert got_log[1:] == want_log[2:]
    names = [e[1] for e in got_log if e[0] == "record"]
    assert names == [s[0] for s in tb.plan(tbench, CPU)]
    scenes = [s[0] for s in tbench.SCENES]
    assert names[:6] == ["gol_256", "nbody_bh", "scene:KillerooP",
                         "scene:CornellBoxV", "gol_2048", "nbody_brute"]
    assert sorted(names[6:16]) == sorted(
        f"scene:{n}" for n in scenes if n not in ("KillerooP", "CornellBoxV"))
    assert names[16:] == ["moving:KillerooP"] + [
        f"moving:{n}" for n in scenes if n != "KillerooP"]
    for d in (want, got):
        d.pop("sha"), d.pop("engine_hash")
    assert got == want
    assert got["scenes_done"] == got["moving_scenes_done"] == 12
    assert "# device: a stand-in card, 700 W" in err
    assert '# launches: {"B1": ' in err


def test_main_prints_each_steps_launches(monkeypatch, capsys):
    """Each step's launches on stderr, counted over that step alone and
    naming only the kernels it launched (chip_smoke.py holds each fixed
    scene's to its frames), then the run's total."""
    q = raster_queue.raster_attrs_queue_cuda
    monkeypatch.setattr(q, "launches", 0)
    _, _, rc, err = _run_port_main(
        monkeypatch, capsys, fail="bench_scene_moving",
        launch={"bench_scene": 3072, "bench_scene_moving": 5})
    assert rc == 1
    steps = {m.group(1): json.loads(m.group(2)) for m in re.finditer(
        r"^# launches (\S+): (\{.*\})$", err, re.M)}
    names = [s[0] for s in tb.plan(tbench, CPU)]
    assert list(steps) == names
    for name in names:
        want = {"scene": {"B1": 3072}, "moving": {"B1": 5}}.get(
            name.split(":")[0], {})
        assert steps[name] == want, name
    total = json.loads(re.search(r"^# launches: (\{.*\})$", err,
                                 re.M).group(1))
    assert total["B1"] == 12 * 3072 + 12 * 5
    assert err.index("# launches gol_256: {}") < err.index(
        "# recorded nbody_bh")


def test_main_reports_a_failed_step_and_exits_1(monkeypatch, capsys):
    """A step that raises is reported on stderr and leaves its keys out,
    as in bench.py; the port's run then exits 1 (bench.py exits 0)."""
    log, got, rc, err = _run_port_main(monkeypatch, capsys,
                                       fail="bench_nbody")
    assert rc == 1
    assert "# nbody_bh failed: RuntimeError: bench_nbody stub fault" in err
    assert "# nbody_brute failed: RuntimeError" in err
    assert got["metric"] == "raster_suite_Mpix_per_s"
    assert "nbody_bh_steps_per_s_131k" not in got
    assert "nbody_brute_steps_per_s_131k" not in got
    assert got["gol_cell_updates_per_s"] == 1.2e11
    assert "partial" not in got


def test_module_without_cuda_prints_backend_unavailable():
    """`python -m rustexp_tpu_torch.bench` on a host with no CUDA device:
    bench.py's backend_unavailable line, rc 1, and no jax or rustexp_tpu
    module among the child's imports (-X importtime lists each)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "rustexp_tpu_torch.bench"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "backend_unavailable"
    assert line["value"] == 0 and line["vs_baseline"] is None
    assert "CUDA" in line["error"]
    imported = [m.group(1) for m in re.finditer(
        r"^import time:.*\|\s+(\S+)$", out.stderr, re.M)]
    assert "rustexp_tpu_torch.app.benchmark" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "rustexp_tpu")]


def test_watchdog_prints_the_partial_line_and_exits_1():
    code = ("import time\n"
            "from rustexp_tpu_torch.bench import Watchdog\n"
            "Watchdog(lambda partial: print('partial', partial, flush=True),"
            " budget_s=0.5)\n"
            "time.sleep(60)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1
    assert out.stdout.strip() == "partial True"
    assert "step budget exceeded" in out.stderr


def test_bench_sine_refuses_the_cpu():
    with pytest.raises(ValueError, match="times the card"):
        tb.bench_sine("cpu")


# ---------------------------------------------------------------------------
# bench_scene's backends and run_suite's table
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_frame(mesh_idx, per_pixel, backend, shade_w):
    """One frame of JAX's bench_scene route (rustexp_tpu/app/
    benchmark.py:113-137), jitted as its scan body is; cached, as the
    frame and checksum tests share it."""
    m = jmesh.get_mesh(mesh_idx)
    scene = jpp.make_scene(m, jcubemap.get_cm_set(0))
    eye = camera.camera_eye(jmesh.mesh_camera(mesh_idx), 0.0)
    if backend == "auto":
        backend = "queue" if m.num_tris >= jbench.QUEUE_MIN_TRIS else "pallas"
    cap = spans = rows = queue = None
    if backend == "queue":
        queue = jpp.build_scene_queue(scene, eye, W, H, per_pixel=per_pixel,
                                      shade_w=shade_w)
    elif backend != "xla":
        cap, spans, rows = jpp.suggest_binning(scene, eye, W, H)

    @jax.jit
    def frame(scene, queue, eye):
        return jpp.render_frame(
            scene, eye, 0.0, w=W, h=H, mode=jpp.MODE_FILL,
            per_pixel=per_pixel, shader_idx=5, bg_idx=0, show_cm=False,
            backend=backend, raster_cap=cap, raster_spans=spans,
            raster_rows=rows, raster_queue=queue, return_overflow=True)

    fb, stale = frame(scene, queue, eye)
    assert not bool(stale)
    return np.asarray(fb), backend


@functools.lru_cache(maxsize=None)
def _port_frame(mesh_idx, per_pixel, backend, shade_w):
    """One frame of the port's scene_frame on the CPU -> (fb, stale,
    structure); cached, as the frame and checksum tests share it."""
    frame, structure, _, _ = tbench.scene_frame(mesh_idx, per_pixel, CPU,
                                                backend, shade_w)
    return (*frame(), structure)


SCENE_FRAMES = [("KillerooP", 0, True, None), ("CubeV", 9, False, None)]


@pytest.mark.parametrize("backend", tbench.BACKENDS)
@pytest.mark.parametrize("label,mesh_idx,per_pixel,shade_w", SCENE_FRAMES)
def test_scene_frame_backends_match_jax(label, mesh_idx, per_pixel, shade_w,
                                        backend):
    got, stale, structure = _port_frame(mesh_idx, per_pixel, backend,
                                        shade_w)
    assert not bool(stale)
    want, resolved = _jax_frame(mesh_idx, per_pixel, backend, shade_w)
    assert structure["backend"] == resolved
    diff = int((want != got.numpy()).sum())
    assert diff <= GOLDEN_FRAC * W * H, f"{label} {backend}: {diff} px"


def test_scene_frame_shade_w_matches_jax():
    """The queue route at a shade_w of 64 (choose_shade_w takes 128 for
    KillerooP's fixed eye)."""
    frame, structure, _, _ = tbench.scene_frame(0, True, CPU, "queue", 64)
    assert structure["shade_w"] == 64
    want, _ = _jax_frame(0, True, "queue", 64)
    diff = int((want != frame()[0].numpy()).sum())
    assert diff <= GOLDEN_FRAC * W * H, diff


def test_scene_frame_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="backend 'mxu'"):
        tbench.scene_frame(9, False, CPU, "mxu")


# ---------------------------------------------------------------------------
# bench_scene's sampling and checksum (rustexp_tpu/app/benchmark.py:123-144)
# ---------------------------------------------------------------------------


def _jax_checksum(fb: np.ndarray, stale: bool) -> int:
    """JAX's per-frame reduction, as its scan body writes it."""
    return int(jnp.sum(jnp.asarray(fb), dtype=jnp.uint32)
               + jnp.asarray(stale).astype(jnp.uint32))


def _port_checksum(fb: torch.Tensor, stale: bool) -> int:
    return int(tbench.wrap32(tbench.frame_sum(fb, torch.tensor(stale))))


@pytest.mark.parametrize("backend", tbench.BACKENDS)
@pytest.mark.parametrize("label,mesh_idx,per_pixel,shade_w", SCENE_FRAMES)
def test_frame_checksum_matches_jax(label, mesh_idx, per_pixel, shade_w,
                                    backend):
    """The port's checksum of a real 512^2 frame equals JAX's uint32
    jnp.sum + stale on the same frame, bit for bit, with and without the
    stale flag; the frame's exact sum passes 2^32, so both wrap."""
    fb, _, _ = _port_frame(mesh_idx, per_pixel, backend, shade_w)
    assert int(fb.numpy().astype(np.uint64).sum()) >= 1 << 32
    for stale in (False, True):
        assert _port_checksum(fb, stale) == _jax_checksum(fb.numpy(), stale)


def test_frame_checksum_wraps_as_jax():
    """Every word 0xFFFFFFFF plus a stale flag: the sum wraps past 2^32
    once a word, and the flag's +1 on top of it."""
    fb = np.full((H, W), 0xFFFFFFFF, dtype=np.uint32)
    want = _jax_checksum(fb, True)
    assert want == (1 << 32) - H * W + 1
    assert _port_checksum(torch.from_numpy(fb), True) == want


class _Sampling:
    """bench_scene's collaborators on the CPU: _card gives the CPU,
    scene_frame a stand-in frame that counts its renders (a 4x4 frame of
    `word`s, stale when `stale`, another word on the frame numbered
    `odd_frame`), _event_seconds counts the frames inside each timed run
    and returns made-up seconds, and the card's name is a stand-in."""

    def __init__(self, monkeypatch, word=0xFFFFFFF0, stale=False,
                 odd_frame=None):
        self.frames, self.runs, self.warmup = 0, [], None
        self.word, self.stale, self.odd_frame = word, stale, odd_frame
        m = types.SimpleNamespace(num_tris=12, name="cube (procedural)")
        cm = types.SimpleNamespace(name="grace")
        monkeypatch.setattr(tbench, "_card", lambda device: CPU)
        monkeypatch.setattr(tbench, "scene_frame", lambda *a: (
            self.frame, {"backend": "pallas"}, m, cm))
        monkeypatch.setattr(tbench, "_event_seconds", self.event_seconds)
        monkeypatch.setattr(tbench.torch.cuda, "get_device_name",
                            lambda device: "stand-in card")

    def frame(self):
        word = self.word + (self.frames == self.odd_frame)
        self.frames += 1
        fb = torch.tensor(np.full((4, 4), word, dtype=np.uint32))
        return fb, torch.tensor(self.stale)

    def event_seconds(self, fn) -> float:
        if self.warmup is None:
            self.warmup = self.frames
        before = self.frames
        fn()
        self.runs.append(self.frames - before)
        return 0.5 + 0.25 * len(self.runs)


@pytest.mark.parametrize("runs", [1, 3, 8, 16, 20])
def test_bench_scene_samples_as_jax(monkeypatch, runs):
    """A whole dispatch of warm-up, then max(1, runs // 8) timed runs of
    FRAMES_PER_DISPATCH frames each (JAX's counts at the same `runs`), and
    the record's n_runs, frames a run, per-frame stats and checksum."""
    k = jbench.FRAMES_PER_DISPATCH
    assert tbench.FRAMES_PER_DISPATCH == k == 1024
    timed = max(1, runs // 8)
    stub = _Sampling(monkeypatch)
    rec = tbench.bench_scene(9, True, runs, return_stats=True)
    assert stub.warmup == k
    assert stub.runs == [k] * timed
    assert stub.frames == (1 + timed) * k
    assert (rec["n_runs"], rec["frames_per_run"]) == (timed, k)
    assert rec["best"] == 0.75 / k
    assert rec["checksum"] == _jax_checksum(np.full((4, 4), stub.word,
                                                    dtype=np.uint32), False)
    assert rec["device"] == "stand-in card" and rec["backend"] == "pallas"
    _Sampling(monkeypatch)
    assert tbench.bench_scene(9, True, runs) == 0.75 / k  # JAX's float


@pytest.mark.parametrize("fault,match", [
    ("stale", "went stale"), ("odd frame", "frames of a fixed eye differ"),
    ("odd warm-up frame", "frames of a fixed eye differ")])
def test_bench_scene_guards_raise(monkeypatch, fault, match):
    """The stale flag (ORed on the card, read after the runs) raises, and so
    does a run whose frames' checksums differ from each other or from the
    warm-up's."""
    k = tbench.FRAMES_PER_DISPATCH
    _Sampling(monkeypatch, stale=fault == "stale",
              odd_frame={"odd frame": k + 5, "odd warm-up frame": 7}.get(
                  fault))
    with pytest.raises(RuntimeError, match=match):
        tbench.bench_scene(9, True, 20)


def test_run_suite_prints_jaxs_table(monkeypatch, capsys):
    """Through stubbed bench_scenes of the same per-scene times, the port's
    table is JAX's without its "vs-own" column (a TPU's stored times),
    and its record rounds to JAX's."""
    best = {(m, p): (500 + 37 * i) * 1e-6
            for i, (_, m, p, _) in enumerate(tbench.SCENES)}
    monkeypatch.setattr(jbench, "bench_scene",
                        lambda m, p, runs, backend: best[(m, p)])

    def port_scene(m, p, runs, backend="auto", return_stats=False,
                   shade_w=None, device=None):
        assert (runs, backend, return_stats, device) == (7, "auto", True, CPU)
        return {"scene": tbench._label(m, p), "best": best[(m, p)],
                "device": "stand-in"}

    monkeypatch.setattr(tbench, "bench_scene", port_scene)
    want = jbench.run_suite(runs=7)
    want_lines = capsys.readouterr().out.splitlines()
    got = tbench.run_suite(7, device=CPU)
    got_lines = capsys.readouterr().out.splitlines()
    assert len(got_lines) == 13
    assert got_lines == [re.sub(r"   vs-own .*$", "", s) for s in want_lines]
    assert round(got["value"], 1) == want["value"]
    assert round(got["vs_baseline"], 3) == want["vs_baseline"]
    tbench.run_suite(7, verbose=False, device=CPU)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("speedup", [1.5, 1.01, 1.0, 0.99, 0.5])
def test_tinted_matches_jax_on_a_terminal(monkeypatch, speedup):
    monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(
        isatty=lambda: True))
    assert tbench._tinted(speedup, "x") == jbench._tinted(speedup, "x")
    monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(
        isatty=lambda: False))
    assert tbench._tinted(speedup, "x") == "x"


# ---------------------------------------------------------------------------
# graft_entry
# ---------------------------------------------------------------------------


def test_entry_frame_matches_graft_entry():
    """graft_entry.entry("cpu")'s frame against jax.jit of
    __graft_entry__.entry()'s (the "auto" route: Cube's bins, B2's plain
    version here, the Pallas kernel in interpret mode there)."""
    fn, args = graft_entry.entry("cpu")
    got = fn(*args)
    assert got.shape == (H, W) and got.dtype == torch.uint32
    jfn, jargs = _load("jax_root_graft_entry", "__graft_entry__.py").entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    diff = int((want != got.numpy()).sum())
    assert diff <= GOLDEN_FRAC * W * H, diff
    bg = np.asarray(jpp.background(0, W, H))
    assert (want != bg).sum() > W * H // 10  # the cube is drawn


def test_entry_needs_the_card_and_reexports_the_dry_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    assert graft_entry.dryrun_multichip is multidev.dryrun_multichip
