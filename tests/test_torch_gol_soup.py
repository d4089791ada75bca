"""The benchmark's Game of Life cell (gol.2048) on the CPU, at small
sizes.

The port's GoL step (kernel B4's plain version) against the plain
reference (perfbench/reference/gol.py) cell for cell, over grid shapes
and generation counts across B4's 16-generation launches. The whole cell
through the harness (set-up, window, check) with the grid cut to 512^2,
sound and with faults planted: each fault reads ``correct`` false on
its number. The entry refuses any route but B4's tiled form; the
controls differ from the reference; the program opens the GoL spans;
the benchmark's new files load nothing of JAX or the program; the
per-layer readers read the card's time by span and B4 by name, None
without them; the roofline's circuit is a Game of Life generation and
its bound the hand figure.

This test process has JAX loaded (tests/conftest.py), so the harness's
own refusal of a process with JAX in it is turned off around its runs
here; the subprocess test holds the files themselves to it.
"""

import io
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import control_gol, harness, roofline, roofline_gol, spec
from perfbench.checks import gol as check
from perfbench.reference import gol as ref
from rustexp_tpu_torch.core import trace
from rustexp_tpu_torch.ops import gol_bits
from rustexp_tpu_torch.sims.gol import GoLExperiment, GoLState

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 28
CELL = "gol.2048"
N = 512  # [16, 512] packed words: B4's tiled form, as at 2048^2


def soup(shape, seed: int = SEED) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, shape, generator=g, dtype=torch.uint8)


def small_cell(n: int = N):
    """The cell at n^2, one warm-up step, two sampled, a reseed every 16
    steps (at most 1,024 generations: a small soup is still live)."""
    cell = spec.Cell(spec.load_benchmark(), CELL)
    cell.config = {**cell.config, "n": n}
    cell.traffic = {**cell.traffic, "warmup_frames": 1, "sample_frames": 2,
                    "reseed_every": 16}
    return cell


CFG = small_cell().config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The grids' small uint8 passes, each split over every core, slow to
    a crawl when other test processes hold the cores: one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [1, 15, 16, 17, 64])
@pytest.mark.parametrize("shape", [(64, 64), (96, 128), (256, 256)])
def test_experiment_step_equals_reference(shape, k):
    """B4's plain version through the Experiment, cell for cell."""
    exp = GoLExperiment("cpu")
    grid = soup(shape, SEED + k)
    st = GoLState(grid=grid, steps_per_frame=k)
    assert exp.route(shape[0], st.backend) == "bits"
    exp.step(st)
    assert st.grid.dtype == torch.uint8 and st.grid.shape == shape
    assert torch.equal(st.grid, ref.run(grid, k))
    assert not torch.equal(st.grid, grid)


def test_configuration_routes_to_b4_tiled():
    cfg = spec.Cell(spec.load_benchmark(), CELL).config
    assert (cfg["n"], cfg["steps_per_frame"]) == (2048, 64)
    assert GoLExperiment.route(cfg["n"], cfg["backend"]) == "bits"
    assert gol_bits._b4_plan(64, 2048, 64) == ("tiled", 4)
    assert gol_bits._b4_plan(N // 32, N, 64).form == "tiled"


@pytest.mark.parametrize("control", control_gol.CONTROLS)
def test_controls_read_cells_off(control):
    """Each control's step of a live soup differs from the reference's."""
    entry = control_gol.ControlEntry(CFG, small_cell().traffic, control,
                                     SEED, torch.device("cpu"))
    (before, after), _ = entry.frame(0.0)
    got = check.compare(CFG, before, after)
    assert got["cells_off"] > CFG["correct_limits"]["cells_off"], got
    assert got["static_samples"] == 0


def test_compare_counts_every_cell_of_a_bad_grid():
    g = soup((N, N))
    ok = ref.run(g, CFG["steps_per_frame"])
    assert check.compare(CFG, g, ok) == {"cells_off": 0, "static_samples": 0}
    for bad in (ok.to(torch.int32), ok[:-1], ok * 2):
        assert check.compare(CFG, g, bad)["cells_off"] == N * N
    # a still life (a 2x2 block) is a static sample
    still = torch.zeros((N, N), dtype=torch.uint8)
    still[10:12, 10:12] = 1
    assert check.compare(CFG, still, still) == {"cells_off": 0,
                                                 "static_samples": 1}


# ---------------------------------------------------------------------------
# The cell through the harness, sound and with planted faults
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_run(monkeypatch):
    """On the CPU the generations take B4's plain version, which counts
    nothing: count its calls as B4's tiled launches, as on the card."""
    plain = gol_bits.multi_step_packed_plain

    def counted(p, k):
        gol_bits.multi_step_packed_cuda.launches += gol_bits._b4_plan(
            *p.shape, k, "tiled").launches
        return plain(p, k)

    monkeypatch.setattr(gol_bits, "multi_step_packed_plain", counted)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def run(entry=None):
    cell = small_cell()
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, SEED, 0.3, False, torch.device("cpu"),
                          time.perf_counter(), entry=entry, out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return rc, line, err.getvalue()


def test_sound_run_is_correct(cpu_run):
    rc, line, err = run()
    assert rc == 0 and line["correct"] and line["failed"] == 0, err
    assert line["checks"] == {k: {"value": 0, "limit": 0} for k in
                              ("cells_off", "static_samples",
                               "steps_not_run")}
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_entry_reseeds_at_the_traffics_cadence(cpu_run, monkeypatch):
    """R before steps 0, 16, 32: from the run's seed, as the viewer's key
    draws it."""
    cell = small_cell()
    entry = cell.entry().Entry(cell.config, cell.traffic,
                               torch.device("cpu"), seed=SEED)
    pressed = []
    key = entry.exp.handle_key
    monkeypatch.setattr(entry.exp, "handle_key", lambda st, k: (
        pressed.append(entry.steps) or key(st, k)))
    for _ in range(33):
        entry.frame(0.0)
    assert pressed == [0, 16, 32]
    exp = GoLExperiment("cpu")
    st = exp.handle_key(exp.init(seed=SEED, n=N), "R")
    entry = cell.entry().Entry(cell.config, cell.traffic,
                               torch.device("cpu"), seed=SEED)
    (before, _), _ = entry.frame(0.0)
    assert torch.equal(before, st.grid)


class Frozen:
    """The cell's own entry, handing back its first step from then on:
    a step skipped, nothing launched."""

    def __init__(self):
        cell = small_cell()
        self.inner = cell.entry().Entry(cell.config, cell.traffic,
                                        torch.device("cpu"), seed=SEED)
        self.launches = self.inner.launches
        self.first = None

    def frame(self, tick):
        if self.first is None:
            self.first = self.inner.frame(tick)
        return self.first

    def start_counting(self):
        pass

    def stop_counting(self):
        return None

    def close(self):
        self.inner.close()


def plant(monkeypatch, how):
    """Plant a fault in B4's plain version, its launches counted: `stale`
    returns the words it was given, `short` runs one generation fewer."""
    plain = gol_bits.multi_step_packed_plain

    def faulty(p, k):
        gol_bits.multi_step_packed_cuda.launches += 1
        return gol_bits._words(p) if how == "stale" else plain(p, k - 1)

    monkeypatch.setattr(gol_bits, "multi_step_packed_plain", faulty)


@pytest.mark.parametrize("how,number", [("frozen", "steps_not_run"),
                                        ("stale", "cells_off"),
                                        ("short", "cells_off")])
def test_planted_fault_is_not_correct(cpu_run, monkeypatch, how, number):
    if how != "frozen":
        plant(monkeypatch, how)
    rc, line, err = run(Frozen() if how == "frozen" else None)
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] > 0
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]
    assert line["checks"]["static_samples"]["value"] == 0


@pytest.mark.parametrize("change,route", [
    ({"n": 2000}, "'mxu'"), ({"backend": "pallas"}, "'pallas'"),
    ({"n": 256}, "resident form")])
def test_entry_refuses_any_route_but_b4_tiled(change, route):
    """2000 rows (no multiple of 32) go to the circulant form, "pallas"
    to kernel B8, 256^2 to B4's resident form."""
    cell = small_cell()
    with pytest.raises(RuntimeError, match=f"routes .*{route}"):
        cell.entry().Entry({**cell.config, **change}, cell.traffic,
                           torch.device("cpu"), seed=SEED)


# ---------------------------------------------------------------------------
# The program's spans
# ---------------------------------------------------------------------------


@pytest.fixture
def spans():
    trace.reset_spans()
    yield
    trace.reset_spans()


def test_step_and_r_key_spans(spans):
    """A step is one `frame` with each of B4's three stages once (no card,
    no synchronize); the R key is one gol.randomize."""
    exp = GoLExperiment("cpu")
    st = exp.handle_key(exp.init(seed=SEED, steps_per_frame=16, n=64), "R")
    assert {k: c for k, (c, _) in trace.span_totals().items()} == {
        "gol.randomize": 1}
    trace.reset_spans()
    for steps in (1, 2):
        exp.step(st)
        assert {k: c for k, (c, _) in trace.span_totals().items()} == {
            "frame": steps, "gol.pack": steps, "gol.swar": steps,
            "gol.unpack": steps}
    tot = trace.span_totals()
    assert tot["frame"][1] >= sum(tot[k][1] for k in
                                  ("gol.pack", "gol.swar", "gol.unpack"))


# ---------------------------------------------------------------------------
# The files import nothing of JAX or the program; the per-layer readers
# ---------------------------------------------------------------------------

BENCH_FILES = ["perfbench.reference.gol", "perfbench.checks.gol",
               "perfbench.control_gol", "perfbench.roofline_gol"]
READERS = ["gol_pack_device_ms_per_frame", "gol_host_ms_per_frame",
           "b4_roofline"]


def test_benchmark_files_load_no_jax_and_no_program():
    code = (
        "import importlib, sys\n"
        f"for m in {BENCH_FILES!r}: importlib.import_module(m)\n"
        "from perfbench import spec\n"
        f"c = spec.Cell(spec.load_benchmark(), {CELL!r})\n"
        f"for r in {READERS!r}: c.metric_reader(r)\n"
        "c.check(); c.entry()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "      & {'jax', 'jaxlib', 'rustexp_tpu', 'rustexp_tpu_torch'}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _ev(name, start=0.0, end=0.0, id_=0, parent=None):
    return SimpleNamespace(name=name, id=id_, cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end))


B4_KERNEL = ("void (anonymous namespace)::swar_kernel<7, true>(unsigned "
             "int const*, unsigned int*, int, int, int, int, int, int, int)")


def fake_trace(spans: bool, b4: bool = True):
    """Two profiled steps: the pack's kernels under gol.pack, four B4
    launches under gol.swar, the unpack's under gol.unpack (or all under
    plain torch ops, as on a program without spans); another kernel in
    B4's place where `b4` is False."""
    frame = _ev("frame")
    host, device = [], []
    kernels = [("void at::native::reduce_kernel<512, 1>(int)", "gol.pack",
                30.0),
               ("void at::native::vectorized_elementwise_kernel<4>(int)",
                "gol.pack", 10.0)]
    kernels += [(B4_KERNEL if b4 else "void at::native::k0(int)", "gol.swar",
                 18.0)] * 4
    kernels += [("void at::native::elementwise_kernel<128, 2>(int)",
                 "gol.unpack", 40.0)]
    for i, (kernel, name, us) in enumerate(kernels):
        span = _ev(name, parent=frame) if spans else frame
        op = _ev("aten::sum", parent=span)
        host.append(_ev("cudaLaunchKernel", id_=i, parent=op))
        device.append(_ev(kernel, 0.0, us, id_=i))
    session = SimpleNamespace(host=host, device=device, frames=2)
    return SimpleNamespace(session=session,
                           cell=spec.Cell(spec.load_benchmark(), CELL))


def reader(name):
    return spec.Cell(spec.load_benchmark(), CELL).metric_reader(name)


def test_readers_read_device_time_by_span_and_b4_by_name():
    t = fake_trace(spans=True)
    assert reader("gol_pack_device_ms_per_frame")(t) == pytest.approx(0.04)
    bound, _ = roofline_gol.step_bound_s(t.cell.config)
    assert reader("b4_roofline")(t) == pytest.approx(100 * bound / 36e-6)


def test_host_reader_is_frame_less_sync(monkeypatch):
    monkeypatch.setattr(trace, "span_totals", lambda: {
        "frame": (100, 30_000_000), "experiment.sync": (100, 10_000_000),
        "gol.pack": (100, 5_000_000)})
    assert reader("gol_host_ms_per_frame")(None) == pytest.approx(0.2)


def test_readers_none_without_their_spans_or_kernels(monkeypatch):
    assert reader("gol_pack_device_ms_per_frame")(
        fake_trace(spans=False)) is None
    # B4 is matched by its kernel's name, spans or not
    assert reader("b4_roofline")(fake_trace(spans=False)) is not None
    assert reader("b4_roofline")(fake_trace(spans=True, b4=False)) is None
    host = reader("gol_host_ms_per_frame")
    monkeypatch.setattr(trace, "span_totals", lambda: {})
    assert host(None) is None
    monkeypatch.setitem(sys.modules, "rustexp_tpu_torch.core.trace",
                        type(sys)("rustexp_tpu_torch.core.trace"))
    assert host(None) is None


# ---------------------------------------------------------------------------
# The roofline's circuit and bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (96, 128), (32, 40)])
def test_circuit_is_a_generation(shape):
    """The 12 gates on random words equal the reference's generation of
    the unpacked grid, packed the same way."""
    g = soup(shape, SEED + shape[1])
    words = gol_bits.pack_rows(g).view(torch.int32).numpy().view(np.uint32)
    got = roofline_gol.generation(words)
    want = gol_bits.pack_rows(ref.generation(g)).view(torch.int32).numpy()
    assert np.array_equal(got, want.view(np.uint32))
    assert roofline_gol.GATES_PER_WORD == 12


def test_b4_bound_is_the_configurations_words():
    cfg = spec.Cell(spec.load_benchmark(), CELL).config
    bound, by = roofline_gol.step_bound_s(cfg)
    assert by == "operations"
    # 65,536 x 2 words x 64 generations x 12 gates on 64 integer lanes x
    # 132 SMs x 1.98 GHz
    assert bound == pytest.approx(131_072 * 64 * 12 / 1.672704e13, rel=1e-12)
    assert bound == pytest.approx(6.018e-6, rel=1e-4)
    assert roofline.INT_OPS_PER_S == pytest.approx(1.672704e13)
    # the packed grid read and written once: 1 MiB at 3.35 TB/s
    assert 2 * 131_072 * 4 / roofline.HBM_BYTES_PER_S < bound / 19
