"""The benchmark's exact all-pairs N-body cell (nbody.brute131k) on the
CPU, at small N.

The port's theta-0 step against the plain reference
(perfbench/reference/nbody_brute.py) within the check's limits
(perfbench/checks/nbody_brute.py, the configuration's
``correct_limits``): at N 4,096 through kernel B5's plain version, at N
1,000 through the dense torch form. The reference's field is float64 all
pairs within float32 rounding, and the controls (bfloat16, the block
Barnes-Hut field) over the limits. The whole cell through the harness
(set-up, window, check) with the configuration cut to 4,096 bodies, sound
and with faults planted: each fault reads ``correct`` false. The entry
refuses any route but B5; the benchmark's new files load nothing of JAX
or the program; the per-layer readers read the card's time by span and
by kernel name, None without them; the roofline's bound is the
configuration's pairs.

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

import pytest
import torch

from perfbench import control_brute, harness, roofline_brute, \
    roofline_nbody, spec
from perfbench.checks import nbody_brute as check
from perfbench.reference import nbody as bh_ref
from perfbench.reference import nbody_brute as ref
from rustexp_tpu_torch.ops import nbody_bh, nbody_pallas
from rustexp_tpu_torch.sims.nbody import NBodyExperiment

ROOT = Path(__file__).resolve().parents[1]
N = 4096
SEED = 2**31 + 26
CELL = "nbody.brute131k"
NAMES = check.NAMES
# 4,096 bodies make 16 blocks of 256: the configuration's 27 near blocks
# would take all of them and be exact, so the Barnes-Hut field here takes 6
SMALL_K = 6


def small_cell(n: int = N):
    """The cell with `n` bodies, one warm-up step, two sampled."""
    cell = spec.Cell(spec.load_benchmark(), CELL)
    cell.config = {**cell.config, "n": n}
    cell.traffic = {**cell.traffic, "warmup_frames": 1, "sample_frames": 2}
    return cell


CFG = small_cell().config
LIMITS = CFG["correct_limits"]


def port_steps(n: int):
    """(before, after) of the port's fourth theta-0 step from a seeded
    state of `n` bodies."""
    exp = NBodyExperiment("cpu")
    s = exp.init("orbits", n, CFG["rmin"], CFG["rmax"], SEED, CFG["dt"],
                 CFG["theta"])
    for _ in range(3):
        exp.step(s)
    before = (s.px, s.py, s.vx, s.vy, s.m)
    exp.step(s)
    return before, (s.px, s.py, s.vx, s.vy, s.m)


@pytest.fixture(scope="module")
def steps():
    return port_steps(N)


def test_routing_is_the_configurations():
    full = spec.Cell(spec.load_benchmark(), CELL).config["n"]
    assert full == 131_072
    exp = NBodyExperiment("cpu")
    for n in (N, full):
        assert exp.select_backend(n, CFG["theta"]) == ("brute", None)
        assert n % nbody_pallas.T_TILE == 0


@pytest.mark.parametrize("n", [N, 1000])
def test_port_step_within_the_checks_limits(n):
    """4,096 takes B5's plain version, 1,000 the dense [N, N] form. Both
    sum the reference's exact terms in another order (and the dense form
    forms m_i m_j inside the sum), so they part by float32 rounding alone:
    an acceleration within 1e-5 of the larger of its own size and the
    median's (some 20 roundings of the largest terms), a position within
    64 spacings (the sun's, near the origin, moves by float32 rounding of
    a near-cancelling sum)."""
    before, after = port_steps(n)
    got = check.compare(CFG, before, after, 4)
    for k in NAMES:
        assert got[k] <= LIMITS[k], (k, got)
    assert got["accel_rel_err"] < 1e-5 and got["pos_off_ulps"] < 64, got


def test_reference_field_is_all_pairs_in_float64_to_rounding(monkeypatch):
    """The reference's float32 field against exact_accel's float64 sum of
    the same law, over every body: within 1e-5 of the larger of its size
    and the median's (float32 sums of a few thousand terms), with the
    sources in several chunks; a body's own term is exactly zero."""
    px, py, _, _, m = bh_ref.stable_orbits(1500, 0.5, 30.0, 5, "cpu")
    ex, ey = bh_ref.exact_accel(px, py, m, torch.arange(1500))
    mag = torch.hypot(ex, ey)
    monkeypatch.setattr(ref, "CHUNK_ELEMS", 1500 * 256)  # 6 chunks
    ax, ay = ref.accel_all_pairs(px, py, m)
    err = torch.hypot(ax.double() - ex, ay.double() - ey)
    assert float((err / mag.clamp(min=float(mag.median()))).max()) < 1e-5
    one = torch.tensor([3.0])
    assert [float(a) for a in ref.accel_all_pairs(one, one, one)] == [0, 0]


@pytest.mark.parametrize("control", ["bf16", "bh"])
def test_controls_are_over_a_limit(steps, control):
    before, _ = steps
    if control == "bf16":
        out = ref.step(*before, dt=CFG["dt"], dtype=torch.bfloat16)
    else:
        out = control_brute.bh_step(*before, dt=CFG["dt"], k_near=SMALL_K)
    got = check.compare(CFG, before, out, 4)
    assert got["accel_rel_err"] > LIMITS["accel_rel_err"], got
    assert got["accel_p99_vs_exact"] > LIMITS["accel_p99_vs_exact"], got


def test_bh_control_keeps_the_state_order(steps):
    """The Barnes-Hut control's field is put back into the state's order:
    with every block near it is the all-pairs field to rounding."""
    before, _ = steps
    px, py, _, _, m = before
    ax, ay = control_brute.bh_accel(px, py, m, 256, N // 256)
    rx, ry = ref.accel_all_pairs(px, py, m)
    mag = torch.hypot(rx, ry)
    err = torch.hypot(ax - rx, ay - ry) / mag.clamp(min=float(mag.median()))
    assert float(err.max()) < 1e-5


# ---------------------------------------------------------------------------
# The cell through the harness, sound and with planted faults
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_run(monkeypatch):
    """On the CPU the forces take B5's plain version, which counts
    nothing: count its calls as B5's 2 launches, as on the card."""
    plain = nbody_pallas.forces_pallas_plain

    def counted(*a):
        nbody_pallas.forces_pallas_cuda.launches += 2
        return plain(*a)

    monkeypatch.setattr(nbody_pallas, "forces_pallas_plain", counted)
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
    assert list(line["checks"]) == [*NAMES, "steps_not_run"]
    assert line["checks"]["steps_not_run"] == {"value": 0, "limit": 0}
    for k in NAMES:
        assert line["checks"][k]["limit"] == LIMITS[k]
        assert f"check {k} " in err
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


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


def bh_in_b5(monkeypatch):
    """Plant the port's block Barnes-Hut field (Morton order, blocks of
    256, SMALL_K near blocks, monopoles) in B5's place, its launches
    counted, so that only the numbers of the field can tell."""

    def forces(px, py, m):
        nbody_pallas.forces_pallas_cuda.launches += 2
        codes = nbody_bh.morton_codes(px, py, px.min(), px.max(), py.min(),
                                      py.max())
        o = torch.argsort(codes.to(torch.int64), stable=True)
        fx, fy = nbody_bh.forces_bh_sorted(px[o], py[o], m[o], 256, SMALL_K)
        gx, gy = torch.empty_like(fx), torch.empty_like(fy)
        gx[o], gy[o] = fx / m[o], fy / m[o]
        return gx, gy

    monkeypatch.setattr(nbody_pallas, "forces_pallas_plain", forces)


@pytest.mark.parametrize("how,numbers", [
    ("frozen", ["steps_not_run"]),
    ("bh", ["accel_rel_err", "accel_p99_vs_exact"])])
def test_planted_fault_is_not_correct(cpu_run, monkeypatch, how, numbers):
    if how == "bh":
        bh_in_b5(monkeypatch)
    rc, line, err = run(Frozen() if how == "frozen" else None)
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] > 0
    for k in numbers:
        assert line["checks"][k]["value"] > line["checks"][k]["limit"], k


@pytest.mark.parametrize("change", [{"theta": 0.85}, {"n": 1000}])
def test_entry_refuses_any_route_but_b5(change):
    """theta 0.85 routes 4,096 bodies to block Barnes-Hut; 1,000 bodies
    (no multiple of 1,024) to the dense torch form."""
    cell = small_cell()
    with pytest.raises(RuntimeError, match="routes"):
        cell.entry().Entry({**cell.config, **change}, cell.traffic,
                           torch.device("cpu"), seed=SEED)


# ---------------------------------------------------------------------------
# The files import nothing of JAX or the program; the per-layer readers
# ---------------------------------------------------------------------------

BENCH_FILES = ["perfbench.reference.nbody_brute",
               "perfbench.checks.nbody_brute", "perfbench.control_brute",
               "perfbench.roofline_brute"]
READERS = ["brute_force_device_ms_per_frame", "b5_roofline"]


def test_benchmark_files_load_no_jax_and_no_program():
    code = (
        "import importlib, sys\n"
        f"for m in {BENCH_FILES!r}: importlib.import_module(m)\n"
        "from perfbench import spec\n"
        f"c = spec.Cell(spec.load_benchmark(), {CELL!r})\n"
        f"for r in {READERS!r}: c.metric_reader(r)\n"
        "c.check()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "      & {'jax', 'jaxlib', 'rustexp_tpu', 'rustexp_tpu_torch'}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _ev(name, start=0.0, end=0.0, id_=0, parent=None):
    return SimpleNamespace(name=name, id=id_, cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end))


B5_KERNELS = ("void (anonymous namespace)::forces_kernel<false>(float "
              "const*, float const*, float const*, float*, float*, int, "
              "int)",
              "(anonymous namespace)::combine_kernel(float const*, float "
              "const*, float*, float*, int, int)")


def fake_trace(spans: bool, b5: bool = True):
    """Two profiled steps: B5's two kernels and a multiply under
    nbody.brute, the update under nbody.integrate (or all under plain
    torch ops, as on a program without spans); other kernels in B5's
    place where `b5` is False."""
    frame = _ev("frame")
    host, device = [], []
    kernels = [(B5_KERNELS[0] if b5 else "void at::native::k0(float)",
                "nbody.brute", 20000.0),
               (B5_KERNELS[1] if b5 else "void at::native::k1(float)",
                "nbody.brute", 600.0),
               ("void at::native::vectorized_elementwise_kernel<4>(int)",
                "nbody.brute", 10.0),
               ("void at::native::vectorized_elementwise_kernel<4>(int)",
                "nbody.integrate", 30.0)]
    for i, (kernel, name, us) in enumerate(kernels):
        span = _ev(name, parent=frame) if spans else frame
        op = _ev("aten::mul", parent=span)
        host.append(_ev("cudaLaunchKernel", id_=i, parent=op))
        device.append(_ev(kernel, 0.0, us, id_=i))
    session = SimpleNamespace(host=host, device=device, frames=2)
    return SimpleNamespace(session=session,
                           cell=spec.Cell(spec.load_benchmark(), CELL))


def test_readers_read_device_time_by_span_and_b5_by_name():
    t = fake_trace(spans=True)
    cell = spec.Cell(spec.load_benchmark(), CELL)
    read = {r: cell.metric_reader(r)(t) for r in READERS}
    assert read["brute_force_device_ms_per_frame"] == pytest.approx(10.305)
    bound, _ = roofline_brute.force_bound_s(cell.config)
    assert read["b5_roofline"] == pytest.approx(100 * bound / 10.3e-3)


def test_readers_none_without_their_spans_or_kernels():
    cell = spec.Cell(spec.load_benchmark(), CELL)
    brute = cell.metric_reader("brute_force_device_ms_per_frame")
    b5 = cell.metric_reader("b5_roofline")
    assert brute(fake_trace(spans=False)) is None
    # B5 is matched by its kernels' names, spans or not
    assert b5(fake_trace(spans=False)) is not None
    assert b5(fake_trace(spans=True, b5=False)) is None


def test_b5_bound_is_the_configurations_pairs():
    cfg = spec.Cell(spec.load_benchmark(), CELL).config
    assert roofline_brute.pairs(131_072) == 131_072 * 131_071 / 2
    bound, by = roofline_brute.force_bound_s(cfg)
    assert by == "fp32"
    # 8.59e9 pairs at 10 FP32 instructions each over 128 lanes x 132 SMs
    # x 1.98 GHz: 2.564 ms at the data sheet's rounded 3.35e13/s
    assert bound == pytest.approx(2.564e-3, rel=2e-3)
    assert bound == pytest.approx(131_072 * 131_071 * 5 / 3.3454e13,
                                  rel=1e-4)
    # one reciprocal a pair on the SFU's 16 lanes: 2.054 ms, under it
    rcp = roofline_brute.pairs(131_072) / roofline_nbody.RCP_PER_S
    assert rcp == pytest.approx(2.054e-3, rel=1e-3) and rcp < bound
