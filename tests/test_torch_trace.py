"""The port's spans (rustexp_tpu_torch/core/trace.py): their totals, the
spans one frame of each entry point opens, their place among a
torch.profiler session's host events, the viewer's report of them, and
the attribution of the card's idle gaps to them (tools/span_idle.py).

The CPU tests need no card. The ``cuda`` tests profile a bench frame on
the card and match each device activity to its launch by correlation id;
this file imports no jax, so on the card's machine it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_trace.py
"""

import json
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from rustexp_tpu_torch.app import benchmark as bm
from rustexp_tpu_torch.app import viewer
from rustexp_tpu_torch.core import trace
from rustexp_tpu_torch.sims.nbody import NBodyExperiment
from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment
from tools import span_idle

SPHERE, CUBE = 0, 9  # the queue (kernel B1) and the bins (kernel B2)


@pytest.fixture
def spans():
    """Totals cleared before the test and after it."""
    trace.reset_spans()
    yield
    trace.reset_spans()


def calls(prefix: str = "", name: str | None = None) -> int:
    tot = trace.span_totals()
    if name is not None:
        return tot.get(name, (0, 0))[0]
    return sum(c for k, (c, _) in tot.items() if k.startswith(prefix))


def test_span_totals_count_calls_and_ns_and_nest(spans):
    with trace.span("outer"):
        for _ in range(3):
            with trace.span("inner"):
                time.sleep(0.001)
    tot = trace.span_totals()
    assert tot["outer"][0] == 1 and tot["inner"][0] == 3
    assert tot["inner"][1] >= 3_000_000          # three 1 ms sleeps, in ns
    assert tot["outer"][1] >= tot["inner"][1]    # inclusive of its children
    tot["outer"] = (99, 0)                       # a copy: the totals stay
    assert trace.span_totals()["outer"][0] == 1
    with pytest.raises(KeyError):
        with trace.span("raising"):
            raise KeyError("x")
    assert calls(name="raising") == 1            # counted on the way out
    trace.reset_spans()
    assert trace.span_totals() == {}


def test_upload_is_one_sync_span_a_copy(spans):
    t = torch.arange(4, dtype=torch.float32)
    out = trace.upload("thing", t, "cpu")
    assert torch.equal(out, t)
    assert trace.span_totals().keys() == {"sync.upload.thing"}
    assert calls(name="sync.upload.thing") == 1


@pytest.fixture(scope="module")
def bench_frames():
    return {m: bm.scene_frame(m, True, torch.device("cpu"))[0]
            for m in (SPHERE, CUBE)}


@pytest.mark.parametrize("mesh_idx", [SPHERE, CUBE])
def test_bench_frame_spans(bench_frames, spans, mesh_idx):
    """One scene_frame frame: one of each layer's spans and the three
    pageable uploads (background, view matrix, eye), which are the
    bench cells' three synchronizing calls a frame on the card."""
    frame = bench_frames[mesh_idx]
    frame()  # first-use uploads (cached constants) happen once
    trace.reset_spans()
    frame()
    for name in ("frame", "raster.frame", "raster.setup", "raster.transform",
                 "raster.kernel", "raster.shade"):
        assert calls(name=name) == 1, (name, trace.span_totals())
    assert calls("sync.upload.") == 3
    assert calls("sync.") == 3
    assert {k for k in trace.span_totals() if k.startswith("sync.")} == {
        "sync.upload.background", "sync.upload.matrix", "sync.upload.eye"}


def test_experiment_stale_frame_rebuilds_and_renders_twice(spans):
    """At 128x128 the sphere's queue built at tick 0 is stale one frame
    later: one rebuild, one read of the flag, two renders, each through
    the raster kernel's call; the rebuild holds the queue build and its
    host read."""
    exp = RasterizerExperiment("cpu")
    st = exp.init(per_pixel=True, mesh_idx=SPHERE)
    exp.render(st, 128, 128, 0.0)
    assert calls(name="frame") == 1 and calls(name="experiment.rebuild") == 0
    assert calls(name="structure.queue") == 1    # the first build
    trace.reset_spans()
    exp.render(st, 128, 128, 1 / 60)
    assert calls(name="frame") == 1
    assert calls(name="experiment.rebuild") == 1
    assert calls(name="sync.read.stale") == 1
    assert calls(name="structure.queue") == 1
    assert calls(name="sync.read.queue_stats") == 1
    assert calls(name="raster.frame") == 2 and calls(name="raster.kernel") == 2
    assert calls(name="experiment.sync") == 0    # no card, no synchronize
    tot = trace.span_totals()
    assert tot["experiment.rebuild"][1] >= tot["structure.queue"][1]


NBODY_STAGES = ("nbody.sort", "nbody.blocks", "nbody.near", "nbody.far",
                "nbody.integrate")


BRUTE_STAGES = ("nbody.brute", "nbody.integrate")


@pytest.mark.parametrize("theta,stages", [(0.85, NBODY_STAGES),
                                          (0.0, BRUTE_STAGES)])
def test_nbody_step_spans(spans, theta, stages):
    """One N-body step is one `frame`; on the Barnes-Hut route (4,096
    bodies: 16 blocks of 256) each of its five stages once, on the brute
    route (B5's plain version) its forces and its update once. No card,
    no synchronize."""
    exp = NBodyExperiment("cpu")
    st = exp.init("orbits", 4096, theta=theta)
    for steps in (1, 2):
        exp.step(st)
        assert calls(name="frame") == steps
        for name in {*NBODY_STAGES, *BRUTE_STAGES}:
            assert calls(name=name) == steps * (name in stages), name
        assert calls(name="experiment.sync") == 0
    tot = trace.span_totals()
    assert tot["frame"][1] >= sum(tot[k][1] for k in stages)
    assert set(tot) == {"frame", *stages}


def test_nbody_dense_brute_step_spans(spans):
    """1,000 bodies (no multiple of 1,024) take the dense torch form,
    with the same two spans as B5's route."""
    exp = NBodyExperiment("cpu")
    exp.step(exp.init("orbits", 1000, theta=0.0))
    assert {k: c for k, (c, _) in trace.span_totals().items()} == {
        "frame": 1, "nbody.brute": 1, "nbody.integrate": 1}


def test_spans_are_profiler_events_under_their_parents(bench_frames, spans):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame = bench_frames[CUBE]
    frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame()
    ev = {e.name: e for e in prof.events()
          if e.device_type == DeviceType.CPU}
    for name, parent in (("frame", None), ("raster.frame", "frame"),
                         ("raster.setup", "raster.frame"),
                         ("raster.transform", "raster.setup"),
                         ("raster.kernel", "raster.frame"),
                         ("raster.shade", "raster.frame"),
                         ("sync.upload.background", "raster.frame"),
                         ("sync.upload.matrix", "raster.transform")):
        assert name in ev, (name, sorted(ev))
        got = ev[name].cpu_parent
        assert (got.name if got is not None else None) == parent, name
    assert calls(name="raster.setup") == 2       # the totals count as ever


def test_no_profiler_no_record_function(bench_frames, spans, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record function made with no profiler")

    monkeypatch.setattr(trace, "_record", boom)
    bench_frames[CUBE]()
    assert calls(name="frame") == 1


def test_viewer_report_holds_spans_per_frame(spans, monkeypatch, capsys):
    """The report's spans are per viewed frame, counted from the loop's
    start (a 64-px window renders through the G-buffer oracle)."""

    class Term:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def poll_key(self):
            return None

    monkeypatch.setattr(viewer, "_RawTerm", Term)
    monkeypatch.setattr(sys.stdout, "write", lambda s: len(s))
    with trace.span("before the loop"):
        pass
    n = viewer.run_viewer(size=64, fps=1000.0, frames=4, start=2,
                          report=True, device="cpu")
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    sp = rec["spans"]
    assert n == 4 and "before the loop" not in sp
    for name in ("frame", "raster.frame", "raster.setup", "raster.kernel",
                 "sync.read.stale"):
        assert sp[name]["calls"] == 1.0, (name, sp)
    assert sp["frame"]["host_ms"] >= sp["raster.frame"]["host_ms"] > 0


def _ev(name, start=0.0, end=0.0, id_=0, parent=None):
    return SimpleNamespace(name=name, id=id_, cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end))


def test_idle_gaps_go_to_the_innermost_span():
    frame = _ev("frame")
    kern = _ev("raster.kernel", parent=_ev("raster.frame", parent=frame))
    up = _ev("sync.upload.eye", parent=_ev("raster.shade", parent=frame))
    host = [_ev("cudaLaunchKernel", id_=1, parent=kern),
            _ev("cudaMemcpyAsync", id_=2, parent=_ev("aten::copy_",
                                                     parent=up)),
            _ev("cudaLaunchKernel", id_=3, parent=_ev("aten::mul")),
            _ev("aten::mul", id_=4)]
    dev = [_ev("k0", 0, 10, 9), _ev("queue_raster_kernel", 30, 40, 1),
           _ev("Memcpy HtoD", 45, 46, 2), _ev("k", 50, 51, 3),
           _ev("k", 60, 61, 4), _ev("k", 70, 71, 5)]
    names = {"frame", "raster.frame", "raster.kernel", "raster.shade",
             "sync.upload.eye"}
    got = span_idle.idle_by_span(dev, host, names)
    assert got == {"raster.kernel": pytest.approx(20e-6),
                   "sync.upload.eye": pytest.approx(5e-6),
                   "no span": pytest.approx(4e-6),
                   "launch not recorded": pytest.approx(18e-6)}


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py on the card)")
    return torch.device("cuda")


def _launch_chain(session, act) -> list[str]:
    """The host events above the runtime call that launched `act`."""
    call = next((e for e in session.host
                 if e.id == act.id and e.name.startswith("cuda")), None)
    assert call is not None, f"no launch recorded for {act.name}"
    chain, p = [], call.cpu_parent
    while p is not None:
        chain.append(p.name)
        p = p.cpu_parent
    return chain


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_idx,kernel",
                         [(SPHERE, "queue_raster_kernel"),
                          (CUBE, "bins_raster_kernel")])
def test_card_activities_launched_inside_their_spans(mesh_idx, kernel):
    """On the profiler's clock: every device activity of a bench frame was
    launched inside raster.frame, and the raster kernel inside
    raster.kernel (matched by correlation id); no span adds a device
    activity of its own, which the device metrics would count as busy."""
    from perfbench import profiling

    dev = _card()
    frame = bm.scene_frame(mesh_idx, True, dev)[0]
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    session = profiling.profile_frames(frame, 2)
    names = set(trace.span_totals())
    assert not [a.name for a in session.device if a.name in names]
    rasters = [a for a in session.device if kernel in a.name]
    assert len(rasters) == session.frames == 2
    for act in session.device:
        chain = _launch_chain(session, act)
        assert "raster.frame" in chain and "frame" in chain, (act.name, chain)
    for act in rasters:
        assert "raster.kernel" in _launch_chain(session, act)


@pytest.mark.cuda
def test_card_activities_of_an_nbody_step_inside_its_stages():
    """On the profiler's clock: every device activity of a Barnes-Hut
    step at 131,072 bodies was launched inside `frame` and one of the
    five stage spans (matched by correlation id), and B6's twelve
    launches inside nbody.sort."""
    from perfbench import profiling

    dev = _card()
    exp = NBodyExperiment(dev)
    st = exp.init("orbits", 131_072)
    for _ in range(2):
        exp.step(st)
    session = profiling.profile_frames(lambda: exp.step(st), 2)
    b6 = ("::count_kernel(", "::scan_kernel(", "::scatter_kernel(")
    sorts = 0
    for act in session.device:
        chain = _launch_chain(session, act)
        stage = [n for n in chain if n in NBODY_STAGES]
        assert "frame" in chain and len(stage) == 1, (act.name, chain)
        if any(k in act.name for k in b6):
            assert stage == ["nbody.sort"], (act.name, chain)
            sorts += 1
    assert sorts == 12 * session.frames
