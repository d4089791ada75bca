"""The six readers of the program's span totals: each one's value on a
synthetic set of totals, None where its spans never ran, and None on a
program without spans (a parent that predates them)."""

import sys
import types

import pytest

from perfbench import spec

TOTALS = {  # name -> (calls, ns) over 200 frames, 150 of them re-rendered
    "frame": (200, 2_000_000_000),
    "raster.setup": (350, 70_000_000),
    "raster.shade": (350, 140_000_000),
    "experiment.rebuild": (150, 900_000_000),
    "experiment.sync": (200, 30_000_000),
    "structure.queue": (150, 850_000_000),
    "sync.read.stale": (200, 4_000_000),
    "sync.read.queue_stats": (150, 6_000_000),
    "sync.upload.background": (350, 10_000_000),
    "raster.frame": (350, 1_500_000_000),
}

WANT = {
    "setup_host_ms_per_frame": 70.0 / 200,
    "shade_host_ms_per_frame": 140.0 / 200,
    "rebuild_host_ms_per_frame": 900.0 / 200,
    "experiment_rerender_pct": 75.0,
    "program_syncs_per_frame": (200 + 150 + 350) / 200,
    "host_wait_ms_per_frame": (4.0 + 6.0 + 10.0 + 30.0) / 200,
}

# the spans a reader cannot do without: without any, it reads None
NEEDS = {
    "setup_host_ms_per_frame": ("frame", "raster.setup"),
    "shade_host_ms_per_frame": ("frame", "raster.shade"),
    "rebuild_host_ms_per_frame": ("frame", "sync.read.stale"),
    "experiment_rerender_pct": ("frame", "sync.read.stale"),
    "program_syncs_per_frame": ("frame",),
    "host_wait_ms_per_frame": ("frame",),
}


def reader(name):
    cell = spec.Cell(spec.load_benchmark(), "rast512.sphere_p.orbit")
    return cell.metric_reader(name)


def with_totals(monkeypatch, totals):
    from rustexp_tpu_torch.core import trace

    monkeypatch.setattr(trace, "span_totals", lambda: dict(totals))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(monkeypatch, name):
    with_totals(monkeypatch, TOTALS)
    assert reader(name)(None) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_its_spans(monkeypatch, name):
    for gone in NEEDS[name]:
        with_totals(monkeypatch, {k: v for k, v in TOTALS.items()
                                  if k != gone})
        assert reader(name)(None) is None, gone
    with_totals(monkeypatch, {})
    assert reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_on_a_program_without_spans(monkeypatch, name):
    old = types.ModuleType("rustexp_tpu_torch.core.trace")
    monkeypatch.setitem(sys.modules, "rustexp_tpu_torch.core.trace", old)
    assert reader(name)(None) is None


def test_no_rebuild_reads_zero(monkeypatch):
    """An Experiment whose structure never went stale (the CubeP orbit)
    reports 0, not None."""
    with_totals(monkeypatch, {k: v for k, v in TOTALS.items()
                              if k != "experiment.rebuild"})
    assert reader("experiment_rerender_pct")(None) == 0.0
    assert reader("rebuild_host_ms_per_frame")(None) == 0.0


def test_every_cell_lists_the_span_metrics_it_reads():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        names = {m["name"] for m in spec.Cell(bench, w["name"]).per_layer}
        orbit = w["name"].endswith(".orbit")
        assert {"setup_host_ms_per_frame", "shade_host_ms_per_frame",
                "program_syncs_per_frame", "host_wait_ms_per_frame"} <= names
        assert ("experiment_rerender_pct" in names) == orbit
        assert ("rebuild_host_ms_per_frame" in names) == orbit
