"""The benchmark's frozen arithmetic: percentiles, spreads, busy unions,
idle gaps, the roofline counts, the name rules and the module check."""

import statistics
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness, profiling, roofline, spec, stats
from perfbench.reference import assets, raster


def test_percentile_is_numpys_linear_rule():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 100, 1001):
        v = rng.exponential(9.0, n).tolist()
        for q in (0, 5, 50, 95, 99, 100):
            assert stats.percentile(v, q) == pytest.approx(
                float(np.percentile(v, q)), rel=1e-12)


def test_p95_counts_every_interval():
    iv = [10.0] * 95 + [100.0] * 5
    assert stats.percentile(iv, 95) == pytest.approx(10.0 + 0.05 * 90.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [9.0, 10.0, 10.5, 11.0, 12.0, 30.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union_length(iv) == pytest.approx(5.0)
    assert stats.gaps(iv) == [(3, 5, 2), (6, 8, 4)]
    assert stats.union_length([]) == 0.0


def _ev(name, start, end, id_=0, parent=None):
    return SimpleNamespace(name=name, id=id_, cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end))


def test_session_busy_kernels_and_gaps():
    op = _ev("aten::mul", 0, 1)
    host = [_ev("cudaLaunchKernel", 0, 1, 7, op),
            _ev("cudaLaunchKernel", 0, 1, 8, None)]
    dev = [_ev("k_a", 0, 10, 5), _ev("queue_raster_kernel<4, 3>", 30, 40, 7),
           _ev("k_a", 35, 50, 6), _ev("k_b", 80, 81, 8)]
    s = profiling.Session(dev, host, frames=2, wall_s=1.0)
    assert s.busy_s() == pytest.approx(31e-6)
    assert s.kernel_s(("queue_raster_kernel",)) == (pytest.approx(10e-6), 1)
    assert s.top_ops()[0] == ["k_a", pytest.approx(25e-6)]
    gaps = dict((n, v) for n, v in s.idle_gaps())
    assert gaps == {"aten::mul": pytest.approx(20e-6),
                    "cudaLaunchKernel": pytest.approx(30e-6)}


def test_roofline_counts_from_the_references_setup():
    r = raster.rasterize(assets.cube(), assets.eye("orbit", 0.0), 512, 512,
                         "cpu")
    assert r["n_tris"] == 2  # the face the eye on +x sees
    assert r["won"] <= r["tests"]
    t, by = roofline.raster_bound_s(r["n_tris"], r["tests"], r["won"], 512,
                                    512)
    want = (2 * 120 + 8 * 512 * 512 * 4) / roofline.HBM_BYTES_PER_S
    assert by == "bytes" and t == pytest.approx(want)
    t, by = roofline.raster_bound_s(10, 10**9, 10**6, 8, 8)
    assert by == "operations" and t == pytest.approx(
        10**9 * 11 / roofline.INT_OPS_PER_S, rel=1e-3)


def test_name_and_unit_rules():
    assert spec.name_ok("rast512.sphere_p.bench")
    assert spec.name_ok("_x-1.y")
    for bad in ("", "a b", "a,b", "a/b", ".x", "x" * 65, "µs", "-x"):
        assert not spec.name_ok(bad), bad
    assert spec.unit_ok("ms/frame") and spec.unit_ok("%")
    for bad in ("ms per frame", "", "x" * 17, "µs"):
        assert not spec.unit_ok(bad), bad
    bench = spec.load_benchmark()
    assert spec.bad_names(bench) == []
    bench["workloads"][0]["name"] = "bad name"
    assert spec.bad_names(bench) == ["workload name: bad name"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("rustexp_tpu_torch", "jaxtyping_like", "jaxlibrary"):
        monkeypatch.setitem(sys.modules, name, SimpleNamespace())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rustexp_tpu.core", SimpleNamespace())
    assert harness.forbidden_modules() == ["rustexp_tpu"]


def test_benchmark_json_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "frame_ms", "frame_p95_ms"} == e2e
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.entry().Entry
        assert callable(cell.check().check)
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]))
            assert m["moves"] == "frame_ms"
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
