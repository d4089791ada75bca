"""PyTorch port vs the JAX package: build_queue's plane, direct and auto
orders, dilate_setup_planar, and the moving-camera frames, per-frame
rebuild and amortized.

Small shapes: sphere meshes at 128x128 (make_sphere(4, 8): 64 triangles,
the direct order; (16, 32): 1,024, multi-chunk tiles; (24, 48): 2,304,
where "auto" takes the plane order). Queues and setups are compared
leaf for leaf, frames pixel for pixel: 0 differing pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.ops import raster_queue as jrq
from rustexp_tpu.ops import raster_setup as jrs
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu_torch.app import benchmark as tbench
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.ops import raster_queue as trq
from rustexp_tpu_torch.ops import raster_setup as trs
from rustexp_tpu_torch.raster import pipeline as tpp

W = H = 128
CPU = torch.device("cpu")
EYES = (camera.cam_orbit(0.7), camera.cam_pan_front(1.3),
        camera.cam_orbit_front(2.0))
SPHERES = {"tiny": (4, 8), "dense": (16, 32), "plane": (24, 48)}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, (rings, segs) in SPHERES.items():
        m = jmesh.make_sphere(rings, segs)
        out[name] = (jpp.make_scene(m, jcubemap.make_procedural_set()),
                     tpp.make_scene(m, tcubemap.make_procedural_set(), CPU))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_leaves_equal(a, b, what):
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.shape == y.shape and np.array_equal(x, y), f"{what}.{f}"


def _setups(scene_pair, eye):
    sj, st = scene_pair
    xs, ys, zs, *_ = jpp.transform_corners_planar(sj, jnp.asarray(eye), W, H)
    return (jrs.setup_triangles_planar(xs, ys, zs, W, H),
            tpp._queue_setup(st, eye, W, H))


@pytest.mark.parametrize("mesh", ["tiny", "dense", "plane"])
@pytest.mark.parametrize("shade_w", [jrq.SHADE_W, jrq.TILE_W])
@pytest.mark.parametrize("order", ["plane", "direct", "auto"])
def test_build_queue_order_matches_jax(scenes, mesh, shade_w, order):
    """Every leaf at three eyes (tests/test_raster.py:614-692's cases);
    the queue names the order it resolved, as JAX's build resolves it."""
    expect = {"plane": "plane", "direct": "direct",
              "auto": {"tiny": "direct", "dense": "direct",
                       "plane": "plane"}[mesh]}[order]
    multichunk = False
    for eye in EYES:
        setj, sett = _setups(scenes[mesh], eye)
        stats = tuple(int(x) for x in jrq.queue_stats(setj, H, W))
        cfg = jrq.suggest_queue_config(stats)
        kw = dict(s_cap=cfg[0], m_y=cfg[1], m_x=cfg[2], t_cap=cfg[3],
                  shade_w=shade_w, order=order)
        qj = jrq.build_queue(setj, H, W, **kw)
        qt = trq.build_queue(sett, H, W, **kw)
        _assert_leaves_equal(qj, qt, f"Queue[{order}]")
        assert qt.order == expect and not bool(qt.overflow)
        assert int(qt.scal[:, 3].sum()) > 0
        scal = qt.scal.numpy()
        multichunk |= bool(((scal[:, 2] == 0) & (scal[:, 3] > 0)).any())
    if mesh == "dense":
        assert multichunk, "no tile needed more than one chunk"


def _jax_order(T: int, s_cap: int, m_y: int, m_x: int, h: int, w: int,
               order: str = "auto") -> str:
    """The order JAX's build_queue runs, read off its jaxpr: plane sorts
    the T triangle keys, tri the T * m_y * m_x pair keys, direct neither
    (the rows list's argsort sorts h * w / shade_w block ids)."""
    setup = jrs.TriSetupP(*[
        jnp.zeros((T,), jnp.bool_ if f == "valid" else
                  jnp.float32 if f.startswith(("bias", "inv", "z"))
                  else jnp.int32) for f in jrs.TriSetupP._fields])
    # a shade width whose rows list sorts neither T nor T * m_y * m_x ids
    shade_w = next(sw for sw in (jrq.TILE_W, jrq.SHADE_W)
                   if h * (w // sw) not in (T, T * m_y * m_x))
    jaxpr = jax.make_jaxpr(lambda s: jrq.build_queue(
        s, h, w, s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=64, shade_w=shade_w,
        order=order))(setup)
    sizes = set()

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "sort":
                sizes.add(eqn.invars[0].aval.shape[0])
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr if hasattr(sub.jaxpr, "eqns")
                             else sub.jaxpr.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    if T * m_y * m_x in sizes:
        return "tri"
    return "plane" if T in sizes else "direct"


# (T, s_cap, m_y, m_x, frame, order): the moving suite's scenes at their
# path caps (512^2, procedural stand-ins), then each threshold's sides
@pytest.mark.parametrize("T,s_cap,m_y,m_x,size,order", [
    (2304, 176, 6, 3, 512, "auto"),     # Killeroo V/P
    (2304, 128, 4, 3, 512, "auto"),     # Head, Hand V/P
    (2304, 96, 4, 3, 512, "auto"),      # CornellBox V/P
    (8192, 128, 3, 3, 512, "auto"),     # TorusKnot V/P
    (12, 176, 33, 5, 512, "auto"),      # Cube V/P
    (64, 16, 2, 2, 512, "auto"),
    (65, 48, 2, 2, 512, "auto"),
    (2048, 128, 2, 2, 512, "auto"),     # T * s_cap * chunk == 2^25
    (2048, 144, 2, 2, 512, "auto"),
    (2000, 160, 2, 2, 512, "auto"),
    (4096, 64, 8, 8, 512, "auto"),      # R_est 1,296 > 512
    (4096, 64, 4, 6, 512, "auto"),      # R_est 210
    (200_000, 512, 3, 3, 2048, "auto"),  # the int32 key-space guard
    (200_000, 512, 3, 3, 2048, "plane"),
    (100, 16, 2, 2, 512, "plane"),
    (100, 16, 2, 2, 512, "tri"),
])
def test_resolve_order_matches_jax(T, s_cap, m_y, m_x, size, order):
    n_tiles = (size // trq.TILE_H) * (size // trq.TILE_W)
    got = trq.resolve_order(order, T, s_cap, m_y, m_x, n_tiles)
    assert got == _jax_order(T, s_cap, m_y, m_x, size, size, order)


def test_resolve_order_refuses_unknown():
    with pytest.raises(ValueError, match="order"):
        trq.resolve_order("bitonic", 100, 16, 2, 2, 32)


@pytest.mark.parametrize("d,area_margin", [(0, 0), (3, 40), (24, 4096)])
def test_dilate_setup_planar_matches_jax(scenes, d, area_margin):
    for eye in EYES[:2]:
        setj, sett = _setups(scenes["plane"], eye)
        dj = jrs.dilate_setup_planar(setj, d, W, H, area_margin)
        dt = trs.dilate_setup_planar(sett, d, W, H, area_margin)
        _assert_leaves_equal(dj, dt, "TriSetupP")
        if d:
            assert int(dt.valid.sum()) > int(sett.valid.sum())


def _path(t0: float, n: int):
    return [camera.cam_orbit(t0 + i / 60.0) for i in range(n)]


def _jax_caps(sj, eyes, per_pixel):
    """JAX's bench_scene_moving pre-pass (rustexp_tpu/app/benchmark.py:
    236-248) at W x H."""
    k = len(eyes)
    stats = [jax.device_get(jpp._queue_stats_jit(sj, jnp.asarray(e), W, H))
             for e in eyes[::max(1, k // 8)]]
    agg = tuple(max(int(s[j]) for s in stats) for j in range(5))
    shade_w = jrq.choose_shade_w(agg[3], agg[4], rebuild_per_frame=True,
                                 per_pixel=per_pixel)
    occ = agg[3] if shade_w == jrq.SHADE_W else agg[4]
    s_cap, m_y, m_x, t_cap = jrq.suggest_queue_config(agg[:3] + (occ,))
    return dict(s_cap=s_cap, m_y=m_y, m_x=m_x, t_cap=t_cap, shade_w=shade_w)


def _jax_moving_frame(sj, eye, caps, per_pixel):
    xs, ys, zs, *_ = jpp.transform_corners_planar(sj, jnp.asarray(eye), W, H)
    setup = jrs.setup_triangles_planar(xs, ys, zs, W, H)
    queue = jrq.build_queue(setup, H, W, **caps)
    return jpp.render_frame(sj, jnp.asarray(eye), 0.0, w=W, h=H,
                            per_pixel=per_pixel, shader_idx=5, bg_idx=0,
                            show_cm=False, backend="queue",
                            raster_queue=queue, return_overflow=True)


@pytest.mark.parametrize("mesh,per_pixel", [("plane", True),
                                            ("plane", False),
                                            ("tiny", True)])
def test_moving_frames_match_jax(scenes, mesh, per_pixel):
    """bench_scene_moving's frame, the queue rebuilt at every eye of a
    path with "auto" at the pre-pass's caps, against the same in JAX."""
    sj, st = scenes[mesh]
    eyes = np.stack(_path(0.9, 16)).astype(np.float32)
    caps = tbench.moving_caps(st, eyes, per_pixel, w=W, h=H)
    assert caps == _jax_caps(sj, eyes, per_pixel)
    order = tbench._order(st, caps, W, H)
    assert order == {"plane": "plane", "tiny": "direct"}[mesh]
    bg = tpp.background(0, W, H, CPU)
    for eye in eyes[::5]:
        want, ov_j = _jax_moving_frame(sj, eye, caps, per_pixel)
        got, ov_t = tbench.moving_frame(st, eye, caps, per_pixel, W, H)
        assert not bool(ov_j) and not bool(ov_t)
        assert np.array_equal(np.asarray(want), got.numpy())
        assert int((got.view(torch.int32) != bg).sum()) > W * H // 10


def test_plane_queue_frame_equals_tri_queue_frame(scenes):
    """The (z, tri) race does not depend on slot order: a plane queue and
    a tri queue of one eye render the same frame."""
    _, st = scenes["plane"]
    eye = camera.cam_orbit(1.4)
    setup = tpp._queue_setup(st, eye, W, H)
    cfg = trq.suggest_queue_config(tpp.scene_queue_stats(st, eye, W, H))
    frames, ids = {}, {}
    for order in ("plane", "tri", "direct"):
        q = trq.build_queue(setup, H, W, s_cap=cfg[0], m_y=cfg[1],
                            m_x=cfg[2], t_cap=cfg[3], order=order)
        assert q.order == order
        ids[order] = q.ids
        frames[order] = tpp.render_frame(
            st, eye, 1.4, w=W, h=H, per_pixel=True, backend="queue",
            raster_queue=q)
    assert not torch.equal(ids["plane"], ids["tri"])
    assert torch.equal(ids["direct"], ids["tri"])
    assert torch.equal(frames["plane"], frames["tri"])
    assert torch.equal(frames["direct"], frames["tri"])


def test_moving_amortized_bit_exact(scenes):
    """tests/test_raster.py::test_moving_amortized_bit_exact on the port:
    a queue built every K = 4 frames from the dilated setup (24 px, area
    margin 4,096) renders every frame of its chunk as a fresh per-frame
    build does, and stale never fires."""
    _, st = scenes["dense"]
    K, n = 4, 8
    ticks = [0.9 + i / 60.0 for i in range(n)]
    eyes = [camera.cam_orbit(t) for t in ticks]
    dil = trs.dilate_setup_planar(tpp._queue_setup(st, eyes[0], W, H), 24,
                                  W, H, 4096)
    s_cap, m_y, m_x, t_cap = trq.suggest_queue_config(
        tuple(int(x) for x in trq.queue_stats(dil, H, W)))
    kw = dict(w=W, h=H, shader_idx=5, show_cm=False, per_pixel=True,
              return_overflow=True, backend="queue")
    for c0 in range(0, n, K):
        dil = trs.dilate_setup_planar(tpp._queue_setup(st, eyes[c0], W, H),
                                      24, W, H, 4096)
        q = trq.build_queue(dil, H, W, s_cap=s_cap, m_y=m_y, m_x=m_x,
                            t_cap=t_cap)
        for i in range(c0, c0 + K):
            fb_am, stale = tpp.render_frame(st, eyes[i], ticks[i],
                                            raster_queue=q, **kw)
            assert not bool(stale), f"stale fired at frame {i}"
            fresh = tpp.build_scene_queue(st, eyes[i], W, H)
            fb_fresh, st2 = tpp.render_frame(st, eyes[i], ticks[i],
                                             raster_queue=fresh, **kw)
            assert not bool(st2)
            assert torch.equal(fb_am, fb_fresh), f"frame {i}"


def test_amortized_bench_frames_equal_per_frame_rebuild(scenes):
    """bench_scene_moving_amortized's own mechanism on the CPU: margins
    measured on the path, caps from the dilated stats, a queue every 4
    frames; each frame equals moving_frame's, and stale never fires."""
    _, st = scenes["plane"]
    eyes = np.stack(_path(0.5, 16)).astype(np.float32)
    dilate, area_margin = tbench.amortized_margins(st, eyes, 4, w=W, h=H)
    assert dilate >= 1 and area_margin >= 16
    caps = tbench.amortized_caps(st, eyes, dilate, area_margin, W, H)
    per_frame = tbench.moving_caps(st, eyes, True, w=W, h=H)
    got = list(tbench.amortized_frames(st, eyes, caps, dilate, area_margin,
                                       True, 4, W, H))
    assert len(got) == len(eyes)
    for i, (fb, stale) in enumerate(got):
        assert not bool(stale), f"stale fired at frame {i}"
        want, ov = tbench.moving_frame(st, eyes[i], per_frame, True, W, H)
        assert not bool(ov)
        assert torch.equal(fb, want), f"frame {i}"


def test_moving_benches_refuse_cpu():
    with pytest.raises(ValueError, match="times the card"):
        tbench.bench_scene_moving(0, True, runs=1, k=2, device=CPU)
    with pytest.raises(ValueError, match="times the card"):
        tbench.bench_scene_moving_amortized(0, True, runs=1, k=4,
                                            device=CPU)


def test_scene_frame_reports_the_resolved_order():
    """The fixed-eye suite's queue scenes build what JAX's "auto" builds:
    Killeroo's 2,304 triangles take the plane order."""
    _, structure, m, _ = tbench.scene_frame(0, True, CPU)
    assert m.num_tris == 2304
    assert structure["backend"] == "queue"
    assert structure["queue_order"] == "plane"
