"""PyTorch port vs the JAX package: the G-buffer paths.

The XLA oracle (raster_gbuffer_xla), the plain version of kernel B3
against the Pallas _tile_kernel in interpret mode (also on the stress
bins of chip_smoke.stress_bins), raster_gbuffer_pallas,
shade_gbuffer, render_frame through the oracle and the routes to it on
frames of partial tiles, the Experiment at untileable windows, triangle setup
with the band translation y_shift, the banded background, and the band
renderer (render_band, render_frame_sharded) against JAX's sharded render
on a 4-device mesh, in this process over gloo and across two spawned
gloo ranks.

Small shapes: make_sphere(12, 24) (576 triangles), the 12-triangle cube,
make_sphere(8, 16) and 96-triangle random soups with adversarial cases
(tests/test_raster_fuzz.py), at 128x128 and the untileable 96x80. The
G-buffers, setups and B3's outputs are compared bit for bit; frames
within the repo's bounds, 0.3% of pixels (tests/test_golden.py) and, for
bands against JAX's sharded render, JAX's own 0.5% (tests/test_parallel.py:
86-96). Measured on this suite: 0 pixels everywhere (ROADMAP C).
"""

import functools
import multiprocessing as mp

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

from chip_smoke import BINS_CAP, stress_bins
from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.ops import raster_pallas as jrp
from rustexp_tpu.ops import raster_setup as jrs
from rustexp_tpu.ops.raster_xla import raster_gbuffer_xla as jgb_xla
from rustexp_tpu.parallel import raster_shard as jshard
from rustexp_tpu.raster import camera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu.sims.rasterizer import RasterizerExperiment as JaxExperiment
from rustexp_tpu_torch import interop
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.assets import mesh as tmesh
from rustexp_tpu_torch.ops import raster_bins as trb
from rustexp_tpu_torch.ops import raster_setup as trs
from rustexp_tpu_torch.ops.raster_xla import raster_gbuffer_xla
from rustexp_tpu_torch.parallel import raster_shard as tshard
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.raster import structure as tstruct
from rustexp_tpu_torch.sims.rasterizer import RasterizerExperiment

from test_raster_fuzz import random_soup

W = H = 128
CPU = torch.device("cpu")
GOLDEN_FRAC = 0.003
BAND_FRAC = 0.005  # tests/test_parallel.py:96, JAX's own band bound
EYE = camera.cam_orbit(0.7)
MESHES = {"sphere": lambda: jmesh.make_sphere(12, 24), "cube": jmesh.make_cube,
          "sphere8": lambda: jmesh.make_sphere(8, 16)}


@functools.cache
def _scenes(name):
    m = MESHES[name]()
    return (jpp.make_scene(m, jcubemap.make_procedural_set()),
            tpp.make_scene(m, tcubemap.make_procedural_set(), CPU))


_jit_vertices = jax.jit(jpp.transform_vertices, static_argnums=(2, 3))
_jit_setup = jax.jit(jrs.setup_triangles, static_argnums=(2, 3, 4))
_jit_gb_xla = jax.jit(jgb_xla, static_argnums=(1, 2))


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype.kind == "f" else a


def _assert_gbuffer_equal(gj, gt, what):
    for f in ("z", "tid", "b"):
        a, b = _bits(getattr(gj, f)), _bits(getattr(gt, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}.{f}"
        assert np.array_equal(a, b), f"{what}.{f}: {np.argwhere(a != b)[:4]}"


def _diff(a, b) -> int:
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint32
    return int((a != b).sum())


def _setups(case, w, h, y_shift=0):
    """(JAX setup, port setup) of a scene at EYE, or of a fuzz soup."""
    if case.startswith("soup"):
        vp, tris = random_soup(int(case[4:]))
        vt = torch.from_numpy(np.array(vp))
        tt = torch.from_numpy(np.array(tris))
    else:
        sj, st = _scenes(case)
        vp, tris = _jit_vertices(sj, jnp.asarray(EYE), w, h)[0], sj.tris
        vt, tt = tpp.transform_vertices(st, EYE, w, h)[0], st.tris
    return (_jit_setup(vp, tris, w, h, y_shift),
            trs.setup_triangles(vt, tt, w, h, y_shift=y_shift))


@pytest.mark.parametrize("case,w,h", [
    ("sphere", W, H), ("sphere", 96, 80), ("cube", W, H),
    ("soup0", W, H), ("soup1", W, H), ("soup2", 96, 80), ("soup3", W, H)])
def test_raster_gbuffer_xla_matches_jax(case, w, h):
    """z, tid and b bit for bit: real scenes, a frame of partial tiles and
    random soups with exact z ties, slivers, giant and offscreen
    triangles."""
    setj, sett = _setups(case, w, h)
    gt = raster_gbuffer_xla(sett, h, w)
    _assert_gbuffer_equal(_jit_gb_xla(setj, h, w), gt, case)
    assert (gt.tid >= 0).any()


@pytest.mark.parametrize("y_shift", [0, 32, 77])
def test_setup_y_shift_matches_jax(y_shift):
    """The band translation after the snap, stacked and planar forms."""
    setj, sett = _setups("sphere", W, 32, y_shift)
    for f in setj._fields:
        assert np.array_equal(_bits(getattr(setj, f)),
                              _bits(getattr(sett, f))), f
    sj, st = _scenes("sphere")
    xj = jax.jit(jpp.transform_corners_planar, static_argnums=(2, 3))(
        sj, jnp.asarray(EYE), W, H)
    pj = jax.jit(jrs.setup_triangles_planar, static_argnums=(3, 4, 5))(
        *xj[:3], W, 32, y_shift)
    pt = trs.setup_triangles_planar(*tpp.transform_corners_planar(
        st, EYE, W, H)[:3], W, 32, y_shift=y_shift)
    for f in pj._fields:
        assert np.array_equal(_bits(getattr(pj, f)), _bits(getattr(pt, f))), f


def _jax_tile_kernel(bins, h, w, cap, chunk):
    """JAX's _tile_kernel through pl.pallas_call in interpret mode, as
    raster_gbuffer_pallas launches it (raster_pallas.py:253-284) ->
    (z, slot, b0, b1, b2), the kernel's raw outputs."""
    ntx = w // jrp.TILE_W
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(h // jrp.TILE_H, ntx, cap // chunk),
        in_specs=[pl.BlockSpec((1, chunk, n),
                               lambda i, j, k, *_: (i * ntx + j, k, 0),
                               memory_space=pltpu.VMEM)
                  for n in (jrp._I_CH, jrp._F_CH)],
        out_specs=[pl.BlockSpec((jrp.TILE_H, jrp.TILE_W),
                                lambda i, j, k, *_: (i, j),
                                memory_space=pltpu.VMEM)] * 5)
    kernel = functools.partial(jrp._tile_kernel, tile_h=jrp.TILE_H,
                               tile_w=jrp.TILE_W, ntx=ntx, chunk_size=chunk,
                               strict=True)
    shapes = [jax.ShapeDtypeStruct((h, w), t) for t in
              (jnp.float32, jnp.int32, jnp.float32, jnp.float32, jnp.float32)]
    return pl.pallas_call(kernel, grid_spec=spec, out_shape=shapes,
                          interpret=True)(bins.counts, bins.setup_i,
                                          bins.setup_f)


@pytest.mark.parametrize("case,cap,chunk", [
    ("sphere", None, 512), ("sphere", 128, 64), ("soup1", None, 512)])
def test_b3_plain_matches_jax_kernel(case, cap, chunk):
    """The plain B3 on JAX's bins (carried over by interop) against the
    Pallas _tile_kernel in interpret mode: slot, z, b0, b1 and b2 over
    the whole frame, bit for bit, across one and several bin chunks."""
    setj, sett = _setups(case, W, H)
    cap = trb._bins_cap(sett.A.shape[0], cap, chunk)
    bj = jrp.bin_triangles(setj, H, W, cap)
    assert not bool(bj.overflow)
    want = _jax_tile_kernel(bj, H, W, cap, min(chunk, cap))
    bt = interop.bins_from_numpy({f: np.asarray(getattr(bj, f))
                                  for f in bj._fields}, CPU)
    z, slot, b = trb.raster_gbuffer_bins_plain(bt.counts, bt.setup_i,
                                               bt.setup_f, H, W)
    for name, a, g in zip(("z", "slot", "b0", "b1", "b2"), want,
                          (z, slot, *b)):
        assert np.array_equal(_bits(a), _bits(g)), name
    assert (slot >= 0).sum() > 100


def test_b3_plain_matches_jax_kernel_on_stress_bins():
    """The plain B3 on the stress bins (chip_smoke.stress_bins: 1,163 live
    slots in one tile, copies tying at z == 1.0 and at +0.0/-0.0, one
    triangle in two slots, an empty tile, live records past the counts)
    against the Pallas _tile_kernel in interpret mode on the same arrays:
    slot, z, b0, b1 and b2 bit for bit, over five 256-slot chunks."""
    bins, h, w = stress_bins(CPU)
    bj = jrp.BinnedTris(**{f: jnp.asarray(getattr(bins, f).numpy())
                           for f in jrp.BinnedTris._fields})
    want = _jax_tile_kernel(bj, h, w, BINS_CAP, 256)
    z, slot, b = trb.raster_gbuffer_bins_plain(bins.counts, bins.setup_i,
                                               bins.setup_f, h, w)
    for name, a, g in zip(("z", "slot", "b0", "b1", "b2"), want,
                          (z, slot, *b)):
        assert np.array_equal(_bits(a), _bits(g)), name
    zb = _bits(z)
    assert (zb == 0).any() and (zb == np.int32(-2 ** 31)).any()
    assert (slot == 211).any() and not (slot == 1002).any()
    assert (slot[:, 128:256] == -1).all() and (slot >= 1024).any()
    assert not (slot[:, :128] >= 1163).any()
    assert not (slot[:, 256:] >= 37).any()


@pytest.mark.parametrize("case", ["sphere", "soup0", "soup2", "soup3"])
def test_raster_gbuffer_pallas_matches_xla_and_jax(case):
    """The port's raster_gbuffer_pallas (plain B3 on the CPU) equals its
    own oracle and JAX's raster_gbuffer_pallas, bit for bit
    (tests/test_raster.py:96, tests/test_raster_fuzz.py:87)."""
    setj, sett = _setups(case, W, H)
    gt, overflow = trb.raster_gbuffer_pallas(sett, H, W)
    assert not bool(overflow)
    _assert_gbuffer_equal(raster_gbuffer_xla(sett, H, W), gt, "xla")
    gj, oj = jrp.raster_gbuffer_pallas(setj, H, W)
    assert not bool(oj)
    _assert_gbuffer_equal(gj, gt, "jax")


def test_raster_gbuffer_pallas_overflow():
    """A bin capacity below the largest bin drops triangles and says so,
    as JAX's does; frames of partial tiles are refused."""
    setj, sett = _setups("sphere", W, H)
    _, overflow = trb.raster_gbuffer_pallas(sett, H, W, cap=8)
    _, oj = jrp.raster_gbuffer_pallas(setj, H, W, cap=8)
    assert bool(overflow) and bool(oj)
    with pytest.raises(ValueError, match="not divisible"):
        trb.raster_gbuffer_pallas(sett, 80, 96)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_shade_gbuffer_matches_jax(per_pixel):
    """shade_gbuffer on the same G-buffer and vertex arrays, bit for bit."""
    sj, st = _scenes("sphere")
    ej = jnp.asarray(EYE)
    vj, wj, nj = _jit_vertices(sj, ej, W, H)
    vt, wt, nt = tpp.transform_vertices(st, EYE, W, H)
    cj, ct = sj.colors, st.colors
    if not per_pixel:
        cj = jpp.sh.shader_fn(5)(wj, nj, sj.colors, ej, jnp.float32(0.7),
                                 sj.cm)
        ct = tpp.vertex_colors(st, EYE, 0.7, W, H, 5)
    setj, sett = _setups("sphere", W, H)
    kw = dict(per_pixel=per_pixel, shader_idx=5)
    want = jax.jit(functools.partial(jpp.shade_gbuffer, **kw))(
        _jit_gb_xla(setj, H, W), sj, vj, wj, nj, cj, ej, jnp.float32(0.7),
        bg_fb=jpp.background(0, W, H))
    got = tpp.shade_gbuffer(raster_gbuffer_xla(sett, H, W), st, vt, wt, nt,
                            ct, EYE, 0.7, bg_fb=tpp.background(0, W, H, CPU),
                            **kw)
    assert np.array_equal(np.asarray(want), got.numpy().view(np.uint32))


@pytest.mark.parametrize("bg_idx", range(jpp.NUM_BACKGROUNDS))
def test_banded_background_matches_jax(bg_idx):
    """A band of a taller frame's gradient, at its global rows."""
    want = jpp.background(bg_idx, 64, 32, y0=96, full_h=128)
    got = tpp.background(bg_idx, 64, 32, CPU, y0=96, full_h=128)
    assert np.array_equal(np.asarray(want), got.numpy().view(np.uint32))


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("w,h,backend", [(W, H, "xla"), (96, 80, "auto"),
                                         (96, 80, "queue")])
def test_render_frame_xla_matches_jax(per_pixel, w, h, backend):
    """backend="xla", and "auto"/"queue" on a frame of partial tiles,
    route to the oracle; at 128x128 its frame equals the bins', as JAX
    pins (tests/test_raster.py:215)."""
    sj, st = _scenes("sphere")
    kw = dict(w=w, h=h, per_pixel=per_pixel, shader_idx=5,
              return_overflow=True)
    want, oj = jpp.render_frame(sj, jnp.asarray(EYE), 0.7, backend=backend,
                                **kw)
    kind = tstruct.route(st.tris.shape[0], w, h, backend)
    assert kind == tstruct.ORACLE
    got, ot = tpp.render_frame(st, EYE, 0.7,
                               structure=tstruct.Structure(kind), **kw)
    assert _diff(want, got) <= GOLDEN_FRAC * w * h
    assert bool(ot) == bool(oj) is False
    assert (np.asarray(want) != np.asarray(jpp.background(0, w, h))).sum() \
        > w * h // 10
    if w % trb.TILE_W == 0 and h % trb.TILE_H == 0:
        assert torch.equal(got, tpp.render_frame(
            st, EYE, 0.7, structure=tstruct.Structure(tstruct.BINS),
            **kw)[0])


@pytest.mark.parametrize("mesh_idx,w,h", [(9, 96, 80), (0, 160, 100),
                                          (9, 120, 128)])
def test_experiment_untileable_window_matches_jax(mesh_idx, w, h):
    """Windows that are not whole 128-px columns and 8-row strips render
    through the oracle in both Experiments, P and V. (JAX's Experiment
    still builds a queue for them, which fails below one 16x128 tile, so
    the queue mesh is compared at 160x100.)"""
    je, te = JaxExperiment(), RasterizerExperiment(CPU)
    for per_pixel in (False, True):
        js = je.init(mesh_idx=mesh_idx, per_pixel=per_pixel)
        ts = te.init(mesh_idx=mesh_idx, per_pixel=per_pixel)
        for tick in (0.0, 0.05):
            want = je.render(js, w, h, tick)
            got = te.render(ts, w, h, tick)
            assert _diff(want, got) <= GOLDEN_FRAC * w * h
        assert ts._scene_cache[2] == ("xla", None)


def test_experiment_renders_a_500_window():
    """A 500x500 window of the 2,304-triangle Killeroo stand-in renders
    (it raised before the oracle was ported) and draws the mesh."""
    te = RasterizerExperiment(CPU)
    fb = te.render(te.init(per_pixel=True), 500, 500, 0.0)
    bg = tpp.background(0, 500, 500, CPU).view(torch.uint32)
    assert fb.shape == (500, 500) and (fb != bg).sum() > 500 * 500 // 20


@pytest.mark.parametrize("name,per_pixel,shader_idx",
                         [("cube", True, 5), ("sphere8", False, 5)])
def test_render_band_matches_jax_sharded(name, per_pixel, shader_idx):
    """4 bands of 128x128, each through the oracle and through the plain
    B3, stitched: JAX's render_frame_sharded on a 4-device mesh (within
    its own 0.5%; measured 0 px), the port's full-frame oracle frame (bit
    for bit) and each other."""
    sj, st = _scenes(name)
    eye = camera.cam_orbit(0.5)
    kw = dict(w=W, h=H, per_pixel=per_pixel, shader_idx=shader_idx)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("rows",))
    want = jshard.render_frame_sharded(sj, jnp.asarray(eye), 0.5, mesh, **kw)
    full = tpp.render_frame(st, eye, 0.5, show_cm=False,
                            structure=tstruct.Structure(tstruct.ORACLE), **kw)
    for backend in ("xla", "pallas"):
        bands = [tshard.render_band(st, eye, 0.5, band=b, n_bands=4,
                                    backend=backend, **kw) for b in range(4)]
        assert not any(bool(o) for _, o in bands)
        got = torch.cat([fb for fb, _ in bands]).view(torch.uint32)
        assert _diff(want, got) <= BAND_FRAC * W * H
        assert torch.equal(got, full), backend


def test_render_frame_sharded_gloo_one_rank():
    """render_frame_sharded over a one-rank gloo group (an in-process
    HashStore) equals the group=None render, which equals the oracle's
    full frame; return_overflow gives the MAX-reduced flag."""
    _, st = _scenes("sphere")
    kw = dict(w=W, h=H, per_pixel=True, backend="pallas")
    alone = tshard.render_frame_sharded(st, EYE, 0.7, None, **kw)
    assert torch.equal(alone, tpp.render_frame(
        st, EYE, 0.7, w=W, h=H, per_pixel=True,
        structure=tstruct.Structure(tstruct.ORACLE),
        show_cm=False))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        fb, overflow = tshard.render_frame_sharded(
            st, EYE, 0.7, dist.group.WORLD, return_overflow=True, **kw)
    finally:
        dist.destroy_process_group()
    assert torch.equal(fb, alone) and not bool(overflow)


def _gloo_rank(rank, world, store_path, out_path):
    """One rank of the spawned gloo test: render its band, gather the
    frame, save it."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        scene = tpp.make_scene(tmesh.make_sphere(8, 16),
                               tcubemap.make_procedural_set(), CPU)
        fb, overflow = tshard.render_frame_sharded(
            scene, EYE, 0.7, dist.group.WORLD, w=W, h=H, per_pixel=False,
            backend="xla" if rank else "pallas", return_overflow=True)
        np.save(f"{out_path}{rank}.npy", fb.view(torch.int32).numpy())
        assert not bool(overflow)
    finally:
        dist.destroy_process_group()


def test_render_frame_sharded_gloo_two_ranks(tmp_path):
    """Two spawned ranks on a FileStore (rank 0's band through the plain
    B3, rank 1's through the oracle): each gets the whole frame, equal to
    the one-rank render. The ranks must finish within the timeout; they
    are killed, and the test fails, otherwise."""
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "frame")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, 2, str(tmp_path / "store"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, "a gloo rank did not finish within 180 s"
    assert [p.exitcode for p in procs] == [0, 0]
    _, st = _scenes("sphere8")
    want = tshard.render_frame_sharded(st, EYE, 0.7, None, w=W, h=H,
                                       per_pixel=False).view(torch.int32)
    for r in range(2):
        assert np.array_equal(np.load(f"{out}{r}.npy"), want.numpy())
