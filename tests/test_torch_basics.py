"""PyTorch port (rustexp_tpu_torch) vs the JAX package: packing, LUTs,
cubemaps, meshes, camera paths, backgrounds and shader 5, plus the port's
import hygiene and the paths it does not port yet.

Inputs are made with numpy from a seed and fed to both packages; every
comparison here is exact (the port rounds each op once, as the JAX
package's sealed CPU chains do — ops/ieee.py in both packages).
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import cubemap as jcubemap
from rustexp_tpu.assets import hdr as jhdr
from rustexp_tpu.assets import mesh as jmesh
from rustexp_tpu.core import colors as jcolors
from rustexp_tpu.raster import camera as jcamera
from rustexp_tpu.raster import pipeline as jpp
from rustexp_tpu.raster import shaders as jsh
from rustexp_tpu_torch.assets import cubemap as tcubemap
from rustexp_tpu_torch.assets import hdr as thdr
from rustexp_tpu_torch.assets import mesh as tmesh
from rustexp_tpu_torch.core import colors as tcolors
from rustexp_tpu_torch.raster import camera as tcamera
from rustexp_tpu_torch.raster import pipeline as tpp
from rustexp_tpu_torch.raster import shaders as tsh
from rustexp_tpu_torch.raster import structure as tstruct

CPU = torch.device("cpu")


def _rgb(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.2, 1.2, size=(3, n)).astype(np.float32)
    # every 11-bit gamma index, the clamp edges and a NaN
    v[:, :2048] = (np.arange(2048, dtype=np.float32) + 0.5) / 2047.0
    v[:, 2048:2052] = np.array([0.0, 1.0, -0.0, np.nan], np.float32)
    return v


def test_lut_builders_match_jax():
    assert np.array_equal(tcolors.GAMMA_11BIT_LUT, jcolors.GAMMA_11BIT_LUT)
    assert np.array_equal(tcolors.POW16_TABLE, jcolors.POW16_TABLE)
    rgb = _rgb(1).T[:2048]
    assert np.array_equal(tcolors.pack_abgr32_gamma_np(rgb),
                          jcolors.pack_abgr32_gamma_np(rgb))


@pytest.mark.parametrize("name", ["pack_abgr32", "pack_abgr32_gamma_arith"])
def test_packers_match_jax(name):
    r, g, b = _rgb(2)
    want = np.asarray(jax.jit(getattr(jcolors, name))(r, g, b))
    got = getattr(tcolors, name)(*map(torch.from_numpy, (r, g, b)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_pow16_arith_matches_jax():
    v = np.concatenate([_rgb(3)[0], (np.arange(256, dtype=np.float32)
                                     + 600.5) / 855.0])
    want = np.asarray(jax.jit(jcolors.fast_unit_pow16_arith)(v))
    got = tcolors.fast_unit_pow16_arith(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_trunc_i32_saturates_like_xla():
    x = np.array([1e10, -1e10, np.nan, 2.9e9, -2.9e9, 2147483520.0,
                  -2147483648.0, 3.7, -3.7], np.float32)
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.int32))(x))
    assert np.array_equal(tcolors.trunc_i32(torch.from_numpy(x)).numpy(), want)


def test_procedural_cubemap_matches_jax():
    a, b = jcubemap.make_procedural_set(), tcubemap.make_procedural_set()
    assert np.array_equal(a.data, b.data)
    assert np.array_equal(a.cross, b.cross)
    assert b.cross.dtype == np.uint32


@pytest.mark.parametrize("bg_idx", range(jpp.NUM_BACKGROUNDS))
def test_background_matches_jax(bg_idx):
    want = np.asarray(jax.jit(jpp.background, static_argnums=(0, 1, 2))(
        bg_idx, 128, 96))
    got = tpp.background(bg_idx, 128, 96, CPU)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def _shader_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    eye = np.array([0.3, 0.25, 1.7], np.float32)
    return p, nrm, col, eye


def test_cm_texel_from_dir_matches_jax():
    _, d, _, _ = _shader_inputs(4)
    d[:8] = [[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [0, 0, 0],
             [-1, 0, 0], [0, -2, 0], [0, 0, -3]]  # ties and the zero vector
    want = jax.jit(jsh.cm_texel_from_dir)(d)
    got = tsh.cm_texel_from_dir(torch.from_numpy(d))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_shader_cm_refl_matches_jax():
    p, nrm, col, eye = _shader_inputs(5)
    cm = jcubemap.make_procedural_set().data
    want = np.asarray(jax.jit(jsh.shader_cm_refl)(p, nrm, col, eye, 0.0, cm))
    got = tsh.shader_cm_refl(*map(torch.from_numpy, (p, nrm, col, eye)), 0.0,
                             torch.from_numpy(cm)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_shader_table_names_match_jax():
    assert tsh.NUM_SHADERS == jsh.NUM_SHADERS
    for i in range(jsh.NUM_SHADERS):
        assert tsh.shader_name(i) == jsh.shader_name(i)
        assert tsh.shader_uses_cm(i) == jsh.shader_uses_cm(i)
    assert tsh.shader_fn(5) is tsh.shader_cm_refl


def test_port_imports_no_jax():
    """The port runs where jax is not installed and keeps its own copies
    of what it needs: importing every module of it (in a fresh
    interpreter), the GoL, N-body, G-buffer, band-rendering, app-shell
    and sharded (parallel/, app/multidev) modules and the two top-level
    surfaces (bench, graft_entry) among them, must leave jax and every
    rustexp_tpu module out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, rustexp_tpu_torch\n"
        "for m in pkgutil.walk_packages(rustexp_tpu_torch.__path__,\n"
        "                               'rustexp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import rustexp_tpu_torch.sims.rasterizer\n"
        "import rustexp_tpu_torch.sims.gol\n"
        "import rustexp_tpu_torch.sims.nbody, rustexp_tpu_torch.interop\n"
        "import rustexp_tpu_torch.app.benchmark\n"
        "from rustexp_tpu_torch.ops import gol_bits, gol_stencil, nbody_bh\n"
        "from rustexp_tpu_torch.ops import nbody_pallas, sort_bitonic\n"
        "from rustexp_tpu_torch.ops import raster_xla\n"
        "from rustexp_tpu_torch.parallel import raster_shard, collectives\n"
        "from rustexp_tpu_torch.parallel import gol_shard, sort_shard\n"
        "from rustexp_tpu_torch.parallel import nbody_shard\n"
        "from rustexp_tpu_torch.app import multidev\n"
        "from rustexp_tpu_torch.app import animate, cli, viewer\n"
        "from rustexp_tpu_torch.core import checkpoint, font, framebuffer\n"
        "from rustexp_tpu_torch.core import gif, platform, prewarm, trace\n"
        "from rustexp_tpu_torch.sims import base, sine\n"
        "import rustexp_tpu_torch.bench, rustexp_tpu_torch.graft_entry\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rustexp_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _route_leaks(tree) -> list:
    """The route's pieces in a module's syntax tree: the names
    QUEUE_MIN_TRIS and _queue_setup, and a tileability test (a `%` by a
    tile width: TILE_W or 128)."""
    out = []
    for node in ast.walk(tree):
        name = getattr(node, "id", None) or getattr(node, "attr", None)
        if name in ("QUEUE_MIN_TRIS", "_queue_setup"):
            out.append(f"{name} at line {node.lineno}")
        mod = isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod)
        if mod and any(getattr(n, "id", None) == "TILE_W"
                       or getattr(n, "attr", None) == "TILE_W"
                       or getattr(n, "value", None) == 128
                       for n in ast.walk(node.right)):
            out.append(f"a tileability test at line {node.lineno}")
    return out


def test_route_has_one_owner():
    """raster/structure.py owns the raster route: importing it (in a
    fresh interpreter) loads nothing of app/ or sims/, and no module
    outside raster/, ops/ and parallel/ (chip_smoke.py included) names
    QUEUE_MIN_TRIS or _queue_setup or tests a frame's tileability. The
    band renderer's own band checks (row counts by TILE_H) stay."""
    code = ("import sys, rustexp_tpu_torch.raster.structure\n"
            "print(sorted(m for m in sys.modules if m.startswith(\n"
            "    ('rustexp_tpu_torch.app', 'rustexp_tpu_torch.sims'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    root = pathlib.Path(tstruct.__file__).parents[2]
    files = [p for p in (root / "rustexp_tpu_torch").rglob("*.py")
             if p.parent.name not in ("raster", "ops", "parallel")]
    leaks = {str(p.relative_to(root)): _route_leaks(ast.parse(p.read_text()))
             for p in files + [root / "chip_smoke.py"]}
    assert len(files) > 20
    assert not {k: v for k, v in leaks.items() if v}
    assert _route_leaks(ast.parse("ok = w % 128 == 0 and h % rq.TILE_W"))


def test_device_means_the_card(monkeypatch):
    """runtime.device() with no argument is the card and raises without
    one; the CPU is used only when asked for, and so are the new
    Experiments' defaults."""
    from rustexp_tpu_torch import runtime
    from rustexp_tpu_torch.sims.gol import GoLExperiment
    from rustexp_tpu_torch.sims.nbody import NBodyExperiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            runtime.device(kind)
    for exp in (GoLExperiment, NBodyExperiment):
        with pytest.raises(RuntimeError, match="CUDA"):
            exp()
        assert exp("cpu").device == CPU
    assert runtime.device("cpu") == CPU
    assert runtime.device(CPU) == CPU


def test_profiler_loss_needs_the_card(monkeypatch, capsys):
    """The profiler-loss count runs only on the card: without one it
    exits 1 and prints no totals."""
    from rustexp_tpu_torch.app import profiler_loss

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler_loss.main(1) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_state_builders_mean_the_card(monkeypatch):
    """The functions that build state put it on the card unless asked for
    the CPU, and raise without one; an Experiment refuses a state that
    lies on another device rather than run it there."""
    from rustexp_tpu_torch import interop
    from rustexp_tpu_torch.assets.gol_patterns import PATTERNS, \
        pattern_to_array
    from rustexp_tpu_torch.core import prng
    from rustexp_tpu_torch.sims import gol, nbody

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = np.zeros((64, 64), np.uint8)
    arrays = [np.ones(8, np.float32)] * 5
    key = prng.key(0)
    pat = pattern_to_array(PATTERNS["gun"])
    builders = (lambda d: interop.gol_state_from_numpy(grid, d).grid,
                lambda d: interop.nbody_state_from_numpy(arrays, d).px,
                lambda d: gol.randomize(key, 64, d),
                lambda d: gol.set_pattern(pat, 64, d),
                lambda d: nbody.random_disk(key, 8, d)[0],
                lambda d: nbody.stable_orbits(key, 8, device=d)[0])
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA"):
            build(None)
        assert build("cpu").device == CPU

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="meta"):
        gol.GoLExperiment("cpu").step(gol.GoLState(
            grid=torch.zeros((64, 64), dtype=torch.uint8, device=meta)))
    with pytest.raises(ValueError, match="meta"):
        nbody.NBodyExperiment("cpu").step(nbody.NBodyState(
            *(torch.zeros(8, device=meta) for _ in range(5))))


@pytest.mark.parametrize("idx", range(jmesh.NUM_MESHES))
def test_get_mesh_matches_jax(idx):
    """The port's own copy of assets.mesh gives JAX's arrays, names and
    cameras for every mesh of the table (procedural stand-ins here)."""
    a, b = jmesh.get_mesh(idx), tmesh.get_mesh(idx)
    assert (a.name, a.num_tris) == (b.name, b.num_tris)
    for f in ("positions", "normals", "colors", "tris"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(a.normalize_dimensions(), b.normalize_dimensions())
    assert tmesh.mesh_name(idx) == jmesh.mesh_name(idx)
    assert tmesh.mesh_camera(idx) == jmesh.mesh_camera(idx)


def test_load_hdr_matches_jax(tmp_path):
    """The port's own HDR decoder gives JAX's array on a file holding all
    three scanline encodings: new per-component RLE (runs and literals),
    flat RGBE, and flat RGBE with an old-style repeat marker."""
    w = 16
    rng = np.random.default_rng(11)
    flat = rng.integers(0, 256, size=(w, 4), dtype=np.uint8)
    rle = bytearray([2, 2, 0, w])
    for c in range(4):
        lit = rng.integers(0, 256, size=6, dtype=np.uint8)
        rle += bytes([6]) + lit.tobytes() + bytes([128 + w - 6, 100 + c])
    old = flat.copy()
    old[5] = (1, 1, 1, 3)  # repeat pixel 4 three times
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 +X 16\n"
            + bytes(rle) + flat.tobytes() + old[:w - 2].tobytes())
    path = tmp_path / "t.hdr"
    path.write_bytes(data)
    want = jhdr.load_hdr(str(path))
    got = thdr.load_hdr(str(path))
    assert got.shape == want.shape == (3, w, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got[2, 5:8], np.repeat(got[2, 4:5], 3, axis=0))


@pytest.mark.parametrize("name", sorted(jcamera.CAMERAS))
def test_camera_eye_matches_jax(name):
    for tick in (0.0, 0.05, 0.7, 3.0, 17.25):
        a = jcamera.camera_eye(name, tick)
        b = tcamera.camera_eye(name, tick)
        assert a.dtype == b.dtype and np.array_equal(a, b), tick


def test_unported_shaders_and_modes_raise():
    """Nothing of the shaders and modes is refused any more: every shader
    resolves (A5), shader 0 renders through the oracle, and the point and
    line modes (A10) render through every structure, the G-buffer
    oracle's (asked for, and render_frame's default on a frame of partial
    32x128 tiles) included, with no shader called. What still raises is a
    shader index past the table on a Fill frame."""
    for i in range(tsh.NUM_SHADERS):
        assert callable(tsh.shader_fn(i)), tsh.shader_name(i)
    scene = tpp.make_scene(tmesh.make_sphere(4, 8),
                           tcubemap.make_procedural_set(), CPU)
    eye = np.array([0, 0, 2], np.float32)
    oracle = tstruct.Structure(tstruct.ORACLE)
    assert tpp.render_frame(scene, eye, 0.0, w=128, h=128, structure=oracle,
                            shader_idx=0).shape == (128, 128)
    for kw in (dict(w=96, mode=tpp.MODE_POINT),
               dict(structure=tstruct.Structure(tstruct.BINS),
                    mode=tpp.MODE_LINE)):
        fb = tpp.render_frame(scene, eye, 0.0, **{"w": 128, "h": 128, **kw})
        assert fb.shape == (128, kw["w"] if "w" in kw else 128)
        assert int((fb.view(torch.int32) == 0x00FFFFFF).sum()) > 0
    with pytest.raises(IndexError):
        tpp.render_frame(scene, eye, 0.0, w=128, h=128, structure=oracle,
                         shader_idx=tsh.NUM_SHADERS, show_cm=False)
