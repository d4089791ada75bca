"""PyTorch port (rustexp_tpu_torch) vs the JAX package: Game of Life.

Grids are made with numpy from a seed and fed to both packages. Every
comparison is bit for bit: the plain versions of kernels B4 (SWAR) and B8
(f32 stencil) against the Pallas kernels in interpret mode, the roll and
circulant steps, patterns, the render and the Experiment, and the
gol_gun_64 golden at 0 differing pixels.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.assets import gol_patterns as jpat
from rustexp_tpu.ops import gol_bits as jbits
from rustexp_tpu.ops import gol_stencil as jsten
from rustexp_tpu.sims import gol as jgol
from rustexp_tpu_torch import interop
from rustexp_tpu_torch.app import benchmark as tbench
from rustexp_tpu_torch.assets import gol_patterns as tpat
from rustexp_tpu_torch.ops import gol_bits as tbits
from rustexp_tpu_torch.ops import gol_stencil as tsten
from rustexp_tpu_torch.sims import gol as tgol

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "gol_gun_64.npz")


def _grid(seed, shape, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(dtype)


def test_patterns_match_jax():
    assert sorted(tpat.PATTERNS) == sorted(jpat.PATTERNS)
    for name in jpat.PATTERNS:
        a = jpat.pattern_to_array(jpat.PATTERNS[name])
        b = tpat.pattern_to_array(tpat.PATTERNS[name])
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_pack_unpack_match_jax():
    g = _grid(3, (64, 192), np.int32)
    want = np.asarray(jbits.pack_rows(jnp.asarray(g)))
    got = tbits.pack_rows(torch.from_numpy(g))
    assert got.dtype == torch.uint32 and got.shape == (2, 192)
    assert np.array_equal(got.numpy(), want)
    back = tbits.unpack_rows(got)
    assert back.dtype == torch.int32 and np.array_equal(back.numpy(), g)
    assert np.array_equal(
        tbits.unpack_rows(got, dtype=torch.uint8).numpy(),
        np.asarray(jbits.unpack_rows(jnp.asarray(want), dtype=jnp.uint8)))


@pytest.mark.parametrize("shape,k", [((256, 256), 37), ((64, 384), 5),
                                     ((96, 160), 33)])
def test_plain_b4_matches_jax(shape, k):
    """The plain B4 (multi_step_packed on CPU tensors) against the Pallas
    SWAR kernel in interpret mode, packed and through multi_step_swar,
    across the JAX kernel's unroll boundary (k = 33, 37)."""
    g = _grid(4, shape)
    packed = np.array(jbits.pack_rows(jnp.asarray(g)))
    want_p = np.asarray(jbits.multi_step_packed(jnp.asarray(packed),
                                                jnp.int32(k)))
    got_p = tbits.multi_step_packed(torch.from_numpy(packed.view(np.int32)), k)
    assert got_p.dtype == torch.uint32
    assert np.array_equal(got_p.numpy(), want_p)
    want = np.asarray(jbits.multi_step_swar(jnp.asarray(g), jnp.int32(k)))
    got = tbits.multi_step_swar(torch.from_numpy(g), k)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_plain_b8_matches_jax():
    g = _grid(1, (256, 256))
    want = np.asarray(jsten.multi_step_pallas(jnp.asarray(g), jnp.int32(5)))
    got = tsten.multi_step_pallas(torch.from_numpy(g), 5)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["step_roll", "step_mxu"])
def test_single_steps_match_jax(name):
    g = _grid(2, (128, 128))
    want = np.asarray(getattr(jsten, name)(jnp.asarray(g)))
    got = getattr(tsten, name)(torch.from_numpy(g))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["mxu", "roll"])
def test_multi_step_matches_jax(backend):
    g = _grid(5, (64, 64), np.int32)
    want = np.asarray(jsten.multi_step(jnp.asarray(g), 9, backend))
    got = tsten.multi_step(torch.from_numpy(g), 9, backend)
    assert np.array_equal(got.numpy(), want)


def test_swar_auto_matches_jax():
    """multi_step_swar_auto at a 32-row-aligned, non-square size."""
    g = _grid(6, (128, 96), np.int32)
    want = np.asarray(jbits.multi_step_swar_auto(jnp.asarray(g), 40))
    got = tbits.multi_step_swar_auto(torch.from_numpy(g), 40)
    assert np.array_equal(got.numpy(), want)


def test_guards_raise_like_jax():
    """rows % 32 for B4; more than 640 x 1024 cells for B8."""
    bad = np.zeros((33, 64), np.int32)
    with pytest.raises(ValueError):
        jbits.multi_step_swar(jnp.asarray(bad), jnp.int32(1))
    for fn in (tbits.multi_step_swar, tbits.multi_step_swar_auto):
        with pytest.raises(ValueError, match="32"):
            fn(torch.from_numpy(bad), 1)
    with pytest.raises(ValueError):
        tbits.pack_rows(torch.from_numpy(bad))
    big = np.zeros((1024, 1024), np.uint8)
    with pytest.raises(ValueError):
        jsten.multi_step_pallas(jnp.asarray(big), jnp.int32(1))
    with pytest.raises(ValueError, match="cells"):
        tsten.multi_step_pallas(torch.from_numpy(big), 1)


@pytest.mark.parametrize("name", sorted(jpat.PATTERNS))
def test_set_pattern_and_render_match_jax(name):
    """Patterns centred on 256^2 and (clipped) on 24^2, rendered into a
    larger, an equal and a smaller frame."""
    for n in (256, 24):
        pat = jpat.pattern_to_array(jpat.PATTERNS[name])
        want = np.asarray(jgol.set_pattern(pat, n))
        grid = tgol.set_pattern(pat, n, CPU)
        assert grid.dtype == torch.uint8 and np.array_equal(grid.numpy(), want)
        for w, h in ((512, 384), (n, n), (100, 80)):
            fb = np.asarray(jgol.gol_render(jnp.asarray(want), jnp.zeros(w),
                                            jnp.zeros(h)))
            got = tgol.gol_render(grid, w, h)
            assert got.dtype == torch.uint32 and got.shape == (h, w)
            assert np.array_equal(got.numpy(), fb), (n, w, h)


@pytest.mark.parametrize("backend", ["auto", "mxu", "pallas"])
def test_experiment_matches_jax(backend):
    """gun, 8 generations per step, three steps: grid and frame equal to
    JAX's Experiment (its auto is the SWAR kernel; the port's auto on a
    256-row grid is B4's plain version here)."""
    je, te = jgol.GoLExperiment(), tgol.GoLExperiment(CPU)
    js = je.init(pattern="gun", backend=backend, steps_per_frame=8)
    ts = te.init(pattern="gun", backend=backend, steps_per_frame=8)
    assert te.route(256, backend) == ("bits" if backend == "auto" else backend)
    for _ in range(3):
        js, ts = je.step(js), te.step(ts)
        assert np.array_equal(ts.grid.numpy(), np.asarray(js.grid))
    assert ts.generations == js.generations == 24
    assert np.array_equal(te.render(ts, 512, 512).numpy(),
                          np.asarray(je.render(js, 512, 512)))


def test_bits_banded_runs_b4_like_jax(monkeypatch):
    """backend "bits_banded" (the JAX package's banded SWAR route) reaches
    gol_bits.multi_step_swar, B4, and gives JAX's grid from an R grid."""
    calls = []
    swar = tbits.multi_step_swar
    monkeypatch.setattr(tbits, "multi_step_swar",
                        lambda g, k: calls.append(k) or swar(g, k))
    je, te = jgol.GoLExperiment(), tgol.GoLExperiment(CPU)
    js = je.handle_key(je.init(n=64, backend="bits_banded",
                               steps_per_frame=4), "R")
    ts = te.handle_key(te.init(n=64, backend="bits_banded",
                               steps_per_frame=4), "R")
    assert te.route(64, "bits_banded") == "bits"
    for _ in range(2):
        js, ts = je.step(js), te.step(ts)
        assert np.array_equal(ts.grid.numpy(), np.asarray(js.grid))
    assert calls == [4, 4] and ts.generations == js.generations == 8


@pytest.mark.parametrize("backend", ["mxu", "auto"])
def test_golden_gol_gun_64(backend):
    """tests/test_golden.py's GoL golden (gun, 64 generations, 256^2
    frame) at 0 differing pixels, by the circulant form and by B4's plain
    version."""
    te = tgol.GoLExperiment(CPU)
    st = te.init(pattern="gun", backend=backend, steps_per_frame=64)
    fb = te.render(te.step(st), 256, 256).numpy()
    want = np.load(GOLDEN)["fb"]
    assert fb.dtype == want.dtype and int((fb != want).sum()) == 0


def test_experiment_keys_and_status():
    te = tgol.GoLExperiment(CPU)
    st = te.init(pattern="gun", steps_per_frame=4)
    st = te.step(st)
    assert st.generations == 4 and "Gens" in te.status(st)
    for key, spf in (("T", 8), ("t", 16), ("Y", 8), ("y", 4)):
        st = te.handle_key(st, key)
        assert st.steps_per_frame == spf
    st = te.handle_key(st, "A")
    assert st.generations == 0
    assert np.array_equal(st.grid.numpy(), np.asarray(jgol.set_pattern(
        jpat.pattern_to_array(jpat.PATTERNS["acorn"]))))
    st = te.handle_key(st, "R")
    assert st.grid.shape == (256, 256) and st.grid.dtype == torch.uint8
    assert 0.4 < float(st.grid.float().mean()) < 0.6
    small = te.init(pattern="gun", n=128, backend="roll")
    assert te.step(small).grid.shape == (128, 128)


def test_interop_carries_a_jax_grid():
    g = np.asarray(jgol.set_pattern(
        jpat.pattern_to_array(jpat.PATTERNS["ark"])))
    st = interop.gol_state_from_numpy(g, CPU, steps_per_frame=5)
    assert st.grid.dtype == torch.uint8 and np.array_equal(st.grid.numpy(), g)
    st = tgol.GoLExperiment(CPU).step(st)
    assert np.array_equal(st.grid.numpy(), np.asarray(
        jsten.multi_step(jnp.asarray(g), 5, "mxu")))


@pytest.mark.parametrize("shape,k,want", [
    ((8, 256), 65536, ("resident", 1)),   # bench_gol 256^2: one launch
    ((8, 256), 8, ("resident", 1)),       # the Experiment's step
    ((8, 256), 0, ("resident", 0)),
    ((64, 2048), 100, ("tiled", 7)),
    ((64, 2048), 16, ("tiled", 1)),
    ((9, 256), 17, ("tiled", 2)),         # one word row past the limit
    ((8, 288), 31, ("tiled", 2)),         # past RESIDENT_MAX_WORDS
    ((2, 1024), 1, ("resident", 1)),      # RESIDENT_MAX_THREADS columns
    ((1, 1056), 16, ("tiled", 1)),        # one warp past them
    ((1, 32), 5, ("resident", 1)),
    ((3, 160), 37, ("resident", 1)),      # 5 warps
    ((1, 40), 33, ("tiled", 3)),          # columns not whole warps
])
def test_b4_plan(shape, k, want):
    """B4's form and launch count by the packed grid's size: resident
    (one launch of all k generations) or tiled (ceil(k / 16)
    launches)."""
    assert tuple(tbits._b4_plan(*shape, k)) == want


def test_b4_plan_forced_forms():
    """A caller may force either form; the resident one only where it can
    hold the grid, and no other form exists."""
    assert tuple(tbits._b4_plan(8, 256, 100, "tiled")) == ("tiled", 7)
    assert tuple(tbits._b4_plan(8, 1024, 1, "resident")) == ("resident", 1)
    for wn, cn in ((64, 2048), (9, 256), (1, 1056), (1, 40)):
        with pytest.raises(ValueError, match="resident"):
            tbits._b4_plan(wn, cn, 1, "resident")
    with pytest.raises(ValueError, match="form"):
        tbits._b4_plan(8, 256, 1, "banded")


@pytest.mark.parametrize("shape,k,want", [
    ((256, 256), 8, (8, 1, 256)),         # the Experiment's step
    ((512, 512), 20, (7, 3, 841)),        # 7, 7 and 6 generations
    ((256, 256), 20, (7, 3, 225)),
    ((640, 1024), 20, (7, 3, 2052)),      # the guard's largest grid
    ((256, 256), 1, (1, 1, 81)),          # a halo of one: 30 x 30 interiors
    ((20, 30), 9, (5, 2, 2)),             # smaller than a tile
    ((96, 160), 150, (8, 19, 60)),
    ((256, 256), 0, (8, 0, 0)),
])
def test_b8_plan(shape, k, want):
    """B8's generations a launch, launches (ceil(k / 8), the generations
    shared evenly) and one-warp blocks a launch (32 x 32 tiles that
    overlap by the halo)."""
    assert tuple(tsten._b8_plan(*shape, k)) == want


def test_kernels_and_bench_refuse_the_cpu():
    """The CUDA wrappers take CUDA tensors only, and bench_gol times the
    card only."""
    p = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tbits.multi_step_packed_cuda(p, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tsten.multi_step_pallas_cuda(torch.zeros((64, 64)), 1)
    with pytest.raises(ValueError, match="times the card"):
        tbench.bench_gol(8, 1, 64, device=CPU)
