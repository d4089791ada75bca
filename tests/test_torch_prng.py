"""PyTorch port (rustexp_tpu_torch) vs jax.random: the seeded states.

core/prng.py ports jax.random's threefry2x32 as the JAX package uses it.
Bit for bit against JAX on the CPU: keys (edge seeds included), splits,
raw bits, uniform at the three bounds the JAX package draws with,
bernoulli at 2048^2, the GoL Experiment's grids and keys after R keys,
N-body masses and keys. Within ULPS float32 steps of each value: N-body
px, py, vx, vy, because XLA:CPU's cos and sin are not correctly rounded
(the port's ops.ieee.cos_sin is). Checkpoints cross between the packages
both ways, and a JAX key crosses through interop. The known answers that
chip_smoke.py holds the card to are checked here against jax.random.
"""

import itertools
import json
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from rustexp_tpu.core import checkpoint as jckpt
from rustexp_tpu.sims import gol as jgol
from rustexp_tpu.sims import nbody as jn
from rustexp_tpu_torch import interop
from rustexp_tpu_torch.core import checkpoint as tckpt
from rustexp_tpu_torch.core import prng
from rustexp_tpu_torch.ops.ieee import cos_sin
from rustexp_tpu_torch.sims import gol as tgol
from rustexp_tpu_torch.sims import nbody as tn

CPU = torch.device("cpu")
SEEDS = (0, 1, 7, 2**31 - 1, -1)
SHAPES = ((), (1,), (5,), (3, 5), (1000, 2), (256, 256))
# (minval, maxval) of every uniform the JAX package draws
# (rustexp_tpu/sims/nbody.py:39-46, :56-57; gol.py:30 through bernoulli)
BOUNDS = ((0.0, 1.0), (-3.5, 3.5), (0.1, 1.5))
ULPS = 2  # N-body px, py, vx, vy against JAX's


def _u32(a) -> np.ndarray:
    """Words of a key, bits or float32 draw as uint32, either package."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.uint32) if a.dtype == np.int64 else a.view(np.uint32)


def _ulps(a, b) -> int:
    ai = _u32(a).view(np.int32).astype(np.int64)
    bi = _u32(b).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def test_jax_draws_with_partitionable_threefry():
    """The port follows JAX's defaults; a change of them fails here
    rather than drifting."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    k, jk = prng.key(seed), jax.random.PRNGKey(seed)
    assert k.dtype == torch.uint32 and k.device == CPU
    assert k.numpy().dtype == np.uint32
    assert np.array_equal(k.numpy(), np.asarray(jk))
    for num in (2, 3, 4):
        got = prng.split(k, num)
        assert got.shape == (num, 2) and got.dtype == torch.uint32
        assert np.array_equal(got.numpy(), np.asarray(jax.random.split(jk,
                                                                       num)))
    a, b = prng.split(k)
    ja, jb = jax.random.split(jk)
    for got, want in ((prng.split(a), jax.random.split(ja)),
                      (prng.split(b, 4), jax.random.split(jb, 4))):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [2**31, 2**32 + 5, 2**32 - 1, -2**31,
                                  2**40 + 3, -(2**40), 2**63 - 1])
def test_key_edge_seeds_match_jax(seed):
    """JAX takes a Python int through int64 (x64 off): the low 32 bits."""
    assert np.array_equal(prng.key(seed).numpy(),
                          np.asarray(jax.random.PRNGKey(seed)))


def test_key_past_int64_raises_like_jax():
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2**63)
    with pytest.raises(OverflowError):
        prng.key(2**63)


@pytest.mark.parametrize("seed,shape", itertools.product(SEEDS, SHAPES))
def test_bits_match_jax(seed, shape):
    got = prng.random_bits(prng.key(seed), shape, CPU)
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape))
    assert got.shape == want.shape and got.dtype == torch.int64
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("seed", (0, 7, -1))
@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_uniform_matches_jax(seed, lo, hi):
    for shape in ((4,), (1000, 2), (256, 256)):
        got = prng.uniform(prng.key(seed), shape, lo, hi, CPU)
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                             minval=lo, maxval=hi))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.array_equal(_u32(got), _u32(want)), (shape, lo, hi)


@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_uniform_scaling_is_exact_in_float64(lo, hi):
    """prng.uniform rounds f * (hi - lo) + lo once, as XLA:CPU's FMA, by
    taking the product and the sum in float64: exact when every value
    lies on a grid of 2**g with fewer than 53 bits above it. f is a
    multiple of 2**-23 below 1 and the float32 span has 24 bits, so the
    product is exact; the sum's grid is the finer of the product's and
    lo's. Checked on the bounds, then on 1,000 draws by exact rationals."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = np.float32(hi32 - lo32)

    def last_bit(x) -> int:  # exponent of x's lowest set bit, or finer
        return -(Fraction(float(x)).denominator.bit_length() - 1)

    g = min(last_bit(span) - 23, last_bit(lo32))
    top = max(abs(Fraction(float(lo32))),
              abs(Fraction(float(lo32)) + Fraction(float(span))))
    assert top < Fraction(2) ** (53 + g), (lo, hi, g)
    f = prng.uniform(prng.key(3), (1000,), device=CPU)
    scaled = f.double() * float(span) + float(lo32)
    for fi, si in zip(f.tolist(), scaled.tolist()):
        assert Fraction(si) == (Fraction(fi) * Fraction(float(span))
                                + Fraction(float(lo32)))


def test_bernoulli_2048_matches_jax():
    got = prng.bernoulli(prng.key(7), 0.5, (2048, 2048), CPU)
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(7), 0.5,
                                           (2048, 2048)))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_known_answers_match_jax():
    """chip_smoke.py's known answers, which the card is held to, are
    jax.random's, and the port's seeded draws on the CPU meet them."""
    k0 = jax.random.PRNGKey(0)
    assert np.asarray(jax.random.split(k0)).tolist() == [
        list(k) for k in chip_smoke.KAT_SPLIT]
    for (lo, hi), words in chip_smoke.KAT_UNIFORM.items():
        assert tuple(_u32(jax.random.uniform(k0, (4,), minval=lo,
                                             maxval=hi)).tolist()) == words
    je = jgol.GoLExperiment()
    grid = np.asarray(je.handle_key(je.init(n=chip_smoke.SEEDED_GOL_N),
                                    "R").grid)
    assert int(grid.sum()) == chip_smoke.KAT_GOL_LIVE
    for (r, c), word in chip_smoke.KAT_GOL_WORDS.items():
        assert chip_smoke._cells_word(torch.tensor(grid[r, c:c + 32])) == word
    orbits = jn.stable_orbits(k0, chip_smoke.NBODY_N)
    at = list(chip_smoke.KAT_ORBITS_AT)
    for name, a in zip(("px", "py", "vx", "vy"), orbits):
        assert tuple(_u32(np.asarray(a)[at]).tolist()) == (
            chip_smoke.KAT_ORBITS[name])
    bad, drawn = chip_smoke.seeded_draws(CPU)
    assert bad == [] and drawn["grid"].shape == (2048, 2048)


@pytest.mark.parametrize("n", (64, 256))
def test_gol_r_keys_match_jax(n):
    """init, then three R keys, each grid and key equal to JAX's
    Experiment's, and a step of the drawn grid."""
    je, te = jgol.GoLExperiment(), tgol.GoLExperiment(CPU)
    js, ts = je.init(n=n, steps_per_frame=4), te.init(n=n, steps_per_frame=4)
    assert np.array_equal(ts.key.numpy(), np.asarray(js.key))
    for _ in range(3):
        js, ts = je.handle_key(js, "R"), te.handle_key(ts, "R")
        assert ts.grid.dtype == torch.uint8
        assert np.array_equal(ts.grid.numpy(), np.asarray(js.grid))
        assert np.array_equal(ts.key.numpy(), np.asarray(js.key))
    js, ts = je.step(js), te.step(ts)
    assert np.array_equal(ts.grid.numpy(), np.asarray(js.grid))


def _particles(st):
    return st.px, st.py, st.vx, st.vy, st.m


def _assert_particles_match(got, want):
    """(px, py, vx, vy, m) of the port against JAX's."""
    assert np.array_equal(_u32(got[4]), _u32(want[4]))
    for f, a, b in zip(("px", "py", "vx", "vy"), got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, f
        assert np.array_equal(np.sign(a.numpy()), np.sign(b)), f
        assert _ulps(a, b) <= ULPS, f


@pytest.mark.parametrize("mode", ("orbits", "disk"))
@pytest.mark.parametrize("n", (1024, 131072))
def test_nbody_init_matches_jax(mode, n):
    """Masses and the state's key bit for bit; positions and velocities
    within ULPS of each value (the disk's velocities are draws, so bit
    for bit)."""
    js = jn.NBodyExperiment().init(mode=mode, n=n)
    ts = tn.NBodyExperiment(CPU).init(mode=mode, n=n)
    assert np.array_equal(ts.key.numpy(), np.asarray(js.key))
    _assert_particles_match(_particles(ts), _particles(js))
    if mode == "disk":
        for f in ("vx", "vy"):
            assert np.array_equal(_u32(getattr(ts, f)),
                                  _u32(getattr(js, f)))


def test_nbody_handle_key_advances_the_key_like_jax():
    """Every key splits the state's key first (the unknown 'z' too); the
    resets start from seed 0's init key, with JAX's particles."""
    je, te = jn.NBodyExperiment(), tn.NBodyExperiment(CPU)
    js, ts = je.init(n=64, seed=5), te.init(n=64, seed=5)
    for key in ("X", "a", "z", "A", "x", "E", "X", "W", "Q"):
        js, ts = je.handle_key(js, key), te.handle_key(ts, key)
        assert np.array_equal(ts.key.numpy(), np.asarray(js.key)), key
        assert ts.n == js.n and ts.dt == js.dt, key
        assert abs(ts.theta - js.theta) < 1e-12, key
        _assert_particles_match(_particles(ts), _particles(js))


def test_stable_orbits_from_any_key_match_jax():
    """The sims' draws at other keys and radii (the E key's 5 bodies in
    5-30) and random_disk at an odd size."""
    k = prng.split(prng.key(11), 3)[2]
    jk = jax.random.split(jax.random.PRNGKey(11), 3)[2]
    for got, want in (
            (tn.stable_orbits(k, 5, 5.0, 30.0, CPU),
             jn.stable_orbits(jk, 5, 5.0, 30.0)),
            (tn.stable_orbits(k, 3001, device=CPU), jn.stable_orbits(jk, 3001)),
            (tn.random_disk(k, 777, CPU), jn.random_disk(jk, 777))):
        _assert_particles_match(got, want)


def test_cos_sin_is_correctly_rounded_and_within_an_ulp_of_jax():
    """ops.ieee.cos_sin against float64 numpy rounded once (equal on
    these 200,000 angles of [0, 2 pi) and the quadrant edges) and against
    XLA:CPU's float32 cos and sin (within one step)."""
    rng = np.random.default_rng(0)
    th = np.concatenate([
        rng.random(200_000).astype(np.float32) * np.float32(2 * np.pi),
        np.float32([0.0, np.pi / 4, np.pi / 2, np.pi, 1.5 * np.pi, -1.0,
                    -7.5, 1000.25])])
    c, s = cos_sin(torch.from_numpy(th))
    assert c.dtype == s.dtype == torch.float32
    assert np.array_equal(c.numpy(), np.cos(th.astype(np.float64))
                          .astype(np.float32))
    assert np.array_equal(s.numpy(), np.sin(th.astype(np.float64))
                          .astype(np.float32))
    assert _ulps(c, np.asarray(jnp.cos(th))) <= 1
    assert _ulps(s, np.asarray(jnp.sin(th))) <= 1


def test_interop_takes_a_jax_key():
    js = jgol.GoLExperiment().init(n=64, seed=9)
    ts = interop.gol_state_from_numpy(np.asarray(js.grid), CPU,
                                      key=np.asarray(js.key))
    assert ts.key.dtype == torch.uint32
    js = jgol.GoLExperiment().handle_key(js, "R")
    ts = tgol.GoLExperiment(CPU).handle_key(ts, "R")
    assert np.array_equal(ts.grid.numpy(), np.asarray(js.grid))
    jb = jn.NBodyExperiment().init(n=32, seed=4)
    tb = interop.nbody_state_from_numpy(
        [np.asarray(a) for a in (jb.px, jb.py, jb.vx, jb.vy, jb.m)], CPU,
        key=jb.key)
    jb = jn.NBodyExperiment().handle_key(jb, "X")
    tb = tn.NBodyExperiment(CPU).handle_key(tb, "X")
    assert np.array_equal(tb.key.numpy(), np.asarray(jb.key))
    with pytest.raises(ValueError, match="two uint32 words"):
        prng.as_key(np.zeros(3, np.uint32))


# ------------------------------------------------------------ checkpoints

def test_jax_checkpoints_load_into_the_port(tmp_path):
    """JAX saves a GoL state after an R key and steps, and an N-body
    state; the port loads each, and its next R (GoL) and key advance
    (N-body) equal JAX's after loading its own file."""
    je, te = jgol.GoLExperiment(), tgol.GoLExperiment(CPU)
    js = je.handle_key(je.init(n=64, steps_per_frame=3, seed=2), "R")
    js = je.step(je.step(js))
    path = jckpt.save_state(str(tmp_path / "gol"), js)
    jl = je.handle_key(jckpt.load_state(path, je), "R")
    tl = tckpt.load_state(path, te)
    assert tl.generations == 6 and tl.steps_per_frame == 3
    assert tl.key.dtype == torch.uint32
    tl = te.handle_key(tl, "R")
    assert np.array_equal(tl.grid.numpy(), np.asarray(jl.grid))
    assert np.array_equal(tl.key.numpy(), np.asarray(jl.key))

    jne, tne = jn.NBodyExperiment(), tn.NBodyExperiment(CPU)
    jb = jne.handle_key(jne.init(n=256, seed=3), "X")
    path = jckpt.save_state(str(tmp_path / "nbody"), jb)
    jbl = jne.handle_key(jckpt.load_state(path, jne), "a")
    tbl = tne.handle_key(tckpt.load_state(path, tne), "a")
    assert tbl.dt == jbl.dt and abs(tbl.theta - jbl.theta) < 1e-12
    assert np.array_equal(tbl.key.numpy(), np.asarray(jbl.key))
    for f in ("px", "py", "vx", "vy", "m"):
        assert np.array_equal(_u32(getattr(tbl, f)), _u32(getattr(jbl, f)))


def test_port_checkpoints_load_into_jax(tmp_path):
    te, je = tgol.GoLExperiment(CPU), jgol.GoLExperiment()
    ts = te.handle_key(te.init(n=64, steps_per_frame=2, seed=6), "R")
    ts = te.step(ts)
    path = tckpt.save_state(tmp_path / "gol", ts)
    with np.load(path) as data:
        assert data["key"].dtype == np.uint32 and data["key"].shape == (2,)
        meta = json.loads(bytes(data["__meta__"]))
    assert meta == {"type": "GoLState", "scalars": {
        "generations": 2, "steps_per_frame": 2, "backend": "auto"}}
    jl = je.handle_key(jckpt.load_state(path, je), "R")
    tl = te.handle_key(tckpt.load_state(path, te), "R")
    assert jl.generations == 0 and np.array_equal(np.asarray(jl.grid),
                                                  tl.grid.numpy())
    assert np.array_equal(np.asarray(jl.key), tl.key.numpy())

    tne, jne = tn.NBodyExperiment(CPU), jn.NBodyExperiment()
    tb = tne.step(tne.init(mode="disk", n=128, seed=8, dt=0.02))
    path = tckpt.save_state(tmp_path / "nbody", tb)
    jb = jckpt.load_state(path, jne)
    assert jb.dt == 0.02 and jb.steps == 1
    assert np.array_equal(np.asarray(jb.key), tb.key.numpy())
    for f in ("px", "py", "vx", "vy", "m"):
        assert np.array_equal(_u32(getattr(jb, f)), _u32(getattr(tb, f)))


def test_generator_checkpoint_loads_with_the_init_key(tmp_path,
                                                      monkeypatch):
    """A GoL file of the port before the prng (a torch generator's state
    under "gen") loads its grid and scalars, takes the init key and says
    so."""
    grid = tgol.set_pattern(
        np.eye(8, dtype=np.uint8), 64, CPU).numpy()
    meta = json.dumps({"type": "GoLState",
                       "scalars": {"generations": 5, "steps_per_frame": 4,
                                   "backend": "auto"},
                       "generators": ["gen"]})
    path = tmp_path / "old.npz"
    np.savez_compressed(path, grid=grid,
                        gen=torch.Generator().manual_seed(1).get_state()
                        .numpy(),
                        __meta__=np.frombuffer(meta.encode(), np.uint8))
    said = []
    monkeypatch.setattr(tckpt, "trace_info", said.append)
    st = tckpt.load_state(path, tgol.GoLExperiment(CPU))
    assert np.array_equal(st.grid.numpy(), grid)
    assert st.generations == 5 and st.steps_per_frame == 4
    assert torch.equal(st.key, prng.key(0)) and not hasattr(st, "gen")
    assert len(said) == 1 and "'gen'" in said[0] and "init key" in said[0]
