"""PyTorch port (rustexp_tpu_torch) vs the JAX package: N-body.

Particle sets are made by numpy from a seed or by JAX's own initial
conditions (stable_orbits from a PRNGKey, carried across as numpy
arrays) and fed to both packages; the port's own draws of the same keys
are held against JAX's in tests/test_torch_prng.py. Bit for bit: the plain version of
kernel B6 against the Pallas sorter in interpret mode, Morton codes and
Morton sorts, the near-block ranking, the runaway kill and the routing.
Within stated tolerances, because sums run in another order: the plain
B5 against the Pallas force kernel (interpret mode), the dense and
blocked forces, block Barnes-Hut forces and steps, and the
nbody_orbits_512_4 golden (its own 0.01 bound).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.ops import nbody_bh as jbh
from rustexp_tpu.ops import nbody_forces as jf
from rustexp_tpu.ops import nbody_pallas as jp
from rustexp_tpu.ops import sort_bitonic as jsb
from rustexp_tpu.sims import nbody as jn
from rustexp_tpu_torch import interop
from rustexp_tpu_torch.app import benchmark as tbench
from rustexp_tpu_torch.core import prng
from rustexp_tpu_torch.ops import nbody_bh as tbh
from rustexp_tpu_torch.ops import nbody_forces as tf
from rustexp_tpu_torch.ops import nbody_pallas as tp
from rustexp_tpu_torch.ops import sort_bitonic as tsb
from rustexp_tpu_torch.sims import nbody as tn

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "nbody_orbits_512_4.npz")
# Relative force error against the force magnitude: the bound
# tests/test_nbody.py:127 holds the Pallas kernel to.
FORCE_RTOL = 1e-4


def _orbits(seed, n):
    """JAX's stable_orbits ICs as numpy (px, py, vx, vy, m)."""
    return tuple(np.array(a) for a in jn.stable_orbits(
        jax.random.PRNGKey(seed), n))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _rel_err(fx, fy, want_x, want_y):
    want_x, want_y = np.asarray(want_x), np.asarray(want_y)
    err = np.hypot(fx.numpy() - want_x, fy.numpy() - want_y)
    return float((err / np.maximum(np.hypot(want_x, want_y), 1e-9)).max())


def test_plain_b5_matches_jax_pallas():
    """forces_pallas on CPU tensors (B5's plain version and the m_i
    multiply) against the Pallas kernel in interpret mode at N = 1024."""
    px, py, vx, vy, m = _orbits(9, 1024)
    want = jp.forces_pallas(px, py, m, 512, False)
    got = tp.forces_pallas(*_t(px, py, m), 512, False)
    assert _rel_err(*got, *want) < FORCE_RTOL


@pytest.mark.parametrize("form", ["dense", "blocked"])
def test_torch_forces_match_jax(form):
    px, py, vx, vy, m = _orbits(3, 1024)
    if form == "dense":
        want, got = jf.forces_dense(px, py, m), tf.forces_dense(*_t(px, py, m))
    else:
        want = jf.forces_blocked(px, py, m, 256)
        got = tf.forces_blocked(*_t(px, py, m), 256)
    assert _rel_err(*got, *want) < FORCE_RTOL


@pytest.mark.parametrize("route", ["pallas", "dense"])
def test_brute_steps_match_jax(route):
    """One Euler step each way, velocity and position to rtol 1e-4."""
    ics = _orbits(4, 1024)
    if route == "pallas":
        want = jp.step_brute_pallas(*ics, 1024, False, 0.01)
        got = tp.step_brute_pallas(*_t(*ics), 1024, False, 0.01)
    else:
        want = jf.step_brute_force(*ics, 0, 0.01)
        got = tf.step_brute_force(*_t(*ics), 0, 0.01)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)


def _sort_case(case, n, rng):
    if case == "ties":
        return rng.integers(0, 7, n).astype(np.int32)
    if case == "unique":
        return rng.permutation(1 << 20)[:n].astype(np.int32)
    if case == "sorted":
        return np.arange(n, dtype=np.int32)
    if case == "signed":
        info = np.iinfo(np.int32)
        key = rng.integers(info.min, info.max, n, dtype=np.int32,
                           endpoint=True)
        key[:8] = (info.min, -1, 0, info.max, info.min, -1, 0, info.max)
        return rng.permutation(key)
    return np.arange(n, dtype=np.int32)[::-1].copy()


@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("case", ["ties", "unique", "sorted", "reversed",
                                  "signed"])
def test_plain_b6_matches_jax(n, case):
    """sort_kv on CPU tensors (B6's plain version) against the Pallas
    network in interpret mode, five payloads, bit for bit."""
    rng = np.random.default_rng(n)
    key = _sort_case(case, n, rng)
    vals = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    vals.append(rng.integers(-9, 9, n).astype(np.int32))
    sk, sv = jsb.sort_kv(jnp.asarray(key), [jnp.asarray(v) for v in vals])
    tk, tv = tsb.sort_kv(*_t(key), _t(*vals))
    assert np.array_equal(tk.numpy(), np.asarray(sk))
    for a, b in zip(sv, tv):
        assert b.numpy().dtype == np.asarray(a).dtype
        assert np.array_equal(b.numpy(), np.asarray(a))


def test_plain_b6_idx_tiebreak_matches_jax():
    """An explicit idx, partly negative, replaces the positions as the
    tiebreak."""
    rng = np.random.default_rng(7)
    key = rng.integers(0, 5, 512).astype(np.int32)
    idx = rng.permutation(512).astype(np.int32) - 200
    val = rng.standard_normal(512).astype(np.float32)
    sk, (sv,) = jsb.sort_kv(jnp.asarray(key), [jnp.asarray(val)],
                            idx=jnp.asarray(idx))
    tk, (tv,) = tsb.sort_kv(*_t(key), _t(val), idx=torch.from_numpy(idx))
    assert np.array_equal(tk.numpy(), np.asarray(sk))
    assert np.array_equal(tv.numpy(), np.asarray(sv))
    order = np.lexsort((idx, key))
    assert np.array_equal(tv.numpy(), val[order])
    with pytest.raises(ValueError, match="power of two"):
        tsb.sort_kv(torch.zeros(768, dtype=torch.int32), [])


def test_morton_codes_match_jax():
    px, py, _, _, _ = _orbits(5, 4096)
    args = (px.min(), px.max(), py.min(), py.max())
    want = np.asarray(jbh.morton_codes(px, py, *args))
    got = tbh.morton_codes(*_t(px, py), *_t(*args))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for x, y, code in ((0, 0, 0), (1, 0, 1), (0, 1, 2), (3, 5, 0b100111)):
        assert int(tbh._morton16(torch.tensor(x), torch.tensor(y))) == code


@pytest.mark.parametrize("n,use_bitonic", [(1024, True), (1024, False),
                                           (768, True)])
def test_morton_sort_matches_jax(n, use_bitonic, monkeypatch):
    """Both routes (USE_BITONIC_SORT on and off), and the argsort fallback
    at a non-power-of-two N, equal JAX's bit for bit."""
    ics = _orbits(11, n)
    px, py, vx, vy, m = ics
    want = jbh.morton_sort(px, py, m, vx, vy, use_bitonic=use_bitonic)
    monkeypatch.setattr(tbh, "USE_BITONIC_SORT", use_bitonic)
    got = tbh.morton_sort(*_t(px, py, m, vx, vy))
    for a, b in zip(want, got):
        assert np.array_equal(b.numpy(), np.asarray(a))


def _block_boxes(seed, n, block):
    px, py, _, _, m = _orbits(seed, n)
    sx, sy, sm = (np.asarray(a) for a in jbh.morton_sort(px, py, m))
    xb, yb = sx.reshape(-1, block), sy.reshape(-1, block)
    return (xb.min(1), xb.max(1), yb.min(1), yb.max(1)), (sx, sy, sm)


@pytest.mark.parametrize("rows", [None, (3, 5)])
def test_near_block_indices_match_jax(rows):
    boxes, _ = _block_boxes(0, 4096, 128)
    kw = {} if rows is None else dict(row0=rows[0], rows=rows[1])
    want = np.asarray(jbh.near_block_indices(*boxes, 6, **kw))
    got = tbh.near_block_indices(*_t(*boxes), 6, **kw)
    assert np.array_equal(got.numpy(), want)


def test_near_block_ties_pin_the_block_itself():
    x1, x2 = np.zeros(40, np.float32), np.ones(40, np.float32)
    want = np.asarray(jbh.near_block_indices(x1, x2, x1, x2, 4))
    got = tbh.near_block_indices(*_t(x1, x2, x1, x2), 4).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, 0], np.arange(40))


@pytest.mark.parametrize("n,block", [(2048, 128), (4096, 256)])
def test_forces_bh_sorted_matches_jax(n, block):
    """Near and far field against JAX's on the same Morton-sorted set:
    relative error against the force magnitude under 2e-5 (the sums run
    in another order; measured about 2e-6)."""
    _, sorted_ = _block_boxes(1, n, block)
    k = jbh.theta_to_k(0.85, n // block)
    want = jbh.forces_bh_sorted(*sorted_, block, k)
    got = tbh.forces_bh_sorted(*_t(*sorted_), block, k)
    assert _rel_err(*got, *want) < 2e-5


def test_step_bh_matches_jax():
    """One block-BH step from JAX's ICs: the same Morton order (masses
    bit-equal, permuted), positions and velocities within 1e-5 of
    JAX's."""
    ics = _orbits(0, 2048)
    want = jbh.step_bh(*ics, 128, 6)
    got = tbh.step_bh(*_t(*ics), 128, 6)
    assert np.array_equal(got[4].numpy(), np.asarray(want[4]))
    for a, b in zip(want[:4], got[:4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def test_kill_runaway_and_routing_match_jax():
    rng = np.random.default_rng(2)
    px, py, vx, vy = (rng.uniform(-80, 80, 512).astype(np.float32)
                      for _ in range(4))
    want = jf.kill_runaway(px, py, vx, vy)
    got = tf.kill_runaway(*_t(px, py, vx, vy))
    for a, b in zip(want, got):
        assert np.array_equal(b.numpy(), np.asarray(a))
    je, te = jn.NBodyExperiment(), tn.NBodyExperiment(CPU)
    assert te.BH_BLOCKS == je.BH_BLOCKS and te.BH_MIN_N == je.BH_MIN_N
    for n in (5, 1024, 2047, 2048, 10_000, 131_072, 4099):
        for theta in (0.0, 0.5, 0.85):
            assert te.select_backend(n, theta) == je.select_backend(n, theta)
    for theta in (0.95, 0.85, 0.5, 0.25, 0.1, 0.05):
        for blocks in (16, 512):
            assert (tbh.theta_to_k(theta, blocks)
                    == jbh.theta_to_k(theta, blocks))


def _frame(fb):
    return fb.numpy() if isinstance(fb, torch.Tensor) else np.asarray(fb)


def test_golden_nbody_orbits():
    """tests/test_golden.py's N-body golden: the port's own
    stable_orbits(prng.key(0), 512), four brute steps of the port's
    Experiment (N % 1024 != 0: the dense route), rendered 256^2, within
    the golden's 0.01 bound; and the port's render of JAX's own particles
    differs from JAX's render by 0 pixels."""
    te = tn.NBodyExperiment(CPU)
    st = tn.NBodyState(*tn.stable_orbits(prng.key(0), 512, device=CPU))
    ref = _orbits(0, 512)
    for _ in range(4):
        st = te.step(st)
        ref = (*jf.step_brute_force(*ref[:4], ref[4]), ref[4])
    fb = te.render(st, 256, 256).numpy()
    want = np.load(GOLDEN)["fb"]
    assert fb.dtype == want.dtype and int((fb != want).sum()) <= 0.01 * fb.size
    jfb = np.asarray(jn.nbody_render(*ref[:4], 256, 256))
    got = tn.nbody_render(*_t(*ref[:4]), 256, 256).numpy()
    assert int((got != jfb).sum()) == 0


@pytest.mark.parametrize("w,h", [(512, 512), (320, 200)])
def test_render_matches_jax(w, h):
    """Splats, saturation and tails of a disk with some runaways, and
    velocities on the octant boundaries: 0 differing pixels."""
    px, py, vx, vy, _ = (np.array(a) for a in jn.random_disk(
        jax.random.PRNGKey(3), 4096))
    px[:16] = np.float32(1e10)
    vx[16:24], vy[16:24] = np.float32(1.0), np.float32(1.0)
    vx[24:32], vy[24:32] = np.float32(-1.0), np.float32(0.0)
    vx[32:40], vy[32:40] = np.float32(0.0), np.float32(0.0)
    want = np.asarray(jn.nbody_render(px, py, vx, vy, w, h))
    got = tn.nbody_render(*_t(px, py, vx, vy), w, h)
    assert got.dtype == torch.uint32 and got.shape == (h, w)
    assert int((got.numpy() != want).sum()) == 0


@pytest.mark.parametrize("n,theta", [(1024, 0.85), (4096, 0.85),
                                     (1000, 0.85)])
def test_experiment_steps_match_jax(n, theta):
    """Three Experiment steps from the same ICs: brute B5 (N = 1024),
    block BH with the bitonic sort (4096), the dense brute route (1000)."""
    ics = _orbits(2, n)
    je, te = jn.NBodyExperiment(), tn.NBodyExperiment(CPU)
    js = je.init(n=16)
    js.px, js.py, js.vx, js.vy, js.m = (jnp.asarray(a) for a in ics)
    js.theta = theta
    ts = interop.nbody_state_from_numpy(ics, CPU, theta=theta)
    for _ in range(3):
        js, ts = je.step(js), te.step(ts)
    assert ts.steps == 3 and "Bodies" in te.status(ts)
    assert np.array_equal(ts.m.numpy(), np.asarray(js.m))
    for f in ("px", "py", "vx", "vy"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)


def test_experiment_api_and_keys():
    te = tn.NBodyExperiment(CPU)
    st = te.init(mode="disk", n=1024, seed=3)
    assert st.px.dtype == torch.float32 and st.n == 1024
    assert 0.1 <= float(st.m.min()) and float(st.m.max()) <= 1.5
    assert float(torch.hypot(st.px, st.py).max()) <= 23.0
    st = te.step(st)
    assert st.steps == 1 and bool(torch.isfinite(st.px).all())
    dt0, th0 = st.dt, st.theta
    st = te.handle_key(st, "X")
    assert st.dt == dt0 * 2
    st = te.handle_key(st, "x")
    assert st.dt == dt0
    st = te.handle_key(st, "a")
    assert abs(st.theta - (th0 - 0.05)) < 1e-9
    st = te.handle_key(st, "A")
    assert abs(st.theta - th0) < 1e-9
    small = te.handle_key(st, "e")
    assert small.n == 5 and small.dt == st.dt
    orbits = te.init(n=64)
    assert float(orbits.m[0]) == 1000.0 and bool((orbits.m[1:] == 1).all())


def test_kernels_and_bench_refuse_the_cpu():
    x = torch.zeros(1024)
    with pytest.raises(ValueError, match="CUDA"):
        tp.forces_pallas_cuda(x, x, x)
    k = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tsb.sort_kv_cuda(k, k, [])
    with pytest.raises(ValueError, match="multiple"):
        tp.forces_pallas(torch.zeros(1000), torch.zeros(1000),
                         torch.ones(1000))
    with pytest.raises(ValueError, match="times the card"):
        tbench.bench_nbody(1024, 1, 1, device=CPU)


@pytest.mark.parametrize("n,splits,launches", [
    (0, 1, 0), (1000, 16, 2), (1024, 16, 2), (16384, 16, 2), (16385, 16, 2),
    (131072, 16, 2), (140000, 16, 2), (1_048_576, 2, 2),
    (1_048_577, 2, 2), (2_097_152, 1, 1)])
def test_b5_plan(n, splits, launches):
    """B5 splits the sources (a power of two, at most 16) until a call
    has 8,192 blocks of 256 targets; a split call adds a second launch
    that sums the partials in order. N = 2^21 (8,192 blocks) is the first
    that needs no split."""
    assert tp._b5_plan(n) == (splits, launches)



def test_plain_b6_returns_the_permutation():
    """B6's plain version returns idx as the stable sorting permutation in
    the positions form; constant keys keep the identity, and an explicit
    idx orders them."""
    rng = np.random.default_rng(11)
    key = rng.integers(-3, 3, 1024).astype(np.int32)
    val = rng.standard_normal(1024).astype(np.float32)
    sk, si, (sv,) = tsb.sort_kv_plain(torch.from_numpy(key), None,
                                      [torch.from_numpy(val)])
    order = np.argsort(key, kind="stable")
    assert np.array_equal(si.numpy(), order)
    assert np.array_equal(sk.numpy(), key[order])
    assert np.array_equal(sv.numpy().view(np.int32), val[order].view(np.int32))
    zeros = torch.zeros(256, dtype=torch.int32)
    _, si, _ = tsb.sort_kv_plain(zeros, None, [])
    assert np.array_equal(si.numpy(), np.arange(256))
    idx = rng.permutation(256).astype(np.int32) - 100
    _, si, _ = tsb.sort_kv_plain(zeros, torch.from_numpy(idx), [])
    assert np.array_equal(si.numpy(), np.sort(idx))
