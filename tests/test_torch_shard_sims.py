"""PyTorch port vs the JAX package: the sharded GoL, sort and N-body paths
(ROADMAP A16).

In this process: merge_kv on the CPU against JAX's merge network
(interpret mode) on bitonic (key, idx) sequences, the hypercube stage
table, and the one-rank forms (group=None) of every path with JAX's
refusals. Then one spawn of 4 gloo ranks and one of 3 (the odd-even
sort schedule) run tests/torch_shard_ranks.sims: GoL in its "roll",
"pallas" and "bits" bodies against JAX's make_multi_step on a mesh of as
many devices, bit for bit; dist_sort_stable on heavy ties at a
power-of-two chunk (the sort_bitonic route) and another (the lexsort
route), bit for bit, gidx included; make_step_bh with the distributed
and the replicated sort over two steps, bit for bit against the port's
one-rank step_bh and within 1e-5 of JAX's (the port's BH tolerance,
tests/test_torch_nbody.py); the brute step within JAX's own 2e-4
(tests/test_parallel.py:58).

Grids and keys are made with numpy from a seed; the BH particles are
JAX's stable_orbits carried across as numpy, as the N-body tests do.
Wall time on the test machine: about 70 s alone.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from rustexp_tpu.ops import nbody_bh as jbh
from rustexp_tpu.ops import nbody_forces as jf
from rustexp_tpu.ops import sort_bitonic as jsb
from rustexp_tpu.parallel import gol_shard as jgol
from rustexp_tpu.sims import nbody as jn
from rustexp_tpu_torch.ops import gol_stencil as tgs
from rustexp_tpu_torch.ops import nbody_bh as tbh
from rustexp_tpu_torch.ops import nbody_forces as tf
from rustexp_tpu_torch.ops import sort_bitonic as tsb
from rustexp_tpu_torch.parallel import collectives as coll
from rustexp_tpu_torch.parallel import gol_shard, nbody_shard, sort_shard

import torch_shard_ranks

CPU = torch.device("cpu")
GOL = (("roll", 5), ("pallas", 8), ("bits", 16))
BLOCK, K_NEAR, BH_STEPS = 128, 6, 2
BRUTE_TOL = 2e-4  # tests/test_parallel.py:58
BH_TOL = 1e-5     # tests/test_torch_nbody.py::test_step_bh_matches_jax


def _mesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), axis_names=(axis,))


def _bitonic(n, seed):
    """A (key, idx)-bitonic sequence with heavy key ties and distinct idx:
    one half of Batcher's split of two sorted runs, as the distributed
    sort's stages give merge_kv."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-20, 20, 2 * n).astype(np.int32)
    idx = rng.permutation(2 * n).astype(np.int32)
    order = np.lexsort((idx, key))
    a, b = order[:n], order[n:][::-1]   # A ascending, B reversed
    mine = (key[a] < key[b]) | ((key[a] == key[b]) & (idx[a] < idx[b]))
    pick = np.where(mine, a, b)
    return key[pick], idx[pick], rng.standard_normal(2 * n).astype(
        np.float32)[pick]


@pytest.mark.parametrize("n", [256, 4096])
def test_merge_kv_matches_jax(n):
    key, idx, val = _bitonic(n, n)
    want = jsb.merge_kv(jnp.asarray(key), jnp.asarray(idx),
                        [jnp.asarray(val)], interpret=True)
    got = tsb.merge_kv(torch.from_numpy(key), torch.from_numpy(idx),
                       [torch.from_numpy(val)])
    for a, b in zip((want[0], want[1], want[2][0]),
                    (got[0], got[1], got[2][0])):
        assert np.array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="power of two"):
        tsb.merge_kv(torch.from_numpy(key[:200]), torch.from_numpy(idx[:200]),
                     [])


@pytest.mark.parametrize("n", [1, 2, 4, 8, 1024])
def test_substage_table_matches_jax(n):
    assert tsb._substage_table(n) == jsb._substage_table(n)


def test_one_rank_paths():
    """group=None: the GoL bodies equal step_roll, the sort a stable
    argsort, the BH steps step_bh and the brute step the one-rank brute
    step, bit for bit; shard_* return the whole arrays."""
    rng = np.random.default_rng(11)
    g = torch.from_numpy((rng.random((64, 64)) < 0.3).astype(np.int32))
    want = g
    for _ in range(16):
        want = tgs.step_roll(want)
    for backend in ("roll", "pallas", "bits"):
        step = gol_shard.make_multi_step(None, k=16, backend=backend)
        assert torch.equal(step(gol_shard.shard_grid(g)), want), backend
    key = torch.from_numpy(rng.integers(0, 9, 512).astype(np.int32))
    val = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    sk, sg, (sv,) = sort_shard.dist_sort_stable(key, [val], None)
    order = torch.from_numpy(np.argsort(key.numpy(), kind="stable"))
    assert torch.equal(sk, key[order]) and torch.equal(sv, val[order])
    assert torch.equal(sg, order.to(torch.int32))
    ics = [torch.from_numpy(a) for a in _orbits(5, 2048)]
    want = tbh.step_bh(*ics, BLOCK, K_NEAR, 0.01)
    for ds in (True, False):
        step = nbody_shard.make_step_bh(None, BLOCK, K_NEAR, ds)
        got = step(*nbody_shard.shard_particles(ics), 0.01)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), ds
    got = nbody_shard.make_step(None)(*ics[:5], 0.01)
    want = tf.step_brute_force(*ics, dt=0.01)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], want))


def test_refusals_match_jax():
    """JAX's errors: an unknown GoL body, k past the shard's rows, rows
    not whole 32-row words, N not a multiple of the block, and a
    permutation naming a rank twice."""
    g = torch.zeros((48, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="not one of"):
        gol_shard.make_multi_step(None, k=2, backend="mxu")
    with pytest.raises(ValueError, match="exceeds shard rows"):
        gol_shard.make_multi_step(None, k=64, backend="pallas")(g)
    with pytest.raises(ValueError, match="multiple of 32"):
        gol_shard.make_multi_step(None, k=4, backend="bits")(g)
    with pytest.raises(ValueError, match="exceeds shard rows"):
        gol_shard.make_multi_step(None, k=40, backend="bits")(
            torch.zeros((32, 64), dtype=torch.int32))
    ics = [torch.from_numpy(a) for a in _orbits(5, 1000)]
    with pytest.raises(ValueError, match="not divisible by block"):
        nbody_shard.make_step_bh(None, block=256)(*ics, 0.01)
    with pytest.raises(ValueError, match="twice"):
        coll.permute(g, [(0, 0), (0, 1)], None)


@functools.cache
def _orbits(seed, n):
    return tuple(np.array(a) for a in jn.stable_orbits(
        jax.random.PRNGKey(seed), n))


def _inputs(n_dev):
    rng = np.random.default_rng(100 + n_dev)
    inp = {"grid": (rng.random((32 * n_dev, 64)) < 0.35).astype(np.int32),
           "gol": GOL, "block": BLOCK, "k_near": K_NEAR,
           "bh_steps": BH_STEPS}
    inp["sort_pow2"] = [rng.integers(0, 30, 256 * n_dev).astype(np.int32),
                        rng.standard_normal(256 * n_dev).astype(np.float32),
                        rng.integers(-9, 9, 256 * n_dev).astype(np.int32)]
    inp["sort_odd"] = [rng.integers(0, 7, 96 * n_dev).astype(np.int32),
                       rng.standard_normal(96 * n_dev).astype(np.float32)]
    inp["bh"] = list(_orbits(n_dev, 1024 * n_dev))
    inp["brute"] = [a[:64 * n_dev].copy() for a in _orbits(n_dev, 512)]
    return inp


def _cat(res, key, i=None):
    return np.concatenate([r[key] if i is None else r[key][i] for r in res])


@pytest.mark.parametrize("n_dev", [4, 3])
def test_sharded_sims_over_gloo_ranks(n_dev):
    """n_dev spawned gloo ranks: GoL, the distributed sort, BH and brute
    force, each rank's shard concatenated in rank order."""
    inp = _inputs(n_dev)
    res = coll.spawn_ranks(torch_shard_ranks.sims, n_dev, CPU, args=(inp,),
                           timeout=300)

    grid = jnp.asarray(inp["grid"])
    mesh = _mesh(n_dev, "rows")
    for backend, k in GOL:
        want = jgol.make_multi_step(mesh, k=k, backend=backend)(
            jgol.shard_grid(grid, mesh))
        assert np.array_equal(_cat(res, f"gol_{backend}"), np.asarray(want))

    for name in ("sort_pow2", "sort_odd"):
        key, *vals = inp[name]
        order = np.argsort(key, kind="stable")
        assert np.array_equal(_cat(res, name, 0), key[order])
        assert np.array_equal(_cat(res, name, 1), order)
        for i, v in enumerate(vals):
            assert np.array_equal(_cat(res, name, 2 + i), v[order])

    ref_t = [torch.from_numpy(a) for a in inp["bh"]]
    ref_j = [jnp.asarray(a) for a in inp["bh"]]
    for i in range(BH_STEPS):
        ref_t = tbh.step_bh(*ref_t, BLOCK, K_NEAR, 0.01)
        ref_j = jbh.step_bh(*ref_j, BLOCK, K_NEAR, 0.01)
        for ds in (True, False):
            got = [_cat(res, f"bh_{ds}_{i}", j) for j in range(5)]
            for a, b in zip(got, ref_t):
                assert np.array_equal(a, b.numpy()), (i, ds)
            assert np.array_equal(got[4], np.asarray(ref_j[4]))
            for a, b in zip(got[:4], ref_j[:4]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=BH_TOL,
                                           atol=BH_TOL)

    want = jf.step_brute_force(*[jnp.asarray(a) for a in inp["brute"]], 0,
                               0.01)
    got = [_cat(res, "brute", j) for j in range(5)]
    for a, b in zip(got[:4], want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=BRUTE_TOL,
                                   atol=BRUTE_TOL)
    assert np.array_equal(got[4], inp["brute"][4])
