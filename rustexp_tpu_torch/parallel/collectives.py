"""The collectives of the JAX mesh code on torch.distributed, and ranks.

``group=None`` everywhere means one rank in this process: a gather or a
reduction returns its input and a permutation maps the rank onto itself.
Every collective here takes tensors on the ranks' own device; gloo
stages CUDA tensors through the host itself, so nothing is copied here.

spawn_ranks starts D ranks as the CLI's ``--devices D`` does: spawned
processes on one FileStore, each initialising its group (backend_for)
and setting its card before it runs the given function.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# The seven kernel libraries of csrc/, built by the parent before it spawns
# ranks (D children would otherwise run nvcc on the same sources at once)
KERNEL_LIBS = ("raster_queue", "raster_bins", "raster_shade", "gol_swar",
               "gol_stencil", "nbody_forces", "sort_radix")


def world(group) -> tuple[int, int]:
    """(size, rank) of `group`; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather(t, axis, tiled=True)``: every rank's `t`
    concatenated along dim 0 in rank order (all_gather_into_tensor)."""
    n, _ = world(group)
    if n == 1:
        return t
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is None:
        return t
    out = t.clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over the ranks."""
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def pmin(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmin``: the elementwise minimum over the ranks."""
    return _all_reduce(t, dist.ReduceOp.MIN, group)


def any_ranks(flag: torch.Tensor, group) -> torch.Tensor:
    """bool []: True when `flag` is True on any rank (pmax of int32)."""
    return pmax(flag.to(torch.int32).reshape(1), group)[0] > 0


def permute(t: torch.Tensor, pairs, group) -> torch.Tensor:
    """``lax.ppermute(t, axis, pairs)``: `pairs` lists (source, dest) ranks,
    each rank at most once as a source and once as a destination. A rank
    receives its source's `t` (same shape), or zeros when no pair names it
    as a destination.

    One ``all_to_all_single`` in which only the destination's split is
    non-empty: gloo's point-to-point send/recv takes CPU tensors only,
    its collectives take CUDA tensors too.
    """
    n, rank = world(group)
    dst = [d for s, d in pairs if s == rank]
    src = [s for s, d in pairs if d == rank]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"rank {rank} appears twice in {pairs}")
    if n == 1:
        return t if dst == [0] else torch.zeros_like(t)
    t = t.contiguous()
    rows = t.shape[0]
    out = torch.empty_like(t) if src else t.new_empty((0,) + t.shape[1:])
    dist.all_to_all_single(
        out, t, output_split_sizes=[rows if r in src else 0
                                    for r in range(n)],
        input_split_sizes=[rows if r in dst else 0 for r in range(n)],
        group=group)
    return out if src else torch.zeros_like(t)


def shard_rows(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous block of dim 0 (``P(axis)``'s block)."""
    n, rank = world(group)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not shard over {n} ranks")
    r = t.shape[0] // n
    return t[rank * r:(rank + 1) * r]


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def backend_for(device: torch.device, n_ranks: int) -> str:
    """NCCL when every rank has a card of its own; gloo when ranks share a
    card (NCCL refuses two ranks on one) and for CPU ranks."""
    if device.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank `rank`'s device: card rank % device_count, made current."""
    if device.type != "cuda":
        return device
    idx = rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def _rank_main(rank, n, store_path, device_type, backend, fn, args, conn):
    """A spawned rank: join the group, run fn(group, device, *args), send
    ("ok", result) or ("error", traceback) to the parent."""
    try:
        dev = rank_device(torch.device(device_type), rank)
        store = dist.FileStore(store_path, n)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n, **kw)
        try:
            result = fn(dist.group.WORLD, dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        conn.send(("ok", result))
    except SystemExit as e:  # a refusal: its message, not a traceback
        conn.send(("exit", str(e.code)))
        raise SystemExit(1) from None
    except Exception:
        conn.send(("error", traceback.format_exc()))
        raise SystemExit(1) from None
    finally:
        conn.close()


def spawn_ranks(fn, n: int, device: torch.device, args=(),
                timeout: float = 600.0) -> list:
    """Run fn(group, device, *args) on n spawned ranks -> their results in
    rank order.

    `fn` must be importable by name (a module-level function) and its
    result picklable. On a card the parent first builds the kernel
    libraries. Every rank must finish within `timeout` seconds; if one
    fails or hangs, every rank is killed and the call raises with the
    failed rank's traceback, or exits with its message when the rank
    raised SystemExit (a refused configuration).
    """
    device = torch.device(device)
    if device.type == "cuda":
        from ..runtime import load_kernel_lib

        for name in KERNEL_LIBS:
            load_kernel_lib(name)
    backend = backend_for(device, n)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs, conns = [], []
        for rank in range(n):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, args=(
                rank, n, os.path.join(tmp, "store"), device.type, backend,
                fn, tuple(args), send), daemon=True)
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        results, errors = [None] * n, {}
        deadline = time.monotonic() + timeout
        try:
            pending = dict(enumerate(conns))
            while pending:
                left = deadline - time.monotonic()
                ready = multiprocessing.connection.wait(
                    list(pending.values()), timeout=max(left, 0))
                if not ready:
                    raise RuntimeError(
                        f"{len(pending)} of {n} ranks did not finish within "
                        f"{timeout:.0f} s")
                for rank, c in list(pending.items()):
                    if c not in ready:
                        continue
                    del pending[rank]
                    try:
                        status, payload = c.recv()
                    except EOFError:
                        status, payload = "error", "exited without a result"
                    if status == "ok":
                        results[rank] = payload
                    else:
                        errors[rank] = (status, payload)
                if errors:
                    break
        finally:
            for p in procs:
                if errors or p.is_alive() and time.monotonic() > deadline:
                    p.kill()
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
                if p.is_alive():
                    p.kill()
                    p.join()
            for c in conns:
                c.close()
        if errors:
            rank = min(errors)
            status, payload = errors[rank]
            if status == "exit":
                raise SystemExit(payload)
            raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
        return results
