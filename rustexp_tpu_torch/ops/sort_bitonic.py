"""Key-value sort: kernel B6, a stable radix sort, and its plain version.

Port of sort_kv in rustexp_tpu/ops/sort_bitonic.py, whose Pallas kernel
is a bitonic network; the module keeps that name, the JAX counterpart's.
The sort key is the lexicographic pair (key, idx), idx defaulting to the
positions, so the result equals a stable argsort of the key applied to
every array, bit for bit. The payloads (f32 or int32 [n], up to 8) are
carried with the keys. n must be a power of two >= 256, as for the JAX
network.

Kernel B6 (csrc/sort_radix.cu, replacing ``_make_kernel`` and
``_make_kernel_loop``) is a stable LSD radix sort, 8 bits a pass, that
carries one permutation and gathers the payloads once; it runs for CUDA
tensors. sort_kv_plain, a stable torch.sort of (key, idx) and gathers, is
its plain version and serves CPU tensors. The same sort and gathers are
the kernel's library yardstick on the card. merge_kv, the merge step of
the distributed sort (parallel/sort_shard.py), is the same sort with the
explicit idx: JAX's merge network sorts a bitonic input in log n stages,
and B6 sorts any input, so the result is the same function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import load_kernel_lib, ptr, stream_ptr

MAX_VALUES = 8  # payload arrays the kernel carries


def _check(key: torch.Tensor, idx: torch.Tensor, values) -> int:
    n = key.shape[0]
    if n < 256 or n & (n - 1):
        raise ValueError(f"n={n} not a power of two >= 256")
    if len(values) > MAX_VALUES:
        raise ValueError(f"{len(values)} payloads; at most {MAX_VALUES}")
    for name, t in (("key", key), ("idx", idx)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name}: need int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for v in values:
        if v.dtype not in (torch.float32, torch.int32) or v.shape != (n,):
            raise ValueError(f"payload: need f32 or int32 [{n}], got "
                             f"{v.dtype} {tuple(v.shape)}")
    return n


def sort_kv_plain(key, idx, values):
    """Plain PyTorch version of kernel B6 -> (key, idx, values) sorted by
    (key, idx), idx None meaning the positions: a stable sort by idx, then
    a stable sort by key, and one gather per array."""
    if idx is None:
        idx = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    order = torch.sort(idx, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    return key[order], idx[order], [v[order] for v in values]


@functools.cache
def _b6_kernel():
    lib = load_kernel_lib("sort_radix")
    fn = lib.lib.rs_sort
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    lib.lib.rs_counts_words.restype = ctypes.c_int
    lib.lib.rs_counts_words.argtypes = [ctypes.c_int]
    return lib, fn


def sort_kv_cuda(key, idx, values):
    """Launch kernel B6 (csrc/sort_radix.cu) -> (key, idx, values) sorted
    by (key, idx), for contiguous CUDA tensors. idx None is the positions
    (4 radix passes, 12 grid launches; the returned idx is then the
    permutation); an explicit idx, which must be distinct for the order to
    be unique, adds 4 passes on it first (24 launches).
    ``sort_kv_cuda.launches`` counts the grid launches.
    """
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"kernel B6 runs on CUDA tensors, got {dev}")
    n = _check(key, key if idx is None else idx, values)
    arrays = (key, *values) if idx is None else (key, idx, *values)
    for t in arrays:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"kernel B6 needs contiguous tensors on {dev}")
    lib, fn = _b6_kernel()
    key_out = torch.empty_like(key)
    idx_out = torch.empty_like(key)
    outs = [torch.empty_like(v) for v in values]
    words = torch.empty(2 * n, dtype=torch.int32, device=dev)
    perm = torch.empty(2 * n, dtype=torch.int32, device=dev)
    counts = torch.empty(lib.lib.rs_counts_words(n), dtype=torch.int32,
                         device=dev)
    nv = len(values)
    vals_in = (ctypes.c_void_p * max(nv, 1))(*[v.data_ptr() for v in values])
    vals_out = (ctypes.c_void_p * max(nv, 1))(*[o.data_ptr() for o in outs])
    launched = ctypes.c_int(0)
    rc = fn(ptr(key), None if idx is None else ptr(idx), vals_in,
            ptr(key_out), ptr(idx_out), vals_out, nv, n, ptr(words),
            ptr(perm), ptr(counts), stream_ptr(dev), ctypes.byref(launched))
    sort_kv_cuda.launches += launched.value
    lib.check(rc, "kernel B6 (rs_sort)")
    return key_out, idx_out, outs


sort_kv_cuda.launches = 0


def sort_kv(key, values, idx=None):
    """Stable sort of int32 `key` carrying `values` (list of f32/int32
    [n]) -> (sorted_key, sorted_values). `idx` (int32 [n], distinct)
    replaces the positions as the tiebreak. CUDA tensors launch kernel
    B6, CPU tensors take its plain version (merge_kv)."""
    skey, _, svals = merge_kv(key, idx, values)
    return skey, svals


def _substage_table(n: int) -> tuple[list[int], list[int]]:
    """(j, k) per compare-exchange substage of the n-element bitonic
    network (a copy of rustexp_tpu/ops/sort_bitonic.py:81); the
    distributed sort's hypercube schedule over n ranks."""
    js, ks = [], []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            js.append(j)
            ks.append(k)
            j //= 2
        k *= 2
    return js, ks


def merge_kv(key, idx, values):
    """Sort by (key, idx), carrying `values` -> (key, idx, values): the
    merge of a (key, idx)-bitonic sequence
    (rustexp_tpu/ops/sort_bitonic.py:261), and any other input too. An
    explicit idx must be distinct; None means the positions. CUDA tensors
    launch kernel B6 (24 grid launches with an explicit idx), CPU tensors
    take sort_kv_plain."""
    _check(key, key if idx is None else idx, values)
    if key.device.type == "cuda":
        return sort_kv_cuda(key.contiguous(),
                            None if idx is None else idx.contiguous(),
                            [v.contiguous() for v in values])
    if key.device.type == "cpu":
        return sort_kv_plain(key, idx, values)
    raise ValueError(f"no sort for device {key.device}")
