"""Multi-rank paths on torch.distributed (port of rustexp_tpu/parallel).

How a JAX mesh maps onto the port, everywhere in this package:

* Ranks. A JAX mesh axis of D devices is a torch.distributed group of D
  ranks, and ``lax.axis_index`` is the rank in that group. A jitted
  ``shard_map`` becomes a ``make_*`` function that returns a per-rank
  callable: each rank calls it on its own shard (rows of a grid, a slice
  of the particles, its band's queue), as every device runs the shard_map
  body on its block.
* Collectives (collectives.py). ``lax.all_gather(tiled=True)`` is
  ``all_gather_into_tensor``; ``pmin``/``pmax`` are ``all_reduce`` with
  MIN/MAX; ``lax.ppermute`` is ``collectives.permute(t, pairs, group)``,
  built from ``all_to_all_single`` with only the partner's split
  non-empty (gloo has no point-to-point for CUDA tensors; its collectives
  take them and stage them through the host).
* ``group=None`` runs one rank in this process with no collective.
* Axis tuples. A JAX axis tuple such as ``("dcn", "ici")`` is one
  combined row-major axis; here it is simply the group of all ranks, and
  there is no 2-D mesh.
* Backends. NCCL when every rank has a card of its own, gloo otherwise
  (ranks that share one card, and CPU ranks). Ranks start with the
  ``spawn`` method, each on card ``rank % device_count``, after the parent
  has built the kernel libraries (collectives.spawn_ranks).
"""
