"""rustexp_tpu_torch — the PyTorch/CUDA port of rustexp_tpu, for NVIDIA Hopper.

The JAX/XLA/Pallas package ``rustexp_tpu`` stays the reference that every
module here is held against (tests/test_torch_*.py). This package imports
torch and never jax, and nothing of the JAX package: it keeps its own
copies of the numpy-only modules it needs (assets.mesh, assets.hdr,
assets.paths, assets.gol_patterns, raster.camera).

Ported so far: the rasterizer's Fill frame at the benchmark config, end
to end, the 12-scene suite, the deferred queue frame, the G-buffer
oracle (backend "xla", any frame size) and the band renderer; the point
and line modes; the Game of Life, N-body and sine experiments and their
benches; and the app shell: the CLI (python -m rustexp_tpu_torch.app.cli),
the terminal viewer, the turntable and checkpoints; and the two
top-level surfaces: the one-line benchmark (python -m
rustexp_tpu_torch.bench, the root bench.py's counterpart) and the
flagship frame (graft_entry.entry, __graft_entry__.py's). Every TPU kernel has
its hand-written CUDA counterpart for sm_90a: the flat-queue rasterizer
and its depth race alone (csrc/raster_queue.cu), the binned rasterizer
and its G-buffer form (csrc/raster_bins.cu), SWAR GoL and the f32 GoL
stencil (csrc/gol_swar.cu, csrc/gol_stencil.cu), all-pairs N-body forces
(csrc/nbody_forces.cu) and the key-value sort, a stable radix sort in
place of JAX's bitonic network (csrc/sort_radix.cu). ROADMAP.md lists
the rest.

Layout mirrors the JAX package:
  core/      color packing, gamma, frame-time statistics, PNG and GIF
             output, the status font, checkpoints, tracing, the device
             probe and the Prewarmer
  assets/    meshes, cubemap sets, asset paths, GoL patterns (numpy)
  ops/       triangle setup, queue build and bins, GoL stencils, N-body
             forces, Barnes-Hut and the sort; the kernel wrappers
  raster/    frame pipeline, shaders, camera paths
  sims/      the Experiment protocol; the rasterizer, GoL, N-body and
             sine experiments
  parallel/  band-sharded G-buffer rendering on torch.distributed
  app/       the CLI, the terminal viewer, the turntable, and the
             benchmarks: raster scenes and suite, GoL, N-body
  csrc/      CUDA C++ kernel sources, built at first use (runtime.py)
  interop.py the JAX package's scenes, queues, bins, grids and particles
  bench.py   the headline benchmark's one JSON line
  graft_entry.py  the flagship frame and the multi-rank dry run
"""

__version__ = "0.5.0"
