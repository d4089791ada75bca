"""rustexp_tpu_torch — the PyTorch/CUDA port of rustexp_tpu, for NVIDIA Hopper.

The JAX/XLA/Pallas package ``rustexp_tpu`` stays the reference that every
module here is held against (tests/test_torch_*.py). This package imports
torch and never jax, and nothing of the JAX package: it keeps its own
copies of the numpy-only modules it needs (assets.mesh, assets.hdr,
assets.paths, assets.gol_patterns, raster.camera).

Ported so far: the rasterizer's Fill frame at the benchmark config, end
to end, and the 12-scene suite; the Game of Life and N-body experiments
and their benches. Every TPU kernel on those paths is hand-written CUDA
for sm_90a: the flat-queue and binned rasterizers (csrc/raster_queue.cu,
csrc/raster_bins.cu), SWAR GoL and the f32 GoL stencil (csrc/gol_swar.cu,
csrc/gol_stencil.cu), all-pairs N-body forces (csrc/nbody_forces.cu) and
the bitonic key-value sort (csrc/sort_bitonic.cu). ROADMAP.md lists the
rest.

Layout mirrors the JAX package:
  core/      color packing, gamma, frame-time statistics
  assets/    meshes, cubemap sets, asset paths, GoL patterns (numpy)
  ops/       triangle setup, queue build and bins, GoL stencils, N-body
             forces, Barnes-Hut and the sort; the kernel wrappers
  raster/    frame pipeline, shaders, camera paths
  sims/      the rasterizer, GoL and N-body experiments
  app/       the benchmarks: raster scenes and suite, GoL, N-body
  csrc/      CUDA C++ kernel sources, built at first use (runtime.py)
  interop.py the JAX package's scenes, queues, bins, grids and particles
"""

__version__ = "0.3.0"
