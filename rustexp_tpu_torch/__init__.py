"""rustexp_tpu_torch — the PyTorch/CUDA port of rustexp_tpu, for NVIDIA Hopper.

The JAX/XLA/Pallas package ``rustexp_tpu`` stays the reference that every
module here is held against (tests/test_torch_*.py). This package imports
torch and never jax, and nothing of the JAX package: it keeps its own
copies of the numpy-only modules it needs (assets.mesh, assets.hdr,
assets.paths, raster.camera).

Ported so far: the rasterizer's Fill frame at the benchmark config, end
to end, through both of its raster kernels as hand-written CUDA for
sm_90a: the flat queue (meshes of >= 1,000 triangles,
csrc/raster_queue.cu) and the [nT, cap] bins (smaller meshes and
``render_frame(backend="pallas"/"auto")``, csrc/raster_bins.cu), and the
12-scene suite. ROADMAP.md lists the rest.

Layout mirrors the JAX package:
  core/      color packing, gamma, frame-time statistics
  assets/    meshes, cubemap sets, asset paths (numpy)
  ops/       triangle setup, queue build and bins, the kernel wrappers
  raster/    frame pipeline, shaders, camera paths
  sims/      the rasterizer experiment
  app/       the benchmark: per-scene rows and the 12-scene suite
  csrc/      CUDA C++ kernel sources, built at first use (runtime.py)
"""

__version__ = "0.2.0"
