"""rustexp_tpu_torch — the PyTorch/CUDA port of rustexp_tpu, for NVIDIA Hopper.

The JAX/XLA/Pallas package ``rustexp_tpu`` stays the reference that every
module here is held against (tests/test_torch_*.py). This package imports
torch and never jax; from the JAX package it reuses only the jax-free
numpy modules (assets.mesh, assets.hdr, assets.paths, raster.camera).

Ported so far: the rasterizer's flat-queue Fill frame (meshes of >= 1,000
triangles), end to end, with the queue raster as a hand-written CUDA
kernel for sm_90a (csrc/raster_queue.cu). ROADMAP.md lists the rest.

Layout mirrors the JAX package:
  core/      color packing, gamma, frame-time statistics
  assets/    cubemap sets (numpy)
  ops/       triangle setup, queue build, the B1 kernel wrapper
  raster/    frame pipeline, shaders
  sims/      the rasterizer experiment
  app/       the benchmark's per-scene row
  csrc/      CUDA C++ kernel sources, built at first use (runtime.py)
"""

__version__ = "0.1.0"
