"""The benchmark of rustexp_tpu_torch (BENCHMARK.json at the repository root).

run.py runs one cell once; harness.py is the window and the result
line; spec.py finds a cell's configuration, its check, traffic, entry and
per-layer metrics by name; checks/ holds each configuration's comparison
that decides `correct`, against the plain references in reference/;
control.py puts the raster reference in the program's place at a lower
precision. It imports nothing of the JAX package.
"""
