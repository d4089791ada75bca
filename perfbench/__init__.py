"""The benchmark of rustexp_tpu_torch (BENCHMARK.json at the repository root).

run.py runs one cell once; harness.py is the window, the check and the
result line; spec.py finds a cell's configuration, traffic, entry and
per-layer metrics by name; reference/ is the plain renderer `correct` is
decided against; control.py puts it in the program's place at a lower
precision. It imports nothing of the JAX package.
"""
