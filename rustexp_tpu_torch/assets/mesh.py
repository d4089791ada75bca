"""Meshes: rustexp_tpu/assets/mesh.py, re-exported.

That module is numpy-only (no jax), so the port reuses it rather than
copying it; importing it from here keeps the port's callers on one
package. Without the reference assets, get_mesh returns procedural
stand-ins (rustexp_tpu/assets/mesh.py:298-312).
"""

from rustexp_tpu.assets.mesh import (  # noqa: F401
    MESH_TABLE, NUM_MESHES, MeshData, get_mesh, make_cube, make_sphere,
    make_torus_knot, mesh_camera, mesh_name,
)
