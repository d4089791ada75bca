"""Asset root discovery.

The port's own copy of rustexp_tpu/assets/paths.py. The engine consumes
the reference's on-disk data assets (ASCII meshes, Radiance-HDR
irradiance cubemaps) when available, but does not vendor them: set
``RUSTEXP_TPU_ASSETS`` to a directory containing ``meshes/`` and
``envmaps/`` subdirectories, or put them in ``assets/`` at the repository
root. When no asset root is found, procedural fallbacks (see mesh.py /
cubemap.py) keep the engine fully functional standalone.
"""

from __future__ import annotations

import os

_SEARCH_PATH = (
    os.environ.get("RUSTEXP_TPU_ASSETS", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets"),
)


def asset_root() -> str | None:
    """First directory on the search path holding a meshes/ or envmaps/ dir."""
    for root in _SEARCH_PATH:
        if not root:
            continue
        root = os.path.abspath(root)
        if os.path.isdir(os.path.join(root, "meshes")) or os.path.isdir(
            os.path.join(root, "envmaps")
        ):
            return root
    return None


def mesh_dir() -> str | None:
    root = asset_root()
    if root is None:
        return None
    d = os.path.join(root, "meshes")
    return d if os.path.isdir(d) else None


def envmap_dir() -> str | None:
    root = asset_root()
    if root is None:
        return None
    d = os.path.join(root, "envmaps")
    return d if os.path.isdir(d) else None
