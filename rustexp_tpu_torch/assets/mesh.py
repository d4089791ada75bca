"""ASCII ``.dat`` mesh loading, procedural fallbacks, and the mesh registry.

The port's own copy of rustexp_tpu/assets/mesh.py, numpy only, without
that module's optional native C++ tokenizer (the numpy tokenizer below
gives the same arrays). File format (reference:
rs-src/rasterizer.rs:150-348): comment lines start with ``#``; then a
vertex count, that many vertex lines, an index count, and
``index_count/3`` triangle lines. Three vertex layouts exist
(rasterizer.rs:151):

  * ``XyzNxNyNz``     — 6 floats, white default color
  * ``XyzNxNyNzRGB``  — 9 floats (color is baked AO / radiosity)
  * ``XyzRGB``        — 6 floats, normals derived from face normals
                        (last-writing triangle wins per shared vertex,
                        rasterizer.rs:317-337)

The registry pairs each of the 12 meshes with a camera animation exactly as
the reference does (rasterizer.rs:393-407). Meshes load lazily and are cached.
When the asset root is missing a file, a procedural stand-in (unit cube /
UV sphere / torus knot) is generated so the engine runs standalone.

Unlike the reference's array-of-structs ``Vec<Vertex>``, vertex data is kept
as structure-of-arrays numpy blocks — the layout XLA wants for batched
matmul transforms.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import paths

XYZ_N = "XyzNxNyNz"
XYZ_N_RGB = "XyzNxNyNzRGB"
XYZ_RGB = "XyzRGB"


@dataclass
class MeshData:
    """Structure-of-arrays indexed triangle mesh."""

    positions: np.ndarray  # f32 [V, 3]
    normals: np.ndarray    # f32 [V, 3]
    colors: np.ndarray     # f32 [V, 3]
    tris: np.ndarray       # i32 [T, 3]
    name: str = ""
    aabb_min: np.ndarray = field(default=None)  # type: ignore[assignment]
    aabb_max: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.aabb_min is None:
            self.aabb_min = self.positions.min(axis=0)
            self.aabb_max = self.positions.max(axis=0)

    @property
    def num_tris(self) -> int:
        return int(self.tris.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    def normalize_dimensions(self) -> np.ndarray:
        """4x4 matrix moving the mesh into an origin-centered unit cube.

        Reference: Mesh::normalize_dimensions, rasterizer.rs:131-146 —
        translate AABB center to origin, uniform-scale by 1/max-extent.
        """
        center = (self.aabb_min + self.aabb_max) * np.float32(0.5)
        extent = self.aabb_max - self.aabb_min
        s = np.float32(1.0) / np.float32(max(extent[0], max(extent[1], extent[2])))
        m = np.array(
            [
                [s, 0, 0, -center[0] * s],
                [0, s, 0, -center[1] * s],
                [0, 0, s, -center[2] * s],
                [0, 0, 0, 1],
            ],
            dtype=np.float32,
        )
        return m


def _face_normals_last_wins(pos: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Per-vertex normals from face normals, later triangles overwriting.

    Matches the XyzRGB path of the reference loader (rasterizer.rs:317-337),
    which assigns each face's normal to all three vertices in file order
    with no sharing/averaging.
    """
    v0, v1, v2 = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)
    normals = np.zeros_like(pos)
    # Last write wins: iterate in order via np-assignment per column
    # (vectorized assignment applies later rows last for duplicate indices
    # only with explicit ordering, so use a loop over triangles' columns
    # through np.add-like indexed store which keeps the final duplicate).
    idx = tris.reshape(-1)
    rep = np.repeat(fn, 3, axis=0)
    normals[idx] = rep  # numpy keeps the LAST duplicate for fancy-index store
    return normals.astype(np.float32)


def _parse_tokens_py(text: str, ncomp: int, name: str):
    """Whitespace tokenizer; ``#`` lines are comments."""
    tokens: list[str] = []
    for line in text.splitlines():
        s = line.strip()
        if not s or s.split(" ", 1)[0] == "#":
            continue
        tokens.extend(s.split())
    arr = np.array(tokens, dtype=np.float64)

    vtx_cnt = int(arr[0])
    if vtx_cnt < 3:
        raise ValueError(f"{name}: bogus vertex count {vtx_cnt}")
    vdata = arr[1 : 1 + vtx_cnt * ncomp].reshape(vtx_cnt, ncomp).astype(np.float32)
    off = 1 + vtx_cnt * ncomp
    idx_cnt = int(arr[off])
    if idx_cnt % 3 != 0:
        raise ValueError(f"{name}: bogus index count {idx_cnt}")
    indices = arr[off + 1 : off + 1 + idx_cnt].astype(np.int32)
    return vdata, indices


def parse_mesh_text(text: str, fmt: str, name: str = "") -> MeshData:
    """Parse the ASCII mesh format into a MeshData."""
    ncomp = 9 if fmt == XYZ_N_RGB else 6
    vdata, indices = _parse_tokens_py(text, ncomp, name)
    vtx_cnt = vdata.shape[0]
    if vtx_cnt < 3:
        raise ValueError(f"{name}: bogus vertex count {vtx_cnt}")
    if indices.shape[0] % 3 != 0:
        raise ValueError(f"{name}: bogus index count {indices.shape[0]}")
    tris = indices.reshape(-1, 3)
    if tris.size and (tris.min() < 0 or tris.max() >= vtx_cnt):
        raise ValueError(f"{name}: out-of-bounds vertex index")

    pos = vdata[:, 0:3]
    if fmt == XYZ_N:
        nrm = vdata[:, 3:6]
        col = np.ones_like(pos)
    elif fmt == XYZ_N_RGB:
        nrm = vdata[:, 3:6]
        col = vdata[:, 6:9]
    elif fmt == XYZ_RGB:
        col = vdata[:, 3:6]
        nrm = _face_normals_last_wins(pos, tris)
    else:
        raise ValueError(f"unknown mesh format {fmt!r}")
    return MeshData(pos, nrm, col, tris, name=name)


def load_mesh(path: str, fmt: str, name: str = "") -> MeshData:
    with open(path, "r") as f:
        return parse_mesh_text(f.read(), fmt, name=name or os.path.basename(path))


# ---------------------------------------------------------------------------
# Procedural fallbacks (standalone mode, and handy test fixtures)
# ---------------------------------------------------------------------------


def make_cube() -> MeshData:
    """Unit cube, 12 triangles, per-face normals, white."""
    faces = []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            n = np.zeros(3, dtype=np.float32)
            n[axis] = sgn
            u = np.zeros(3, dtype=np.float32)
            v = np.zeros(3, dtype=np.float32)
            u[(axis + 1) % 3] = 1.0
            v[(axis + 2) % 3] = 1.0
            if sgn < 0:
                u, v = v, u
            c = n * 0.5
            faces.append((c - 0.5 * u - 0.5 * v, c + 0.5 * u - 0.5 * v,
                          c + 0.5 * u + 0.5 * v, c - 0.5 * u + 0.5 * v, n))
    pos, nrm, tris = [], [], []
    for i, (a, b, c_, d, n) in enumerate(faces):
        base = 4 * i
        pos += [a, b, c_, d]
        nrm += [n] * 4
        tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    pos = np.asarray(pos, dtype=np.float32)
    return MeshData(pos, np.asarray(nrm, dtype=np.float32),
                    np.ones_like(pos), np.asarray(tris, dtype=np.int32),
                    name="ProceduralCube")


def make_sphere(n_lat: int = 24, n_lon: int = 48) -> MeshData:
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    xyz = np.stack(
        [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            tris += [[a, c, b], [b, c, d]]
    return MeshData(xyz, xyz.copy(), np.ones_like(xyz),
                    np.asarray(tris, dtype=np.int32), name="ProceduralSphere")


def make_torus_knot(p: int = 2, q: int = 3, n_seg: int = 256, n_ring: int = 16,
                    radius: float = 0.35) -> MeshData:
    t = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    r = 2.0 + np.cos(q * t)
    center = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], -1)
    d = np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    b1 = np.cross(d, up)
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2 = np.cross(d, b1)
    ang = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    pos = (center[:, None, :]
           + radius * (np.cos(ang)[None, :, None] * b1[:, None, :]
                       + np.sin(ang)[None, :, None] * b2[:, None, :]))
    nrm = (np.cos(ang)[None, :, None] * b1[:, None, :]
           + np.sin(ang)[None, :, None] * b2[:, None, :])
    pos = pos.reshape(-1, 3).astype(np.float32)
    nrm = nrm.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n_seg):
        for j in range(n_ring):
            a = i * n_ring + j
            b = i * n_ring + (j + 1) % n_ring
            c = ((i + 1) % n_seg) * n_ring + j
            dd = ((i + 1) % n_seg) * n_ring + (j + 1) % n_ring
            tris += [[a, b, c], [b, dd, c]]
    return MeshData(pos, nrm, np.ones_like(pos),
                    np.asarray(tris, dtype=np.int32), name="ProceduralTorusKnot")


_PROCEDURAL = {
    "Cube": make_cube,
    "Sphere": make_sphere,
    "TorusKnot": make_torus_knot,
}


# ---------------------------------------------------------------------------
# Registry: the reference's 12 meshes, each with its camera animation
# (rasterizer.rs:393-407). Camera names resolve in raster/camera.py.
# ---------------------------------------------------------------------------

MESH_TABLE = (
    # (name, camera, file, format)
    ("Killeroo", "orbit_front", "killeroo_ao.dat", XYZ_N_RGB),
    ("Head", "orbit_closer", "head_ao.dat", XYZ_N_RGB),
    ("Mitsuba", "pan_front", "mitsuba_ao.dat", XYZ_N_RGB),
    ("Cat", "orbit_closer", "cat_ao.dat", XYZ_N_RGB),
    ("Hand", "orbit_closer", "hand_ao.dat", XYZ_N_RGB),
    ("Teapot", "orbit_closer", "teapot.dat", XYZ_N),
    ("TorusKnot", "orbit", "torus_knot.dat", XYZ_N),
    ("Dwarf", "orbit_front", "dwarf.dat", XYZ_N_RGB),
    ("Blob", "orbit", "blob.dat", XYZ_N),
    ("Cube", "orbit", "cube.dat", XYZ_N_RGB),
    ("Sphere", "orbit", "sphere.dat", XYZ_N),
    ("CornellBox", "pan_back", "cornell_radiosity.dat", XYZ_RGB),
)

NUM_MESHES = len(MESH_TABLE)

_cache: dict[int, MeshData] = {}


def mesh_name(idx: int) -> str:
    return MESH_TABLE[idx][0]


def mesh_camera(idx: int) -> str:
    return MESH_TABLE[idx][1]


def get_mesh(idx: int) -> MeshData:
    """Lazily load (and cache) mesh #idx, falling back to procedural stand-ins."""
    if idx in _cache:
        return _cache[idx]
    name, _cam, fname, fmt = MESH_TABLE[idx]
    mdir = paths.mesh_dir()
    mesh = None
    if mdir is not None:
        p = os.path.join(mdir, fname)
        if os.path.isfile(p):
            mesh = load_mesh(p, fmt, name=name)
    if mesh is None:
        maker = _PROCEDURAL.get(name, make_sphere)
        mesh = maker()
        mesh.name = name + " (procedural)"
    _cache[idx] = mesh
    return mesh
