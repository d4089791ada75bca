"""A/B of kernels B7 and B1 (csrc/raster_queue.cu) on one card: several
builds of the source timed in turns, by device time, in one process.

    python3 tools/ab_raster_queue.py [TAG=FILE.cu ...] [--shapes=2x4,4x8]

Builds each TAG=FILE source given (an earlier version of the file, say,
written out with `git show REV:rustexp_tpu_torch/csrc/raster_queue.cu`),
the repository's csrc/raster_queue.cu (tag "repo"), and for each NWxRH of
--shapes the repository's source with NWARP = NW and RECT_H = RH, all with
the port's nvcc flags, concurrently, and prints each build's ptxas
registers and spills. A source whose rq_queue_zslot takes no hp (the
block-per-tile B7 before the redesign) gets its slot prefilled with -1, as
its wrapper did, and its kernel alone is timed too.

Cases: KillerooP, TorusKnotP and KillerooV at 512x512, KillerooP at
1024x1024 and 2048x2048 (the queue path's inputs, tick 0), the stress
queue (chip_smoke.stress_queue, (4, 0) form) and an empty 2048x2048 frame
(pad chunks only). For each case every build runs in turn, the order
reversed for a second turn (first, second, ..., second, first); each run
checks z and slot against the plain version on every word (the earlier
B7 wrote z only where a pair won: its z is checked there) and takes the
mean device ms of 30 calls over all the card's activity of a call
(chip_smoke.device_ms). B1 is timed the same way on the 512x512 scenes,
the stress queue and KillerooP 2048x2048, its z, slot and planes checked
on every word. Prints a line per run, then one SUMMARY line per case and
kernel, each with nvidia-smi's name and power limit. Needs a CUDA device
and nvcc; exits 1 without them, or when a build disagrees with the plain
version.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from rustexp_tpu_torch import runtime  # noqa: E402

REPS = 30
SIZES = {"KillerooP 512": (0, True, 512), "TorusKnotP 512": (6, True, 512),
         "KillerooV 512": (0, False, 512), "KillerooP 1024": (0, True, 1024),
         "KillerooP 2048": (0, True, 2048)}
B1_CASES = ("KillerooP 512", "TorusKnotP 512", "KillerooV 512",
            "stress queue", "KillerooP 2048")


def build(tag: str, src: str, out_dir: Path):
    """(ctypes library, old B7 entry?) of one source."""
    path = out_dir / f"{tag}.cu"
    path.write_text(src)
    lib = out_dir / f"lib{tag}.so"
    res = subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o",
                          str(lib), str(path)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stderr}")
    for line in cs.ptxas_summary(res.stderr):
        print(f"ptxas {tag} {line}", flush=True)
    old = re.search(r"int fch, int w, void\* stream", src) is not None
    return ctypes.CDLL(str(lib)), old


def reshaped(src: str, nw: int, rh: int) -> str:
    out = re.sub(r"constexpr int NWARP = \d+;", f"constexpr int NWARP = {nw};",
                 src)
    out = re.sub(r"constexpr int RECT_H = \d+;",
                 f"constexpr int RECT_H = {rh};", out)
    if out.count(f"NWARP = {nw};") != 1 or out.count(f"RECT_H = {rh};") != 1:
        raise ValueError("the source sets no NWARP or RECT_H constant")
    return out


def scene_inputs(dev, mesh_idx: int, per_pixel: bool, size: int):
    from rustexp_tpu_torch.assets import cubemap, mesh
    from rustexp_tpu_torch.ops import raster_queue as rq
    from rustexp_tpu_torch.raster import camera, pipeline as pp

    scene = pp.make_scene(mesh.get_mesh(mesh_idx), cubemap.get_cm_set(0), dev)
    eye = camera.camera_eye(mesh.mesh_camera(mesh_idx), 0.0)
    queue = pp.build_scene_queue(scene, eye, size, size, per_pixel=per_pixel)
    colors = None if per_pixel else pp.vertex_colors(scene, eye, 0.0, size,
                                                     size, 5)
    setup, extra, n2, n3 = pp.queue_attr_channels(scene, colors, eye, size,
                                                  size, per_pixel=per_pixel)
    rows_i, rows_f = rq.gather_rows(queue, rq.pack_table(setup, extra))
    return queue.scal, rows_i, rows_f, n2, n3, size, size


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from rustexp_tpu_torch.ops import raster_queue as rq

    shapes, sources = [], {}
    for arg in argv:
        if arg.startswith("--shapes="):
            shapes = [tuple(map(int, s.split("x")))
                      for s in arg.split("=", 1)[1].split(",")]
        else:
            tag, path = arg.split("=", 1)
            sources[tag] = Path(path).read_text()
    sources["repo"] = (runtime.CSRC_DIR / "raster_queue.cu").read_text()
    for nw, rh in shapes:
        sources[f"w{nw}r{rh}"] = reshaped(sources["repo"], nw, rh)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    P = runtime.ptr
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sources)) as ex:
            libs = dict(zip(sources, ex.map(
                lambda kv: build(kv[0], kv[1], Path(tmp)), sources.items())))
        print(f"built {len(libs)} sources in {time.perf_counter() - t0:.1f} "
              f"s [{card}]", flush=True)

        def b7(tag):
            lib, old = libs[tag]

            def run(scal, ri, rf, h, w):
                hp = h + rq.TILE_H
                z = torch.empty((hp, w), dtype=torch.float32, device=dev)
                s = (torch.full((hp, w), -1, dtype=torch.int32, device=dev)
                     if old else torch.empty((hp, w), dtype=torch.int32,
                                             device=dev))
                tail = (w,) if old else (hp, w)
                rc = lib.rq_queue_zslot(
                    P(scal), P(ri), P(rf), P(z), P(s), ri.shape[0], rq.CHUNK,
                    rq.TILE_H, rq.TILE_W, rf.shape[1], *tail,
                    runtime.stream_ptr(dev))
                if rc:
                    raise RuntimeError(f"{tag}: B7 launch failed ({rc})")
                return z, s
            return run, old

        def b1(tag):
            lib, _ = libs[tag]

            def run(scal, ri, rf, n2, n3, h, w):
                hp = h + rq.TILE_H
                z = torch.empty((hp, w), dtype=torch.float32, device=dev)
                s = torch.empty((hp, w), dtype=torch.int32, device=dev)
                lin = torch.empty((n2 + n3, hp, w), dtype=torch.float32,
                                  device=dev)
                rc = lib.rq_queue_raster(
                    P(scal), P(ri), P(rf), P(z), P(s), P(lin), ri.shape[0],
                    rq.CHUNK, rq.TILE_H, rq.TILE_W, n2, n3, hp, w,
                    runtime.stream_ptr(dev))
                if rc:
                    raise RuntimeError(f"{tag}: B1 launch failed ({rc})")
                return z, s, lin
            return run

        cases = {k: scene_inputs(dev, *v) for k, v in SIZES.items()}
        scal, ri, rf, h, w = cs.stress_queue(4, 0, dev)
        cases["stress queue"] = (scal, ri, rf, 4, 0, h, w)
        _, ri, rf, n2, n3, _, _ = cases["KillerooP 2048"]
        nty = 2048 // rq.TILE_H
        cases["empty 2048"] = (
            torch.tensor([[nty, 0, 1, 0, nty]] * 4, dtype=torch.int32,
                         device=dev),
            ri.new_zeros((4,) + ri.shape[1:]),
            rf.new_zeros((4,) + rf.shape[1:]), n2, n3, 2048, 2048)

        order = list(libs) + list(libs)[::-1]
        bad = 0
        for label, a in cases.items():
            b7a = a[:3] + a[5:]
            zp, sp = rq.raster_zslot_queue_plain(*b7a)
            won = sp >= 0
            times = {}
            for tag in order:
                run, old = b7(tag)
                zk, sk = run(*b7a)
                zbad = zk.view(torch.int32) != zp.view(torch.int32)
                words = int((sk != sp).sum()) + int(
                    (zbad[won] if old else zbad).sum())
                bad += words
                ms = cs.device_ms(lambda: run(*b7a), REPS, None,
                                  2 if old else 1)
                kern = ""
                if old:
                    alone = cs.device_ms(lambda: run(*b7a), REPS, "zslot")
                    kern = f", kernel alone {alone:.5f}"
                times.setdefault(tag, []).append(ms)
                print(f"B7 {label} {tag}: {words} mismatching words, "
                      f"{ms:.5f} ms{kern} [{card}]", flush=True)
            print(f"SUMMARY B7 {label}: " + "; ".join(
                f"{t} " + ", ".join(f"{x:.4f}" for x in v)
                for t, v in times.items()) + f" ms [{card}]", flush=True)
        for label in B1_CASES:
            a = cases[label]
            zp, sp, lp = rq.raster_attrs_queue_plain(*a)
            times = {}
            for tag in order:
                run = b1(tag)
                zk, sk, lk = run(*a)
                words = (int((sk != sp).sum())
                         + int((zk.view(torch.int32)
                                != zp.view(torch.int32)).sum())
                         + int((lk.view(torch.int32)
                                != lp.view(torch.int32)).sum()))
                bad += words
                ms = cs.device_ms(lambda: run(*a), REPS, None, 1)
                times.setdefault(tag, []).append(ms)
                print(f"B1 {label} {tag}: {words} mismatching words, "
                      f"{ms:.5f} ms [{card}]", flush=True)
            print(f"SUMMARY B1 {label}: " + "; ".join(
                f"{t} " + ", ".join(f"{x:.4f}" for x in v)
                for t, v in times.items()) + f" ms [{card}]", flush=True)
    if bad:
        print(f"FAIL: {bad} mismatching words", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
