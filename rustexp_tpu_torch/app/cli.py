"""Headless command line: the port's main entry point.

Port of rustexp_tpu/app/cli.py. It replaces the reference's GLFW window
loop (hs-src/Main.hs:48-76, App.hs:155-215): experiments are chosen by
name, interactive keybindings become ``--keys`` (a string of the
reference's key characters applied before the run), frames go to PNG,
and the per-frame status prints to stdout. Everything runs on the card
(``--device cuda``, the default) unless ``--device cpu`` asks for the
CPU; a card that is absent or does not run ends the program with a
message. ``--devices N`` runs the experiment on N spawned ranks through
the sharded paths (app/multidev.py): on the card by default, as gloo CPU
ranks with ``--device cpu``.

Usage examples:
    python -m rustexp_tpu_torch.app.cli rasterizer --frames 8 --size 512 \\
        --keys WWP --out /tmp/frame
    python -m rustexp_tpu_torch.app.cli gol --frames 4 --keys G
    python -m rustexp_tpu_torch.app.cli nbody --frames 60
    python -m rustexp_tpu_torch.app.cli sine --device cpu --size 64
    python -m rustexp_tpu_torch.app.cli gol --devices 4 --frames 4
    python -m rustexp_tpu_torch.app.cli bench
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

from ..core.platform import require_live_device


def build_experiment(name: str, device):
    if name == "sine":
        from ..sims.sine import SineExperiment

        return SineExperiment(device)
    if name == "gol":
        from ..sims.gol import GoLExperiment

        return GoLExperiment(device)
    if name == "nbody":
        from ..sims.nbody import NBodyExperiment

        return NBodyExperiment(device)
    if name == "rasterizer":
        from ..sims.rasterizer import RasterizerExperiment

        return RasterizerExperiment(device)
    raise SystemExit(f"unknown experiment {name!r}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rustexp_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("experiment",
                   choices=["sine", "gol", "nbody", "rasterizer", "bench"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or, when asked, the CPU")
    p.add_argument("--frames", type=int, default=4, help="frames to render")
    p.add_argument("--size", type=int, default=512, help="framebuffer size (square)")
    p.add_argument("--keys", default="", help="key events applied before the run "
                   "(reference keybindings, e.g. 'WWP' = next-next-mesh, per-pixel)")
    p.add_argument("--out", default="", help="PNG path prefix (writes <out>_NNN.png)")
    p.add_argument("--overlay", action="store_true", default=True,
                   help="burn the status line into each frame "
                        "(the reference's on-screen overlay, App.hs:106-129)")
    p.add_argument("--no-overlay", dest="overlay", action="store_false",
                   help="render frames without the burned-in status line")
    p.add_argument("--ticks-per-frame", type=float, default=1.0 / 60.0)
    p.add_argument("--runs", type=int, default=20, help="bench: timing runs per scene")
    p.add_argument("--save-state", default="", metavar="PATH",
                   help="write the final experiment state to PATH (npz) "
                        "for later --load-state resume")
    p.add_argument("--load-state", default="", metavar="PATH",
                   help="resume from a --save-state checkpoint instead of "
                        "a fresh init (GoL resumes bit-exactly)")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="rasterizer: render an N-frame camera-path "
                        "turntable (a queue rebuilt every frame) to --out")
    p.add_argument("--gif", default="", metavar="PATH",
                   help="additionally assemble the rendered frames into "
                        "one looping animated GIF (core/gif.py)")
    p.add_argument("--devices", type=int, default=1,
                   help="run the experiment on N spawned ranks through the "
                        "sharded paths (GoL halos, block BH with the "
                        "distributed sort, flat-queue raster bands); ranks "
                        "that share one card talk over gloo")
    p.add_argument("--grid", type=int, default=0, metavar="N",
                   help="gol: N x N grid instead of the reference's 256")
    p.add_argument("--steps-per-frame", type=int, default=0, metavar="K",
                   help="gol: K generations per rendered frame")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = require_live_device(args.device)

    if args.devices > 1:
        from .multidev import run_multidevice

        if args.animate:
            raise SystemExit("--animate renders on a single device; drop "
                             "--devices")
        times = run_multidevice(args.experiment, args.devices, args.frames,
                                args.size, args.out, overlay=args.overlay,
                                steps_per_frame=args.steps_per_frame or 8,
                                grid=args.grid, keys=args.keys,
                                gif_path=args.gif, device=dev)
        med = sorted(times)[len(times) // 2]
        print(f"{len(times)} frames, median {med * 1e3:.2f} ms on "
              f"{args.devices} ranks ({dev.type})")
        return 0

    if args.experiment == "bench":
        from .benchmark import run_suite

        print(json.dumps(run_suite(args.runs, device=dev)))
        return 0

    if args.animate:
        if args.experiment != "rasterizer":
            raise SystemExit("--animate supports the rasterizer experiment")
        from ..sims.rasterizer import RasterizerExperiment
        from .animate import render_turntable

        # --keys selects the scene as in the frame loop below (Q/W mesh,
        # A/S shader, Z/X envmap, 1/2 background, P per-pixel)
        exp = RasterizerExperiment(dev)
        st = exp.init()
        for k in args.keys:
            st = exp.handle_key(st, k)
        times = render_turntable(mesh_idx=st.mesh_idx,
                                 shader_idx=st.shader_idx,
                                 env_idx=st.env_idx, bg_idx=st.bg_idx,
                                 per_pixel=st.per_pixel,
                                 n_frames=args.animate, w=args.size,
                                 h=args.size, out_prefix=args.out,
                                 overlay=args.overlay and bool(args.out
                                                               or args.gif),
                                 gif_path=args.gif, device=dev)
        if args.gif:
            print(f"wrote {args.gif}")
        med = sorted(times)[len(times) // 2]
        print(f"{args.animate} frames, median {med * 1e3:.2f} ms/frame "
              f"(incl. the per-frame queue rebuild and the full-frame host "
              f"readback; see app/animate.py)")
        return 0

    exp = build_experiment(args.experiment, dev)
    if args.load_state:
        from ..core.checkpoint import load_state

        state = load_state(args.load_state, exp)
        print(f"resumed from {args.load_state}")
    elif args.experiment == "gol" and args.grid:
        state = exp.init(n=args.grid,
                         steps_per_frame=args.steps_per_frame or 1)
    else:
        state = exp.init()
        if args.experiment == "gol" and args.steps_per_frame:
            state.steps_per_frame = args.steps_per_frame
    for k in args.keys:
        state = exp.handle_key(state, k)

    w = h = args.size
    takes_tick = "tick" in inspect.signature(exp.render).parameters
    gif_frames = [] if args.gif else None
    t_start = time.perf_counter()
    for i in range(args.frames):
        tick = i * args.ticks_per_frame
        state = exp.step(state)
        fb = exp.render(state, w, h, tick) if takes_tick else exp.render(state, w, h)
        if args.overlay:
            from ..core.font import draw_text

            fb = draw_text(fb, exp.status(state))
        if args.out or gif_frames is not None:
            from ..core.framebuffer import to_rgb8_topleft, write_png

            rgb = to_rgb8_topleft(fb)
            if args.out:
                path = f"{args.out}_{i:03d}.png"
                write_png(path, rgb)
                print(f"wrote {path}")
            if gif_frames is not None:
                gif_frames.append(rgb)
        print(f"[{i}] {exp.status(state)}")
    dt = time.perf_counter() - t_start
    print(f"{args.frames} frames in {dt:.3f}s ({args.frames / dt:.1f} FPS)")
    if gif_frames:
        from ..core.gif import write_gif

        write_gif(args.gif, gif_frames,
                  fps=min(30.0, max(2.0, args.frames / max(dt, 1e-3))))
        print(f"wrote {args.gif}")
    if args.save_state:
        from ..core.checkpoint import save_state

        written = save_state(args.save_state, state)
        print(f"saved state to {written}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
