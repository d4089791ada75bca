"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Exits non-zero, printing no result, without them.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Kernel caches at fixed paths inside the checkout (the program's own
    # nvcc builds go to build/rustexp_tpu_torch/ beside it).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)

    import torch

    from perfbench import harness, spec

    torch.set_num_threads(1)

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)


if __name__ == "__main__":
    sys.exit(main())
