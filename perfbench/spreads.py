"""Spreads of two sets of runs, as the bounds in BENCHMARK.json are set.

    python3 -m perfbench.spreads OUTDIR

reads the result lines that perfbench/sets.sh wrote (<set>_<cell>_<seed>
.out) and prints, per cell and end-to-end metric, each set's median and
spread (quartile distance over the median), the spread with each set's
run farthest from its median left out (the mean of the two sets), and
the spread of all runs together.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from collections import defaultdict
from pathlib import Path

from perfbench.stats import spread

FILE = re.compile(r"^([AB])_(.+)_(\d+)\.out$")


def without_farthest(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    out = Path((argv or sys.argv[1:])[0])
    runs = defaultdict(lambda: defaultdict(list))  # cell -> set -> lines
    for f in sorted(out.glob("*.out")):
        m = FILE.match(f.name)
        if m and f.read_text().strip():
            runs[m[2]][m[1]].append(
                json.loads(f.read_text().strip().splitlines()[-1]))
    for cell, sets in sorted(runs.items()):
        lines = [x for s in sets.values() for x in s]
        print(f"{cell}: {len(lines)} runs, correct "
              f"{sum(x['correct'] for x in lines)}")
        for name in lines[0]["metrics"]:
            per = {s: [x["metrics"][name]["value"] for x in v]
                   for s, v in sorted(sets.items())}
            parts = [f"{s} median {statistics.median(v):.4f} spread "
                     f"{100 * spread(v):.2f}%" for s, v in per.items()]
            kept = [spread(without_farthest(v)) for v in per.values()]
            every = [x for v in per.values() for x in v]
            print(f"  {name}: {'; '.join(parts)}; farthest left out "
                  f"{100 * sum(kept) / len(kept):.2f}%; all runs "
                  f"{100 * spread(every):.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
