"""Game of Life ASCII pattern library.

The port's own copy of rustexp_tpu/assets/gol_patterns.py (numpy only):
the port imports nothing of the JAX package.

Reference: hs-src/GoLPatterns.hs:8-103. 'O' = live cell, '.' = dead.
These are canonical, public Life patterns (acorn; Gosper glider gun;
Max spacefiller; the ark).
"""

from __future__ import annotations

import numpy as np

ACORN = [
    ".O.....",
    "...O...",
    "OO..OOO",
]

# Gosper glider gun
GUN = [
    "........................O...........",
    "......................O.O...........",
    "............OO......OO............OO",
    "...........O...O....OO............OO",
    "OO........O.....O...OO..............",
    "OO........O...O.OO....O.O...........",
    "..........O.....O.......O...........",
    "...........O...O....................",
    "............OO......................",
]

# 'Max' spacefiller — http://www.radicaleye.com/lifepage/patterns/max.html
SPACEFILL = [
    ".....O.O.....................",
    "....O..O.....................",
    "...OO........................",
    "..O..........................",
    ".OOOO........................",
    "O....O.......................",
    "O..O.........................",
    "O..O.........................",
    ".O.........OOO...OOO.........",
    "..OOOO.O..O..O...O..O........",
    "...O...O.....O...O...........",
    "....O........O...O...........",
    "....O.O......O...O...........",
    ".............................",
    "...OOO.....OOO...OOO.........",
    "...OO.......O.....O..........",
    "...OOO......OOOOOOO..........",
    "...........O.......O.........",
    "....O.O...OOOOOOOOOOO........",
    "...O..O..O............OO.....",
    "...O.....OOOOOOOOOOOO...O....",
    "...O...O.............O...O...",
    "....O...OOOOOOOOOOOO.....O...",
    ".....OO............O..O..O...",
    "........OOOOOOOOOOO...O.O....",
    ".........O.......O...........",
    "..........OOOOOOO......OOO...",
    "..........O.....O.......OO...",
    ".........OOO...OOO.....OOO...",
    ".............................",
    "...........O...O......O.O....",
    "...........O...O........O....",
    "...........O...O.....O...O...",
    "........O..O...O..O..O.OOOO..",
    ".........OOO...OOO.........O.",
    ".........................O..O",
    ".........................O..O",
    ".......................O....O",
    "........................OOOO.",
    "..........................O..",
    "........................OO...",
    ".....................O..O....",
    ".....................O.O.....",
]

# The ark — http://www.argentum.freeserve.co.uk/lex_a.htm#ark
ARK = [
    "...........................O....",
    "............................O...",
    ".............................O..",
    "............................O...",
    "...........................O....",
    ".............................OOO",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "................................",
    "OO..............................",
    "..O.............................",
    "..O.............................",
    "...OOOO.........................",
]

# Classic 5-cell glider (not in the reference library; used by tests as a
# known-evolution fixture: displaces by (+1, +1) every 4 generations)
GLIDER = [
    ".O.",
    "..O",
    "OOO",
]

PATTERNS = {
    "acorn": ACORN,
    "gun": GUN,
    "spacefill": SPACEFILL,
    "ark": ARK,
    "glider": GLIDER,
}


def pattern_to_array(pattern: list[str]) -> np.ndarray:
    """ASCII rows -> uint8 [h, w]; 'O' -> 1 (reference RustGoLExperiment.hs:117-125).

    Note the reference passes rows top-to-bottom into a bottom-left-origin
    grid, so row 0 of the ASCII ends up at the *bottom* of the placed block
    being the first row in memory; we keep the identical memory layout.
    """
    h = len(pattern)
    w = max(len(r) for r in pattern)
    arr = np.zeros((h, w), dtype=np.uint8)
    for y, row in enumerate(pattern):
        for x, c in enumerate(row):
            arr[y, x] = 1 if c == "O" else 0
    return arr
