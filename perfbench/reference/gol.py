"""The plain reference of the Game of Life step, in plain torch.

Written from the upstream experiment (blitzcode/rust-exp,
rs-src/gol.rs:31-170): a square grid of uint8 cells, 1 alive and 0 dead,
on a torus (the row above row 0 is the last row, and so for columns).
Each generation counts the eight neighbours of every cell and applies
the rule of gol.rs:79, ``alive_nb == 3 || (alive && alive_nb == 2)``
(B3/S23), to every cell at once. It imports nothing of the measured
program, and runs on whatever device its grid is on.
"""

from __future__ import annotations

import torch

OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
           if (dy, dx) != (0, 0)]


def neighbours(grid: torch.Tensor) -> torch.Tensor:
    """The live neighbours of every cell of the torus, uint8 [n, n]."""
    nb = torch.zeros_like(grid)
    for dy, dx in OFFSETS:
        nb += torch.roll(grid, (dy, dx), (0, 1))
    return nb


def generation(grid: torch.Tensor) -> torch.Tensor:
    """One generation of the uint8 {0, 1} grid (gol.rs:79)."""
    nb = neighbours(grid)
    alive = (nb == 3) | ((grid == 1) & (nb == 2))
    return alive.to(torch.uint8)


def run(grid: torch.Tensor, k: int) -> torch.Tensor:
    """k generations of the uint8 {0, 1} grid."""
    for _ in range(int(k)):
        grid = generation(grid)
    return grid
