"""Tiny built-in bitmap font and the framebuffer text overlay.

Port of rustexp_tpu/core/font.py: the same hand-authored 5x7 LED-style
face (uppercase, digits, punctuation; '#' = lit), kept here as a copy.
The reference draws its status text as textured quads over every frame
(hs-src/Font.hs:17-60, App.hs:106-129); here it burns into the uint32
frame. The atlas is numpy; the blit is torch ops on the frame's device.
"""

from __future__ import annotations

import numpy as np
import torch

_GLYPHS = {
    "A": ".###.|#...#|#...#|#####|#...#|#...#|#...#",
    "B": "####.|#...#|#...#|####.|#...#|#...#|####.",
    "C": ".###.|#...#|#....|#....|#....|#...#|.###.",
    "D": "####.|#...#|#...#|#...#|#...#|#...#|####.",
    "E": "#####|#....|#....|####.|#....|#....|#####",
    "F": "#####|#....|#....|####.|#....|#....|#....",
    "G": ".###.|#...#|#....|#.###|#...#|#...#|.###.",
    "H": "#...#|#...#|#...#|#####|#...#|#...#|#...#",
    "I": ".###.|..#..|..#..|..#..|..#..|..#..|.###.",
    "J": "..###|...#.|...#.|...#.|...#.|#..#.|.##..",
    "K": "#...#|#..#.|#.#..|##...|#.#..|#..#.|#...#",
    "L": "#....|#....|#....|#....|#....|#....|#####",
    "M": "#...#|##.##|#.#.#|#.#.#|#...#|#...#|#...#",
    "N": "#...#|##..#|#.#.#|#..##|#...#|#...#|#...#",
    "O": ".###.|#...#|#...#|#...#|#...#|#...#|.###.",
    "P": "####.|#...#|#...#|####.|#....|#....|#....",
    "Q": ".###.|#...#|#...#|#...#|#.#.#|#..#.|.##.#",
    "R": "####.|#...#|#...#|####.|#.#..|#..#.|#...#",
    "S": ".####|#....|#....|.###.|....#|....#|####.",
    "T": "#####|..#..|..#..|..#..|..#..|..#..|..#..",
    "U": "#...#|#...#|#...#|#...#|#...#|#...#|.###.",
    "V": "#...#|#...#|#...#|#...#|#...#|.#.#.|..#..",
    "W": "#...#|#...#|#...#|#.#.#|#.#.#|##.##|#...#",
    "X": "#...#|#...#|.#.#.|..#..|.#.#.|#...#|#...#",
    "Y": "#...#|#...#|.#.#.|..#..|..#..|..#..|..#..",
    "Z": "#####|....#|...#.|..#..|.#...|#....|#####",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####",
    "3": ".###.|#...#|....#|..##.|....#|#...#|.###.",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.",
    "5": "#####|#....|####.|....#|....#|#...#|.###.",
    "6": ".###.|#....|#....|####.|#...#|#...#|.###.",
    "7": "#####|....#|...#.|..#..|..#..|..#..|..#..",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.",
    "9": ".###.|#...#|#...#|.####|....#|....#|.###.",
    " ": ".....|.....|.....|.....|.....|.....|.....",
    ".": ".....|.....|.....|.....|.....|.##..|.##..",
    ",": ".....|.....|.....|.....|.##..|..#..|.#...",
    ":": ".....|.##..|.##..|.....|.##..|.##..|.....",
    "|": "..#..|..#..|..#..|..#..|..#..|..#..|..#..",
    "/": "....#|....#|...#.|..#..|.#...|#....|#....",
    "-": ".....|.....|.....|#####|.....|.....|.....",
    "+": ".....|..#..|..#..|#####|..#..|..#..|.....",
    "(": "...#.|..#..|.#...|.#...|.#...|..#..|...#.",
    ")": ".#...|..#..|...#.|...#.|...#.|..#..|.#...",
    "[": ".###.|.#...|.#...|.#...|.#...|.#...|.###.",
    "]": ".###.|...#.|...#.|...#.|...#.|...#.|.###.",
    "%": "##..#|##..#|...#.|..#..|.#...|#..##|#..##",
    "#": ".#.#.|#####|.#.#.|.#.#.|.#.#.|#####|.#.#.",
    "=": ".....|.....|#####|.....|#####|.....|.....",
    "?": ".###.|#...#|....#|...#.|..#..|.....|..#..",
    "'": "..#..|..#..|.....|.....|.....|.....|.....",
    "_": ".....|.....|.....|.....|.....|.....|#####",
    "<": "...#.|..#..|.#...|#....|.#...|..#..|...#.",
    ">": ".#...|..#..|...#.|....#|...#.|..#..|.#...",
}

GLYPH_W, GLYPH_H = 6, 8  # 5x7 bitmap + 1px spacing


def _build_atlas():
    atlas = {}
    for ch, rows in _GLYPHS.items():
        bits = np.zeros((GLYPH_H, GLYPH_W), dtype=bool)
        for y, row in enumerate(rows.split("|")):
            for x, c in enumerate(row):
                bits[y, x] = c == "#"
        atlas[ch] = bits
    return atlas


_ATLAS = _build_atlas()


def text_mask(text: str) -> np.ndarray:
    """Render text to a bool mask [GLYPH_H, len*GLYPH_W] (top-left origin)."""
    cols = [_ATLAS.get(ch, _ATLAS["?"]) for ch in text.upper()]
    if not cols:
        return np.zeros((GLYPH_H, 0), dtype=bool)
    return np.concatenate(cols, axis=1)


def _i32(v: int) -> int:
    return np.array(v, np.uint32).view(np.int32).item()


def draw_text(fb: torch.Tensor, text: str, x: int = 4, y: int = 4,
              color: int = 0x00FFFFFF, bg: int | None = 0x80000000):
    """Burn `text` into a uint32 ABGR frame near its TOP-left -> a new
    uint32 frame on the same device (rustexp_tpu/core/font.py:100).

    The frame has a bottom-left origin (core/framebuffer.py); `y` is the
    distance from the top edge, like the reference's overlay
    (App.hs:115-129). With `bg` set, the strip behind the text is dimmed
    to half intensity for readability.
    """
    bits = fb.view(torch.int32) if fb.dtype == torch.uint32 else fb
    h, w = bits.shape
    mask = text_mask(text)
    th, tw = mask.shape
    tw = min(tw, w - x)
    if tw <= 0 or th + y > h:
        return bits.view(torch.uint32)
    m = torch.from_numpy(np.ascontiguousarray(mask[::-1, :tw])).to(
        bits.device)  # rows flipped to bottom-up
    row0 = h - y - th
    out = bits.clone()
    region = out[row0 : row0 + th, x : x + tw]
    if bg is not None:
        region = (region >> 1) & 0x7F7F7F7F
    out[row0 : row0 + th, x : x + tw] = torch.where(m, _i32(color), region)
    return out.view(torch.uint32)
