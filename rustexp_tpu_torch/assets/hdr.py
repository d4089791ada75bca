"""Radiance ``.hdr`` (RGBE) image loading, numpy-only.

The port's own copy of rustexp_tpu/assets/hdr.py, without that module's
optional native C++ decoder (the numpy decoder below gives the same
arrays). Replaces the reference's stb_image dependency
(rasterizer.rs:555-567).
Supports the three scanline encodings found in Radiance files: flat RGBE,
old-style run-length (1,1,1,count marker), and the "new" per-component RLE
(scanlines starting 0x02 0x02). Only the ``-Y h +X w`` (top-down, row-major)
orientation is handled, which is what stb_image supports and what the
reference's envmap assets use.

RGBE decode follows stb_image's convention: ``c * 2^(e - 136)`` (i.e. no
+0.5 mantissa bias), so loaded values match what the reference saw.
"""

from __future__ import annotations

import numpy as np


def _decode_new_rle(data: bytes, pos: int, width: int) -> tuple[np.ndarray, int]:
    """Decode one new-RLE scanline into uint8 [width, 4]; return (row, new_pos)."""
    out = np.empty((4, width), dtype=np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            count = data[pos]
            pos += 1
            if count > 128:  # run
                out[c, x : x + count - 128] = data[pos]
                pos += 1
                x += count - 128
            else:  # literal
                out[c, x : x + count] = np.frombuffer(
                    data, dtype=np.uint8, count=count, offset=pos
                )
                pos += count
                x += count
    return out.T.copy(), pos


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """uint8 [..., 4] RGBE -> float32 [..., 3], stb_image convention."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.exp2(e - 136).astype(np.float64)).astype(
        np.float32
    )
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def load_hdr(path: str) -> np.ndarray:
    """Load a Radiance HDR file -> float32 [h, w, 3], row 0 = top scanline."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: text lines up to a blank line, then the resolution line.
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    rows = []
    for _ in range(h):
        if (
            8 <= w <= 0x7FFF
            and data[pos] == 2
            and data[pos + 1] == 2
            and (data[pos + 2] << 8 | data[pos + 3]) == w
        ):
            pos += 4
            row, pos = _decode_new_rle(data, pos, w)
        else:
            # Flat RGBE with possible old-style RLE (r=g=b=1 repeat markers)
            row = np.empty((w, 4), dtype=np.uint8)
            x = 0
            shift = 0
            while x < w:
                px = data[pos : pos + 4]
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    count = px[3] << shift
                    # A repeat marker with nothing to repeat, or one that
                    # overruns the row, is malformed (the C++ decoder
                    # rejects both with -6; stb_image does the same).
                    if x == 0 or x + count > w:
                        raise ValueError("malformed old-style RLE in HDR scanline")
                    row[x : x + count] = row[x - 1]
                    x += count
                    shift += 8
                else:
                    row[x] = np.frombuffer(px, dtype=np.uint8)
                    x += 1
                    shift = 0
        rows.append(row)

    return _rgbe_to_float(np.stack(rows))
