"""Framebuffer conventions and PNG I/O.

Port of rustexp_tpu/core/framebuffer.py. The framebuffer is a uint32
[h, w] ABGR tensor (int32 bits viewed as uint32), row-major with a
bottom-left origin (row 0 is the bottom scanline), as the reference's
OpenGL PBO (hs-src/FrameBuffer.hs:117-158). PNG output is the
reference's screenshot path (hs-src/FrameBuffer.hs:215-228): y-flip to a
top-left origin and drop alpha. The PNG writer and reader are numpy on
the host.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .colors import abgr32_to_rgb8


def clear(h: int, w: int, device: torch.device, value: int = 0) -> torch.Tensor:
    """A uint32 [h, w] frame of `value` on `device`."""
    bits = np.array(value, np.uint32).view(np.int32).item()
    return torch.full((h, w), bits, dtype=torch.int32,
                      device=device).view(torch.uint32)


def to_rgb8_topleft(fb_u32) -> np.ndarray:
    """uint32 ABGR bottom-left frame -> uint8 RGB [h, w, 3] with a
    top-left origin (y-flip, FrameBuffer.hs:222-227). A tensor on the
    card is read back once; a numpy array is taken as it is."""
    if isinstance(fb_u32, torch.Tensor):
        t = fb_u32.detach().cpu()
        t = t.view(torch.int32) if t.dtype == torch.uint32 else t.int()
        fb_u32 = t.numpy().view(np.uint32)
    return abgr32_to_rgb8(fb_u32)[::-1]


def write_png(path: str, rgb8_topleft: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (no external deps), Sub filter on every
    row (rustexp_tpu/core/framebuffer.py:37)."""
    img = np.ascontiguousarray(rgb8_topleft, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes RGB8 [h, w, 3], got {img.shape}")

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, RGB
    d = img.astype(np.int16)
    d[:, 1:] -= img[:, :-1].astype(np.int16)
    rows = np.empty((h, w * 3 + 1), np.uint8)
    rows[:, 0] = 1
    rows[:, 1:] = (d & 0xFF).astype(np.uint8).reshape(h, w * 3)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for RGB8 files (filters 0-4)
    (rustexp_tpu/core/framebuffer.py:71)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError(f"{path}: only RGB8 is supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)],
                             np.uint8).copy()
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 1:  # sub: per-channel prefix sum mod 256
            cur = (np.cumsum(line.reshape(-1, 3), axis=0, dtype=np.int64)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype in (3, 4):  # average / paeth need a sequential scan
            cur = np.zeros(stride, dtype=np.uint8)
            for i in range(stride):
                a = int(cur[i - 3]) if i >= 3 else 0
                b = int(prev[i])
                cc = int(prev[i - 3]) if i >= 3 else 0
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3)


def save_framebuffer_png(path: str, fb_u32) -> None:
    """Save a bottom-left ABGR32 frame (on any device) as a PNG."""
    write_png(path, to_rgb8_topleft(fb_u32))
