"""Animated GIF writer (GIF89a), dependency-free like the PNG writer.

Port of rustexp_tpu/core/gif.py without its optional native LZW: the
pure-Python encoder is the only path, and its bytes are the same. One
global 256-color palette by median cut over pixels sampled from every
frame, nearest-color quantization in vectorized numpy, and a plain LZW
encoder (the only Python-loop stage: an offline artifact, not a hot
path). It backs the CLI's --gif.
"""

from __future__ import annotations

import struct

import numpy as np


def _median_cut_palette(pixels: np.ndarray, n_colors: int = 256) -> np.ndarray:
    """uint8 [N, 3] sample -> uint8 [<=n_colors, 3] palette (median cut)."""
    boxes = [np.unique(pixels, axis=0)]
    while len(boxes) < n_colors:
        # Split the box with the largest channel range; boxes of one
        # unique color can't split further.
        ranges = [
            tuple(np.ptp(b, axis=0)) if len(b) > 1 else (-1, -1, -1)
            for b in boxes
        ]
        widest = [max(r) for r in ranges]
        i = int(np.argmax(widest))
        if widest[i] <= 0:
            break
        b = boxes.pop(i)
        ch = int(np.argmax(ranges[i]))
        order = np.argsort(b[:, ch], kind="stable")
        half = len(order) // 2
        boxes.append(b[order[:half]])
        boxes.append(b[order[half:]])
    return np.array([b.mean(axis=0).round() for b in boxes], np.uint8)


def _quantize(frame: np.ndarray, palette: np.ndarray,
              chunk: int = 16384) -> np.ndarray:
    """uint8 [h, w, 3] -> uint8 [h, w] palette indices (nearest color)."""
    h, w, _ = frame.shape
    px = frame.reshape(-1, 3).astype(np.int32)
    pal = palette.astype(np.int32)
    out = np.empty(px.shape[0], np.uint8)
    for i in range(0, px.shape[0], chunk):
        d = px[i : i + chunk, None, :] - pal[None, :, :]
        out[i : i + chunk] = np.argmin((d * d).sum(axis=2), axis=1)
    return out.reshape(h, w)


def _lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF-variant LZW over a flat uint8 index stream."""
    clear = 1 << min_code_size
    end = clear + 1
    table = {(i,): i for i in range(clear)}
    next_code = end + 1
    code_size = min_code_size + 1

    out = bytearray()
    acc = 0
    nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear, code_size)
    seq = ()
    for v in indices.ravel().tolist():
        cand = seq + (v,)
        if cand in table:
            seq = cand
            continue
        emit(table[seq], code_size)
        table[cand] = next_code
        next_code += 1
        if next_code > (1 << code_size):
            code_size += 1
        if next_code >= 4096:  # dictionary full: reset (GIF spec)
            emit(clear, code_size)
            table = {(i,): i for i in range(clear)}
            next_code = end + 1
            code_size = min_code_size + 1
        seq = (v,)
    if seq:
        emit(table[seq], code_size)
    emit(end, code_size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        blk = data[i : i + 255]
        out.append(len(blk))
        out += blk
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames, fps: float = 30.0, loop: int = 0,
              sample_px: int = 1 << 16) -> None:
    """Write uint8 RGB frames [h, w, 3] (top-left origin) as a looping GIF.

    One global median-cut palette over pixels sampled evenly from every
    frame; per-frame delay from fps (GIF resolution is 10 ms). loop=0
    means loop forever.
    """
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w, _ = frames[0].shape
    for f in frames:
        if f.shape != (h, w, 3):
            raise ValueError("all frames must be RGB8 of one shape")

    per = max(1, sample_px // len(frames))
    rng = np.random.default_rng(0)
    sample = np.concatenate([
        f.reshape(-1, 3)[rng.integers(0, h * w, per)] for f in frames
    ])
    palette = _median_cut_palette(sample)
    pal_n = len(palette)
    # Pad the color table to a power of two >= 2 as the format requires.
    depth = max(1, int(np.ceil(np.log2(max(2, pal_n)))))
    table = np.zeros((1 << depth, 3), np.uint8)
    table[:pal_n] = palette

    delay_cs = max(2, round(100.0 / fps))  # hundredths of a second

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HHBBB", w, h, 0xF0 | (depth - 1), 0, 0)
    out += table.tobytes()
    # NETSCAPE looping extension
    out += b"\x21\xff\x0bNETSCAPE2.0" + bytes([3, 1]) \
        + struct.pack("<H", loop) + b"\x00"

    min_code = max(2, depth)
    for f in frames:
        idx = _quantize(f, palette)
        out += b"\x21\xf9\x04" + bytes([0]) + struct.pack("<H", delay_cs) \
            + b"\x00\x00"  # GCE: no disposal, no transparency
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += bytes([min_code])
        out += _sub_blocks(_lzw_encode(idx, min_code))
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(out)
