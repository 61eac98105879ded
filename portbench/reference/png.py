"""PNG decoding for the benchmark's inputs: non-interlaced 8-bit RGB or 8-bit
greyscale, which is what the bundled Middlebury pairs are.

The benchmark decodes each image once and hands the same array to the
program and to the reference, so neither side depends on an imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters of ``raw`` [H, 1 + W * bpp] uint8.

    A byte depends on its left, upper and upper-left neighbours, so the bytes
    of one anti-diagonal of (row, pixel) are independent: the walk visits
    H + W - 1 diagonals, each vectorised over its rows."""
    H = raw.shape[0]
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG: unknown scanline filter")
    npix = (raw.shape[1] - 1) // bpp
    filt = raw[:, 1:].reshape(H, npix, bpp).astype(np.int64)
    rec = np.zeros((H + 1, npix + 1, bpp), np.int64)  # zero top row, left col
    rows = np.arange(H)
    for t in range(H + npix - 1):
        r = rows[max(0, t - npix + 1):min(H, t + 1)]
        c = t - r
        a, b, ul = rec[r + 1, c], rec[r, c + 1], rec[r, c]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        f = ftype[r][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [0, a, b, (a + b) // 2], paeth)
        rec[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    """[H, W, 3] float32 image with values in [0, 255]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, color, _, _, interlace = header
    if interlace or depth != 8 or color not in (0, 2):
        raise ValueError(f"{path}: only non-interlaced 8-bit RGB or grey "
                         f"PNGs are read (colour {color}, depth {depth})")
    bpp = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw.reshape(H, 1 + W * bpp), bpp)
    if bpp == 1:
        px = np.repeat(px, 3, axis=2)
    return px.astype(np.float32)
