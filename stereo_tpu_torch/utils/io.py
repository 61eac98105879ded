"""Image / dataset IO for the bundled Middlebury pairs (port of
stereo_tpu/utils/io.py; numpy only).

Images are loaded as float arrays in [0, 255] and stereo datasets carry the
P-matrix convention of the reference — P of view n shifts x by
-(n-1)/(disparity_factor * im_space) per disparity unit; for the bundled
2-view pairs that is P(1,4,2) = -0.25.

PNG files are read by a small decoder of this module (zlib + numpy): 8-bit
RGB or 8/16-bit greyscale, non-interlaced — the subset the bundled data uses
— and written by a small encoder (8-bit RGB or greyscale, optional text
chunks).  No imaging library is imported.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

DATA_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "data")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, H: int, row_bytes: int, bpp: int):
    """Undo the PNG scanline filters.  raw: [H, 1 + row_bytes] uint8.

    A byte depends on its left, upper and upper-left neighbours (bpp bytes
    apart), so all bytes on an anti-diagonal of (row, pixel) are independent:
    the walk is over H + npix - 1 diagonals, each one vectorised over rows."""
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG: unknown scanline filter")
    npix = row_bytes // bpp
    filt = raw[:, 1:].reshape(H, npix, bpp).astype(np.int64)
    # recon with a zero border row on top and a zero border pixel on the left
    rec = np.zeros((H + 1, npix + 1, bpp), np.int64)
    rows_all = np.arange(H)
    for t in range(H + npix - 1):
        r = rows_all[max(0, t - npix + 1):min(H, t + 1)]
        c = t - r
        a = rec[r + 1, c]  # left
        b = rec[r, c + 1]  # up
        ul = rec[r, c]  # upper left
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        f = ftype[r][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [0, a, b, (a + b) // 2], paeth)
        rec[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: [H, W, 3] uint8 (RGB) or [H, W] uint8/uint16 (grey)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
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
    W, H, depth, ctype, _, _, interlace = header
    if interlace or (ctype, depth) not in ((2, 8), (0, 8), (0, 16)):
        raise ValueError(
            f"{path}: only non-interlaced 8-bit RGB and 8/16-bit greyscale "
            f"PNGs are supported (colour type {ctype}, depth {depth}, "
            f"interlace {interlace})")
    bpp = (3 if ctype == 2 else 1) * depth // 8
    row_bytes = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, 1 + row_bytes)
    px = _unfilter(raw, H, row_bytes, bpp)  # [H, W, bpp]
    if ctype == 2:
        return px
    if depth == 16:
        return (px[..., 0].astype(np.uint16) << 8) | px[..., 1]
    return px[..., 0]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img, text: dict | None = None) -> str:
    """Encode ``img`` ([H, W] greyscale or [H, W, 3] RGB, uint8) as a PNG:
    unfiltered scanlines, one zlib stream, and a ``tEXt`` chunk per
    ``text`` item (Latin-1 keyword and value)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png: expected uint8 [H, W] or [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = img.reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    out = [_PNG_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                          + str(value).encode("latin-1")))
    out += [_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
            _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """[H, W, 3] float image with values in [0, 255]."""
    im = read_png(path)
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=2)
    return im.astype(dtype)


@dataclass
class StereoPair:
    name: str
    images: list  # two [H, W, 3] float arrays, images[0] = reference view
    P: np.ndarray  # [2, 3, 4] camera matrices
    disp_range: tuple  # (min, max) in dataset disparity units
    disparity_factor: int

    @property
    def shape(self):
        return self.images[0].shape[:2]


_PAIRS = {
    "teddy": dict(disp_range=(0, 59), disparity_factor=4, p_shift=-0.25),
    "baby2": dict(disp_range=(0, 85), disparity_factor=3, p_shift=-0.25),
    # synthetic pair with bundled exact ground truth
    "synth": dict(disp_range=(0, 16), disparity_factor=8, p_shift=-0.125),
}


def load_ground_truth(name: str, root: str | None = None,
                      dtype=np.float32) -> np.ndarray | None:
    """Ground-truth disparity map of the reference view, or None if absent.

    ``<root>/<name>/disp2.png`` holds disparity_factor * disparity, 0 =
    unknown.  Returns [H, W] float disparities in dataset units with NaN at
    unknown pixels."""
    if name not in _PAIRS:
        raise KeyError(f"Unknown bundled pair {name!r}; have {sorted(_PAIRS)}")
    for r in (root, os.environ.get("STEREO_TPU_GT_DIR"), DATA_ROOT):
        if not r:
            continue
        path = os.path.join(r, name, "disp2.png")
        if os.path.exists(path):
            raw = read_png(path).astype(dtype)
            gt = raw / _PAIRS[name]["disparity_factor"]
            gt[raw == 0] = np.nan
            return gt
    return None


def load_pair(name: str, root: str | None = None,
              dtype=np.float32) -> StereoPair:
    if name not in _PAIRS:
        raise KeyError(f"Unknown bundled pair {name!r}; have {sorted(_PAIRS)}")
    cfg = _PAIRS[name]
    root = root or DATA_ROOT
    im0 = load_image(os.path.join(root, name, "im2.png"), dtype)
    im1 = load_image(os.path.join(root, name, "im6.png"), dtype)
    P = np.zeros((2, 3, 4))
    P[:, :, :3] = np.eye(3)
    P[1, 0, 3] = cfg["p_shift"]
    return StereoPair(name=name, images=[im0, im1], P=P,
                      disp_range=cfg["disp_range"],
                      disparity_factor=cfg["disparity_factor"])
