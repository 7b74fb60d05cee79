"""The harness's own PNG codec (numpy and zlib): stage 1's input frames
are written with it, and the masks the port writes are read back with it
for the judgement."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_rgb(rgb: np.ndarray) -> bytes:
    """u8 [H, W, 3] RGB -> PNG bytes (no row filter)."""
    H, W = rgb.shape[:2]
    rows = np.zeros((H, 1 + 3 * W), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(rgb).reshape(H, -1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def decode_gray8(data: bytes) -> np.ndarray:
    """A non-interlaced 8-bit gray PNG -> u8 [H, W]; row filters 0-4."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    at, idat, hdr = 8, [], None
    while at < len(data):
        n, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        at += 12 + n
    W, H, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 0, 0):
        raise ValueError(f"not an 8-bit gray PNG: {hdr}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, W + 1)
    out = np.zeros((H, W), np.uint8)
    prev = np.zeros(W, np.int32)
    for y in range(H):
        f, r = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 1:
            r = np.cumsum(r) % 256
        elif f == 2:
            r = (r + prev) % 256
        elif f in (3, 4):
            cur = np.zeros(W, np.int32)
            for x in range(W):
                a = cur[x - 1] if x else 0
                b, c = prev[x], (prev[x - 1] if x else 0)
                if f == 3:
                    p = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                         else c)
                cur[x] = (r[x] + p) % 256
            r = cur
        out[y] = r
        prev = r.astype(np.int32)
    return out
