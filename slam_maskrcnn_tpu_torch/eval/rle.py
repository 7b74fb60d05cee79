"""COCO-compatible RLE mask codec: a C++ core and its plain numpy version.

Port of slam_maskrcnn_tpu/eval/rle.py (the reference vendors pycocotools'
native extension, ``Mask_RCNN/pycocotools/_mask.pyx`` + maskApi). Format:
runs over the mask flattened column-major (Fortran order), alternating
zero/one runs, first run zeros: the COCO ``counts`` convention, including
the compressed string form of COCO JSON.

The core is the port's own copy, ``csrc/rle.cpp`` (a host library, not a
kernel): ``g++`` builds it into ``build/kernels/rle-<hash>.so`` at first
use, the hash covering the source and the flags, and ctypes loads it.
There is no fallback: a failed build raises, as kernels.py does for the
CUDA sources. The numpy versions (``*_plain``) stay beside it as the plain
versions the tests hold the core against.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from slam_maskrcnn_tpu_torch.kernels import (BUILD_DIR, host_library,
                                             host_library_path)

GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64


def library_path() -> str:
    """The library's path, named by a hash of the source and the flags."""
    return host_library_path("rle", GXX_FLAGS, BUILD_DIR)


def native() -> ctypes.CDLL:
    """The loaded core, built with g++ first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = host_library("rle", GXX_FLAGS, BUILD_DIR)
        lib.rle_encode.argtypes = [_U8P, _I64, _U32P, _I64]
        lib.rle_encode.restype = ctypes.c_int64
        lib.rle_decode.argtypes = [_U32P, _I64, _U8P, _I64]
        lib.rle_decode.restype = None
        lib.rle_area.argtypes = [_U32P, _I64]
        lib.rle_area.restype = ctypes.c_uint64
        lib.rle_merge.argtypes = [_U32P, _I64, _U32P, _I64, ctypes.c_int,
                                  _U32P, _I64]
        lib.rle_merge.restype = ctypes.c_int64
        lib.rle_iou_pair.argtypes = [_U32P, _I64, _U32P, _I64, ctypes.c_int]
        lib.rle_iou_pair.restype = ctypes.c_double
        _lib = lib
        return lib


def _u32(a):
    return np.ascontiguousarray(a, np.uint32)


def _p32(a):
    return a.ctypes.data_as(_U32P)


def _flat(mask: np.ndarray) -> np.ndarray:
    return np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")


def rle_encode(mask: np.ndarray) -> dict:
    """Encode [H, W] binary mask -> {'size': [H, W], 'counts': uint32[...]}"""
    h, w = mask.shape
    flat = _flat(mask)
    out = np.empty(flat.size + 2, np.uint32)
    n = native().rle_encode(flat.ctypes.data_as(_U8P), flat.size, _p32(out),
                            out.size)
    return {"size": [h, w], "counts": out[:n].copy()}


def rle_encode_plain(mask: np.ndarray) -> dict:
    """rle_encode in numpy: run lengths from the change points."""
    h, w = mask.shape
    flat = _flat(mask)
    changes = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]]))
    if flat.size and flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {"size": [h, w], "counts": runs.astype(np.uint32)}


def rle_decode(rle: dict) -> np.ndarray:
    """Decode -> [H, W] uint8 mask (a short RLE leaves the tail zero)."""
    h, w = rle["size"]
    counts = _u32(rle["counts"])
    flat = np.zeros(h * w, np.uint8)
    native().rle_decode(_p32(counts), counts.size, flat.ctypes.data_as(_U8P),
                        flat.size)
    return flat.reshape((h, w), order="F")


def rle_decode_plain(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = _u32(rle["counts"])
    flat = np.zeros(h * w, np.uint8)
    vals = np.arange(counts.size) % 2
    runs = np.repeat(vals.astype(np.uint8), counts)[:h * w]
    flat[:runs.size] = runs
    return flat.reshape((h, w), order="F")


def rle_area(rle: dict) -> int:
    counts = _u32(rle["counts"])
    return int(native().rle_area(_p32(counts), counts.size))


def rle_area_plain(rle: dict) -> int:
    return int(_u32(rle["counts"])[1::2].sum())


def rle_merge(rles: list[dict], intersect: bool = False) -> dict:
    """Union/intersection of RLEs (maskUtils.merge semantics)."""
    assert rles, "empty merge"
    lib = native()
    acc = _u32(rles[0]["counts"])
    for r in rles[1:]:
        b = _u32(r["counts"])
        out = np.empty(acc.size + b.size + 2, np.uint32)
        n = lib.rle_merge(_p32(acc), acc.size, _p32(b), b.size,
                          1 if intersect else 0, _p32(out), out.size)
        acc = out[:n].copy()
    return {"size": rles[0]["size"], "counts": acc}


def rle_merge_plain(rles: list[dict], intersect: bool = False) -> dict:
    assert rles, "empty merge"
    size = rles[0]["size"]
    acc = _u32(rles[0]["counts"])
    for r in rles[1:]:
        m1 = rle_decode_plain({"size": size, "counts": acc})
        m2 = rle_decode_plain(r)
        m = (m1 & m2) if intersect else (m1 | m2)
        acc = _u32(rle_encode_plain(m)["counts"])
    return {"size": size, "counts": acc}


def rle_iou(dets: list[dict], gts: list[dict],
            iscrowd: list[bool] | None = None) -> np.ndarray:
    """Pairwise IoU [len(dets), len(gts)] (maskUtils.iou semantics, incl.
    crowd denominator = det area)."""
    iscrowd = iscrowd or [False] * len(gts)
    lib = native()
    out = np.zeros((len(dets), len(gts)))
    gcs = [_u32(g["counts"]) for g in gts]
    for i, d in enumerate(dets):
        dc = _u32(d["counts"])
        for j, gc in enumerate(gcs):
            out[i, j] = lib.rle_iou_pair(_p32(dc), dc.size, _p32(gc),
                                         gc.size, 1 if iscrowd[j] else 0)
    return out


def rle_iou_plain(dets: list[dict], gts: list[dict],
                  iscrowd: list[bool] | None = None) -> np.ndarray:
    iscrowd = iscrowd or [False] * len(gts)
    out = np.zeros((len(dets), len(gts)))
    for i, d in enumerate(dets):
        m1 = rle_decode_plain(d).astype(bool)
        for j, g in enumerate(gts):
            m2 = rle_decode_plain(g).astype(bool)
            inter = (m1 & m2).sum()
            denom = m1.sum() if iscrowd[j] else (m1 | m2).sum()
            out[i, j] = inter / denom if denom else 0.0
    return out


def rle_to_bbox(rle: dict) -> np.ndarray:
    """RLE -> [x, y, w, h] bbox (maskUtils.toBbox / maskApi rleToBbox
    semantics, ``Mask_RCNN/pycocotools/mask.py:36``): computed from the
    runs directly, column-major. A one-run spanning multiple columns
    forces the y extent to the full height, as upstream."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    ones = counts[1::2]
    if h == 0 or w == 0 or ones.size == 0 or ones.sum() == 0:
        return np.zeros(4, np.float64)
    ends = np.cumsum(counts)
    start = ends[0::2][:ones.size][ones > 0]      # first index of each run
    stop = ends[1::2][:ones.size][ones > 0] - 1   # last index (inclusive)
    sc, ec = start // h, stop // h
    sr, er = start % h, stop % h
    xs, xe = int(sc.min()), int(ec.max())
    if (sc != ec).any():
        ys, ye = 0, h - 1
    else:
        ys, ye = int(sr.min()), int(er.max())
    return np.array([xs, ys, xe - xs + 1, ye - ys + 1], np.float64)


def poly_to_mask(polys, h: int, w: int) -> np.ndarray:
    """Polygons (flat [x0, y0, x1, y1, ...] lists) -> u8 [H, W]: each
    polygon's vertices rounded half to even, filled as cv2.fillPoly fills
    them (data/draw.py), one polygon at a time."""
    from slam_maskrcnn_tpu_torch.data.draw import fill_poly

    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        fill_poly(mask, np.round(pts).astype(np.int32), 1)
    return mask


def fr_py_objects(pyobj, h: int, w: int):
    """Polygon(s) / uncompressed RLE(s) / bbox(es) -> RLE dict(s) with
    uint32 counts (maskUtils.frPyObjects dispatch,
    ``Mask_RCNN/pycocotools/mask.py:37``, ``_mask.pyx:245-308``). Lists
    return a list of RLEs; a single dict / flat polygon / 4-vector
    returns one RLE. Polygons rasterise as ``poly_to_mask``."""
    def one_poly(poly):
        return rle_encode(poly_to_mask([poly], h, w))

    def one_bbox(bb):
        x, y, bw, bh = [float(v) for v in bb]
        mask = np.zeros((h, w), np.uint8)
        y0, y1 = int(round(y)), int(round(y + bh))
        x0, x1 = int(round(x)), int(round(x + bw))
        mask[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 1
        return rle_encode(mask)

    def one_uncompressed(d):
        counts = d["counts"]
        if isinstance(counts, str):
            counts = string_to_counts(counts)
        return {"size": list(d["size"]),
                "counts": np.asarray(counts, np.uint32)}

    if isinstance(pyobj, np.ndarray):
        return [one_bbox(b) for b in pyobj.reshape(-1, 4)]
    if isinstance(pyobj, dict):
        return one_uncompressed(pyobj)
    if isinstance(pyobj, (list, tuple)) and pyobj:
        first = pyobj[0]
        if isinstance(first, dict):
            return [one_uncompressed(d) for d in pyobj]
        if isinstance(first, (list, tuple, np.ndarray)):
            if len(first) == 4:
                return [one_bbox(b) for b in pyobj]
            return [one_poly(p) for p in pyobj]
        # flat list of numbers: one bbox or one polygon
        if len(pyobj) == 4:
            return one_bbox(pyobj)
        return one_poly(pyobj)
    raise TypeError("unsupported object for fr_py_objects")


def counts_to_string(counts: np.ndarray) -> str:
    """Compress counts to the COCO JSON LEB128-style string."""
    s = []
    for i, c in enumerate(np.asarray(counts, np.int64)):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c5 = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c5 & 0x10))
                        or (x == -1 and (c5 & 0x10)))
            if more:
                c5 |= 0x20
            s.append(chr(c5 + 48))
    return "".join(s)


def string_to_counts(s: str) -> np.ndarray:
    """Decompress the COCO JSON counts string."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += int(counts[-2])
        counts.append(x)
    return np.asarray(counts, np.uint32)


def mask_to_rle_string(mask: np.ndarray) -> dict:
    """[H, W] mask -> {'size', 'counts': str} as in COCO JSON results."""
    r = rle_encode(mask)
    return {"size": r["size"], "counts": counts_to_string(r["counts"])}
