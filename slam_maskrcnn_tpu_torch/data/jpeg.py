"""JPEG decoder and encoder: libjpeg-turbo's arithmetic, without cv2.

Takes the place of ``cv2.imdecode`` / ``cv2.imencode(".jpg")`` for the
JAX package's ``cv2.imread`` of COCO and balloon photos and for the MJPEG
video writer. OpenCV 5.0.0 reads and writes JPEG through libjpeg-turbo
3.1; this module gives the same pixels and the same bytes.

The entropy coding runs on the host: ``csrc/jpeg.cpp`` (marker parsing,
Huffman decoding into quantised coefficients, including progressive
scans; Huffman encoding), built by g++ into ``build/kernels/`` at first
use, with no fallback. The pixel stages are torch on the caller's device
(the card by default), in libjpeg's integer arithmetic so that card and
CPU agree to the bit:

* decoding: dequantisation and ``jidctint.c``'s islow inverse DCT
  (``CONST_BITS`` 13, ``PASS1_BITS`` 2, 64-bit products as ``JLONG``),
  its output through the range-limit table at ``x & RANGE_MASK`` (a wrap,
  not a clamp, beyond +-512); "fancy" triangle upsampling for h2v1, h1v2
  and h2v2 chroma (``jdsample.c``: edge rows and columns replicated, plain
  replication when the chroma is at most two samples wide), plain
  replication for other integer ratios (4:1:1); ``jdcolor.c``'s
  table-driven YCbCr -> BGR;
* encoding: ``jccolor.c``'s RGB -> YCbCr tables, ``jcsample.c``'s
  downsampling (h2v1 / h2v2 with alternating bias, averaging otherwise)
  after replicating the right and bottom edges, ``jfdctint.c``'s islow
  forward DCT, quantisation by ``compute_reciprocal``'s multiply-shift,
  ``jccoefct.c``'s dummy blocks at the MCU padding; Annex K Huffman
  tables (or per-scan optimal ones for progressive files), as cv2 writes
  at its defaults (quality 95, 4:2:0, baseline).

Four-component files are read too, as OpenCV reads them: libjpeg outputs
CMYK (Adobe transform 0, or no Adobe marker) or converts YCCK (any other
transform) to CMYK, and OpenCV's ``icvCvt_CMYK2BGR`` / ``CMYK2Gray``
turn Adobe's inverted CMYK into BGR or gray; a three-component RGB file
read as gray goes through ``rgb_gray_convert``. All of it runs on the
device.

``decode`` returns a u8 torch tensor on the device, [H, W, 3] BGR or
[H, W] gray; ``decode_timed`` also returns the host and device seconds.
``encode`` returns the file's bytes; ``encode_cmyk`` writes a baseline
Adobe CMYK file, which cv2 cannot write. data/image_io.py builds
``imread`` / ``imwrite`` on these.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.kernels import host_library

GXX_FLAGS = ("-O2", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None

# jcparam.c's Annex K base tables, natural (row-major) order
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64)
# cv2.IMWRITE_JPEG_SAMPLING_FACTOR_* -> luma (h, v); chroma is 1 x 1
SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2),
            "411": (4, 1)}

# jidctint.c / jfdctint.c constants (CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
F_0_298, F_0_390, F_0_541, F_0_765 = 2446, 3196, 4433, 6270
F_0_899, F_1_175, F_1_501, F_1_847 = 7373, 9633, 12299, 15137
F_1_961, F_2_053, F_2_562, F_3_072 = 16069, 16819, 20995, 25172


class JPEGError(ValueError):
    """A JPEG this codec does not read, or a damaged one."""


def native() -> ctypes.CDLL:
    """The entropy coder, built with g++ first if needed (no fallback)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = host_library("jpeg", GXX_FLAGS)
        P = ctypes.c_void_p
        lib.jpeg_error.restype = ctypes.c_char_p
        lib.jpeg_info.argtypes = [P, ctypes.c_int64, P]
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [P, ctypes.c_int64, P, P]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_encode.argtypes = [
            P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P, ctypes.c_int,
            ctypes.c_int, P, ctypes.c_int64]
        lib.jpeg_encode.restype = ctypes.c_int64
        _lib = lib
        return lib


def _raise(lib, what: str):
    raise JPEGError(f"{what}: {lib.jpeg_error().decode()}")


def info(data: bytes) -> dict:
    """The frame header: width, height, progressive, restart interval,
    the colour space libjpeg would assume, and each component's id,
    sampling, table, padded block grid and downsampled size."""
    lib = native()
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(48, np.int32)
    if lib.jpeg_info(buf.ctypes.data, buf.size, out.ctypes.data):
        _raise(lib, "JPEG header")
    n = int(out[2])
    comps = [dict(zip(("id", "h", "v", "tq", "bw", "bh", "dw", "dh"),
                      (int(v) for v in out[16 + 8 * c:24 + 8 * c])))
             for c in range(n)]
    return dict(width=int(out[0]), height=int(out[1]), ncomp=n,
                progressive=bool(out[3]), hmax=int(out[4]),
                vmax=int(out[5]), restart_interval=int(out[10]),
                colorspace=_colorspace(n, int(out[8]), bool(out[9]), comps),
                comps=comps)


def _colorspace(n, adobe, jfif, comps) -> str:
    """jdapimin.c default_decompress_parms for one, three or four
    components: four are CMYK without an Adobe marker or at its transform
    0, YCCK at any other."""
    if n == 1:
        return "gray"
    if n == 4:
        return "cmyk" if adobe <= 0 else "ycck"
    if jfif:
        return "ycc"
    if adobe >= 0:
        return "rgb" if adobe == 0 else "ycc"
    ids = tuple(c["id"] for c in comps)
    return "rgb" if ids == (82, 71, 66) else "ycc"


def coefficients(data: bytes):
    """Entropy-decode: (info, [per component int16 [bh, bw, 64]], qt
    [ncomp, 64] int64), coefficients and tables in natural order."""
    lib = native()
    hdr = info(data)
    sizes = [c["bh"] * c["bw"] * 64 for c in hdr["comps"]]
    coef = np.empty(sum(sizes), np.int16)
    qt = np.zeros((hdr["ncomp"], 64), np.uint16)
    buf = np.frombuffer(data, np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, coef.ctypes.data,
                       qt.ctypes.data):
        _raise(lib, "JPEG data")
    out, off = [], 0
    for c, s in zip(hdr["comps"], sizes):
        out.append(coef[off:off + s].reshape(c["bh"], c["bw"], 64))
        off += s
    return hdr, out, qt.astype(np.int64)


# ----------------------------------------------------------------- decode

def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x, shift: int):
    """One islow pass over the 8 inputs x[0..7] (int64 tensors)."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * F_0_541
    tmp2 = z1 + z3 * (-F_1_847)
    tmp3 = z1 + z2 * F_0_765
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175
    t0, t1, t2, t3 = t0 * F_0_298, t1 * F_2_053, t2 * F_3_072, t3 * F_1_501
    z1, z2 = z1 * (-F_0_899), z2 * (-F_2_562)
    z3, z4 = z3 * (-F_1_961) + z5, z4 * (-F_0_390) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit_table(device) -> torch.Tensor:
    """The post-IDCT part of jdmaster.c's sample_range_limit, indexed by
    x & 1023 for an IDCT output x centred on 0."""
    v = torch.arange(1024, device=device)
    out = torch.zeros(1024, dtype=torch.uint8, device=device)
    out[:128] = (v[:128] + 128).to(torch.uint8)
    out[128:512] = 255
    out[896:] = (v[896:] - 896).to(torch.uint8)
    return out


def idct_islow(coef: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """jpeg_idct_islow on every block: coef int16 [..., 64] (natural
    order), qt [64] -> u8 [..., 8, 8] samples."""
    shape = coef.shape[:-1]
    blk = (coef.to(torch.int64) * qt.to(torch.int64)).reshape(-1, 8, 8)
    # pass 1: columns; results stored as int (32-bit) in the workspace
    ws = _idct_1d([blk[:, k, :] for k in range(8)],
                  CONST_BITS - PASS1_BITS)
    ws = torch.stack(ws, 1).to(torch.int32).to(torch.int64)
    # pass 2: rows, descaled by PASS1_BITS + 3 more
    out = _idct_1d([ws[:, :, k] for k in range(8)],
                   CONST_BITS + PASS1_BITS + 3)
    out = torch.stack(out, 2)
    table = _range_limit_table(coef.device)
    return table[(out.to(torch.int32) & 1023).long()].reshape(*shape, 8, 8)


def _plane(blocks: torch.Tensor) -> torch.Tensor:
    """[bh, bw, 8, 8] -> [8 bh, 8 bw]."""
    bh, bw = blocks.shape[:2]
    return blocks.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def _shift(p: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """p shifted by one along dim, the edge replicated: step -1 gives each
    element its predecessor, +1 its successor."""
    n = p.shape[dim]
    if step < 0:
        idx = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.arange(n - 1)])
    else:
        idx = torch.cat([torch.arange(1, n), torch.tensor([n - 1])])
    return p.index_select(dim, idx.to(p.device))


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.stack([a, b], dim + 1).flatten(dim, dim + 1)


def upsample(p: torch.Tensor, hr: int, vr: int):
    """jdsample.c: the component plane p [dh, dw] (u8, cropped to its
    downsampled size) to [dh * vr, dw * hr]."""
    dh, dw = p.shape
    if hr == 1 and vr == 1:
        return p
    x = p.to(torch.int32)
    if hr == 2 and vr == 1 and dw > 2:
        even = (3 * x + _shift(x, 1, -1) + 1) >> 2
        odd = (3 * x + _shift(x, 1, 1) + 2) >> 2
        return _interleave(even, odd, 1).to(torch.uint8)
    if hr == 1 and vr == 2:
        up = (3 * x + _shift(x, 0, -1) + 1) >> 2
        down = (3 * x + _shift(x, 0, 1) + 2) >> 2
        return _interleave(up, down, 0).to(torch.uint8)
    if hr == 2 and vr == 2 and dw > 2:
        above = 3 * x + _shift(x, 0, -1)
        below = 3 * x + _shift(x, 0, 1)
        rows = []
        for c in (above, below):
            even = (3 * c + _shift(c, 1, -1) + 8) >> 4
            odd = (3 * c + _shift(c, 1, 1) + 7) >> 4
            rows.append(_interleave(even, odd, 1))
        return _interleave(rows[0], rows[1], 0).to(torch.uint8)
    return p.repeat_interleave(vr, 0).repeat_interleave(hr, 1)


def ycc_to_bgr(y, cb, cr) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert (its tables as formulas), BGR out."""
    y, cb, cr = (t.to(torch.int32) - c for t, c in ((y, 0), (cb, 128),
                                                    (cr, 128)))
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 + -46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([b, g, r], -1).clamp_(0, 255).to(torch.uint8)


def rgb_to_gray(r, g, b) -> torch.Tensor:
    """jdcolor.c rgb_gray_convert (its tables as formulas)."""
    r, g, b = (t.to(torch.int32) for t in (r, g, b))
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).to(
        torch.uint8)


def ycck_to_cmyk(y, cb, cr, k):
    """jdcolor.c ycck_cmyk_convert: C, M, Y = 255 - the YCbCr -> RGB of the
    first three, K as it is."""
    bgr = ycc_to_bgr(y, cb, cr)
    return 255 - bgr[..., 2], 255 - bgr[..., 1], 255 - bgr[..., 0], k


def _cmy(c, m, y, k):
    """OpenCV's utils.cpp on Adobe's inverted CMYK: each of C, M, Y becomes
    k - ((255 - v) * k >> 8), read as R, G, B."""
    k = k.to(torch.int32)
    return [k - (((255 - v.to(torch.int32)) * k) >> 8) for v in (c, m, y)]


def cmyk_to_bgr(c, m, y, k) -> torch.Tensor:
    """icvCvt_CMYK2BGR_8u_C4C3R, as cv2.imread applies it."""
    r, g, b = _cmy(c, m, y, k)
    return torch.stack([b, g, r], -1).to(torch.uint8)


def cmyk_to_gray(c, m, y, k) -> torch.Tensor:
    """icvCvt_CMYK2Gray_8u_C4C1R: (1868 B + 9617 G + 4899 R + 8192) >> 14
    of cmyk_to_bgr's channels."""
    r, g, b = _cmy(c, m, y, k)
    return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).to(torch.uint8)


def pixels(hdr: dict, coef: list, qt, device, gray: bool = False):
    """The device stages: coefficients -> u8 [H, W, 3] BGR (or [H, W]
    for a gray file, or with gray=True the gray libjpeg (YCbCr, RGB) or
    OpenCV (CMYK, YCCK) makes of a colour one)."""
    H, W = hdr["height"], hdr["width"]
    hmax, vmax = hdr["hmax"], hdr["vmax"]
    space = hdr["colorspace"]
    planes = []
    for ci, (c, k) in enumerate(zip(hdr["comps"], coef)):
        if gray and ci > 0 and space == "ycc":
            break
        t = torch.from_numpy(np.ascontiguousarray(k)).to(device)
        q = torch.as_tensor(qt[ci], device=device)
        p = _plane(idct_islow(t, q))[:c["dh"], :c["dw"]]
        if hmax % c["h"] or vmax % c["v"]:
            raise JPEGError(f"sampling factors {c['h']}x{c['v']} do not "
                            f"divide the maxima {hmax}x{vmax}")
        planes.append(upsample(p, hmax // c["h"], vmax // c["v"])[:H, :W])
    if len(planes) == 1:
        return planes[0]
    if space == "rgb":
        return rgb_to_gray(*planes) if gray else torch.stack(planes[::-1], -1)
    if space == "ycc":
        return ycc_to_bgr(*planes)
    if space == "ycck":
        planes = ycck_to_cmyk(*planes)
    return cmyk_to_gray(*planes) if gray else cmyk_to_bgr(*planes)


def decode_timed(data: bytes, device="cuda", gray: bool = False):
    """(image tensor on the device, host entropy seconds, device pixel
    seconds); the pixel time ends in a synchronise on a CUDA device."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    hdr, coef, qt = coefficients(data)
    t1 = time.perf_counter()
    img = pixels(hdr, coef, qt, dev, gray=gray)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return img, t1 - t0, time.perf_counter() - t1


def decode(data: bytes, device="cuda", gray: bool = False) -> torch.Tensor:
    return decode_timed(data, device, gray)[0]


# ----------------------------------------------------------------- encode

def quality_tables(quality: int) -> np.ndarray:
    """jpeg_set_quality(quality, force_baseline=TRUE): [2, 64] natural."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = []
    for base in (STD_LUMA_QT, STD_CHROMA_QT):
        t = (base * scale + 50) // 100
        out.append(np.clip(t, 1, 255))
    return np.stack(out)


def rgb_to_ycc(bgr: torch.Tensor):
    """jccolor.c rgb_ycc_convert (its tables as formulas) from BGR u8."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    half, off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    return y, cb, cr


def _pad_edges(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Replicate the last row and column out to [h, w]."""
    ph, pw = p.shape
    if w > pw:
        p = torch.cat([p, p[:, -1:].expand(ph, w - pw)], 1)
    if h > ph:
        p = torch.cat([p, p[-1:].expand(h - ph, p.shape[1])], 0)
    return p


def downsample(p: torch.Tensor, hr: int, vr: int) -> torch.Tensor:
    """jcsample.c on an edge-padded plane [rows * vr, cols * hr] (int32):
    h2v1 (bias 0, 1, ...), h2v2 (bias 1, 2, ...), else rounded mean."""
    if hr == 1 and vr == 1:
        return p
    rows, cols = p.shape[0] // vr, p.shape[1] // hr
    s = p.reshape(rows, vr, cols, hr).sum((1, 3))
    if hr == 2 and vr == 1:
        bias = torch.arange(cols, device=p.device) & 1
        return (s + bias) >> 1
    if hr == 2 and vr == 2:
        bias = 1 + (torch.arange(cols, device=p.device) & 1)
        return (s + bias) >> 2
    n = hr * vr
    return (s + n // 2) // n


def fdct_islow(blk: torch.Tensor) -> torch.Tensor:
    """jpeg_fdct_islow on samples - 128: int32 [N, 8, 8] -> [N, 8, 8]
    (scaled up by 8, as libjpeg's divisors expect)."""
    def one(x, first):
        tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
        tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
        tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
        tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        if first:
            o0 = (tmp10 + tmp11) << PASS1_BITS
            o4 = (tmp10 - tmp11) << PASS1_BITS
            sh = CONST_BITS - PASS1_BITS
        else:
            o0 = _descale(tmp10 + tmp11, PASS1_BITS)
            o4 = _descale(tmp10 - tmp11, PASS1_BITS)
            sh = CONST_BITS + PASS1_BITS
        z1 = (tmp12 + tmp13) * F_0_541
        o2 = _descale(z1 + tmp13 * F_0_765, sh)
        o6 = _descale(z1 + tmp12 * (-F_1_847), sh)
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * F_1_175
        tmp4, tmp5 = tmp4 * F_0_298, tmp5 * F_2_053
        tmp6, tmp7 = tmp6 * F_3_072, tmp7 * F_1_501
        z1, z2 = z1 * (-F_0_899), z2 * (-F_2_562)
        z3, z4 = z3 * (-F_1_961) + z5, z4 * (-F_0_390) + z5
        o7 = _descale(tmp4 + z1 + z3, sh)
        o5 = _descale(tmp5 + z2 + z4, sh)
        o3 = _descale(tmp6 + z2 + z3, sh)
        o1 = _descale(tmp7 + z1 + z4, sh)
        return [o0, o1, o2, o3, o4, o5, o6, o7]

    x = blk.to(torch.int64)
    rows = one([x[:, :, k] for k in range(8)], True)       # pass 1: rows
    ws = torch.stack(rows, 2).to(torch.int16).to(torch.int64)
    cols = one([ws[:, k, :] for k in range(8)], False)     # pass 2: columns
    return torch.stack(cols, 1).to(torch.int16)


def _reciprocals(qt: np.ndarray):
    """compute_reciprocal (jcdctmgr.c, 16-bit DCTELEM) for divisors
    q << 3: (reciprocal, correction, shift) [64] each."""
    recip, corr, shift = [], [], []
    for q in (np.asarray(qt, np.int64) << 3):
        q = int(q)
        b = q.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, q)
        c = q // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= q // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip), np.array(corr), np.array(shift)


def quantize(d: torch.Tensor, qt: np.ndarray) -> torch.Tensor:
    """jcdctmgr.c quantize: sign * (((|x| + corr) * recip) >> shift)."""
    recip, corr, shift = (torch.as_tensor(a, device=d.device)
                          for a in _reciprocals(qt))
    x = d.reshape(-1, 64).to(torch.int64)
    mag = ((x.abs() + corr) * recip) >> shift
    return torch.where(x < 0, -mag, mag).to(torch.int16)


def _dummy_blocks(q: torch.Tensor, wb: int, hb: int, h: int, v: int):
    """jccoefct.c compress_data's dummy blocks in the MCU padding: AC 0,
    DC copied from the block to the left (right edge) or from the last
    block of the MCU row above (bottom edge)."""
    bh, bw = q.shape[:2]
    if wb < bw:
        q[:hb, wb:] = 0
        q[:hb, wb:, 0] = q[:hb, wb - 1:wb, 0]
    if hb < bh:
        q[hb:] = 0
        src = q[hb - 1, h - 1::h, 0]                 # each MCU's last column
        q[hb:, :, 0] = src.repeat_interleave(h)[None]
    return q


def encode(img, quality: int = 95, sampling: str = "420",
           restart_interval: int = 0, progressive: bool = False,
           device="cuda") -> bytes:
    """cv2.imencode(".jpg", img) at these settings: img u8 [H, W, 3] BGR
    or [H, W] gray (numpy or torch). The pixel stages run on the device;
    the bytes equal libjpeg-turbo's for baseline files."""
    x = _u8_image(img, device, (2, 3), 3)
    if x.ndim == 2:
        return _encode_planes([x.to(torch.int32)], [(1, 1, 1, 0)], quality,
                              restart_interval, progressive)
    if sampling not in SAMPLING:
        raise JPEGError(f"sampling {sampling!r}: one of {sorted(SAMPLING)}")
    lh, lv = SAMPLING[sampling]
    return _encode_planes(list(rgb_to_ycc(x)),
                          [(1, lh, lv, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
                          quality, restart_interval, progressive)


def encode_cmyk(cmyk, quality: int = 95, device="cuda") -> bytes:
    """A baseline Adobe CMYK JPEG (APP14 transform 0, four 1 x 1
    components, the luma quantisation table) of u8 [H, W, 4] samples
    stored as given: in Adobe's inverted convention when the caller
    follows it, as PIL writes CMYK. cv2 writes no such file, but reads
    one; ``imread`` gives the same BGR."""
    x = _u8_image(cmyk, device, (3,), 4)
    return _encode_planes([x[..., c].to(torch.int32) for c in range(4)],
                          [(ord(k), 1, 1, 0) for k in "CMYK"], quality, 0,
                          False)


def _u8_image(img, device, ndims, channels) -> torch.Tensor:
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(img) if not isinstance(
        img, torch.Tensor) else img).to(dev)
    if x.dtype != torch.uint8 or x.ndim not in ndims or (
            x.ndim == 3 and x.shape[2] != channels):
        shapes = " or ".join(["[H, W]"] * (2 in ndims)
                             + [f"[H, W, {channels}]"])
        raise JPEGError(f"encode takes u8 {shapes}, got {x.dtype} "
                        f"{tuple(x.shape)}")
    H, W = x.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise JPEGError(f"image size {W}x{H} out of JPEG's range")
    return x


def _encode_planes(planes, comps, quality, restart_interval,
                   progressive) -> bytes:
    """The component planes (int32 [H, W] each, on the device) with comps
    [(id, h, v, table)] -> the file's bytes: downsampling, forward DCT and
    quantisation on the device, the entropy coding in csrc/jpeg.cpp."""
    H, W = planes[0].shape
    qt = quality_tables(quality)
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    out_coef = []
    for p, (cid, h, v, tq) in zip(planes, comps):
        hr, vr = hmax // h, vmax // v
        wb = -(-(-(-W * h // hmax)) // 8)
        hb = -(-(-(-H * v // vmax)) // 8)
        bw, bh = mcux * h, mcuy * v
        # rows to a whole row group, columns to the output blocks' width
        full = _pad_edges(p, -(-H // vmax) * vmax, wb * 8 * hr)
        ds = downsample(full, hr, vr)
        ds = _pad_edges(ds, bh * 8, bw * 8)
        blocks = ds.reshape(bh, 8, bw, 8).permute(0, 2, 1, 3).reshape(
            -1, 8, 8) - 128
        q = quantize(fdct_islow(blocks), qt[tq]).reshape(bh, bw, 64)
        out_coef.append(_dummy_blocks(q, wb, hb, h, v))
    coef = np.concatenate([c.cpu().numpy().reshape(-1) for c in out_coef])
    comp_arr = np.asarray(comps, np.int32)
    qt16 = qt.astype(np.uint16)
    cap = coef.size * 4 + 65536
    out = np.empty(cap, np.uint8)
    lib = native()
    n = lib.jpeg_encode(coef.ctypes.data, W, H, len(comps),
                        comp_arr.ctypes.data, qt16.ctypes.data,
                        int(restart_interval), int(bool(progressive)),
                        out.ctypes.data, cap)
    if n < 0:
        _raise(lib, "JPEG encode")
    return out[:n].tobytes()


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation tag (1-8) of a JPEG's APP1, 1 without one."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        if m in (0xDA, 0xD9):
            break
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos + 4:pos + 2 + ln]
        if m == 0xE1 and seg[:6] == b"Exif\0\0":
            return tiff_orientation(seg[6:])
        pos += 2 + ln
    return 1


def tiff_orientation(t: bytes) -> int:
    """The orientation tag (1-8) of TIFF bytes (a JPEG's APP1 after
    "Exif\\0\\0", a PNG's eXIf chunk), 1 without one."""
    if len(t) < 8 or t[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if t[:2] == b"II" else ">"
    ifd = struct.unpack_from(e + "I", t, 4)[0]
    if ifd + 2 > len(t):
        return 1
    n = struct.unpack_from(e + "H", t, ifd)[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(t):
            break
        tag, typ, cnt = struct.unpack_from(e + "HHI", t, at)
        if tag == 0x0112 and typ == 3:
            v = struct.unpack_from(e + "H", t, at + 8)[0]
            return v if 1 <= v <= 8 else 1
    return 1
