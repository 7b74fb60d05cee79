"""Motion-JPEG AVI reader and writer, without cv2.

Takes the place of ``cv2.VideoCapture`` / ``cv2.VideoWriter(...,
"MJPG")`` in the balloon sample's video branch. Only Motion-JPEG in an
AVI container is read or written; any other container or codec raises
``ValueError`` naming what was found.

Reader: walks RIFF ``AVI `` (and OpenDML ``AVIX`` extensions): the
``LIST hdrl`` with ``avih`` and each stream's ``LIST strl`` (``strh``,
``strf``), then the frames of the first video stream in ``LIST movi``
(``NNdc`` / ``NNdb`` chunks, also inside ``LIST rec``), in file order;
``JUNK``, ``LIST INFO``, ``LIST odml`` / ``dmlh``, index chunks and
``idx1`` are skipped. The frame rate is ``dwRate / dwScale`` of the video
``strh``; the size is ``strf``'s. The file is mapped, not read: only the
chunk headers are walked when it is opened, and a frame's bytes are read
when it is asked for. A frame is decoded by data/jpeg.py (Annex K
Huffman tables where the frame carries none, the AVI1 convention). Empty
chunks (dropped frames) are skipped.

Writer: RIFF ``AVI `` with ``avih``, one ``vids``/``MJPG`` stream,
``LIST movi`` of ``00dc`` frames encoded by data/jpeg.py (quality 95,
4:2:0, baseline) and an ``idx1`` index, every frame a key frame. Each
frame goes to the file as it is written; ``release()`` appends ``idx1``
and rewrites the headers (fixed in length) with the final counts and
sizes. The writer stays within the AVI 1.0 limit of 1 GiB a file (it
writes no OpenDML ``AVIX``): a frame that would cross it raises, and the
frames before it stay in the file ``release()`` closes. The rate is
written as the fraction nearest to ``fps`` with a denominator up to
1001.
"""

from __future__ import annotations

import mmap
import struct
from fractions import Fraction

import numpy as np

from slam_maskrcnn_tpu_torch.data import jpeg

MJPEG_FOURCCS = (b"MJPG", b"mjpg")
# bytes of an AVI 1.0 file that OpenDML-aware readers still take whole
AVI1_LIMIT = 1 << 30


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, body start, body size, list type or None) of each chunk
    in data[pos:end]."""
    while pos + 8 <= end:
        cid = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + n > end:
            n = end - pos - 8                  # a truncated last chunk
        kind = data[pos + 8:pos + 12] if cid in (b"RIFF", b"LIST") else None
        yield cid, pos + 8, n, kind
        pos += 8 + n + (n & 1)


class AviReader:
    """The frames of an MJPEG AVI: ``fps``, ``width``, ``height``,
    ``len()``, ``frame_bytes(i)`` and ``read(i, device)`` (BGR u8)."""

    def __init__(self, path):
        with open(path, "rb") as f:
            head = f.read(12)
            if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                raise ValueError(f"{path}: not an AVI file (found "
                                 f"{head[:4]!r} / {head[8:12]!r}); only "
                                 f"Motion-JPEG AVI is read")
            self.data = data = mmap.mmap(f.fileno(), 0,
                                         access=mmap.ACCESS_READ)
        self.fps = self.width = self.height = None
        self._video = None                 # the video stream's number
        self.n_declared = 0
        self.frames: list[tuple[int, int]] = []
        streams = []
        for cid, body, n, kind in _chunks(data, 0, len(data)):
            if cid != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
                continue
            for c2, b2, n2, k2 in _chunks(data, body + 4, body + n):
                if c2 == b"LIST" and k2 == b"hdrl":
                    streams = self._hdrl(b2 + 4, b2 + n2)
                elif c2 == b"LIST" and k2 == b"movi":
                    self._movi(b2 + 4, b2 + n2)
        if self._video is None:
            found = [s[0] for s in streams]
            raise ValueError(f"{path}: no video stream (streams: {found})")
        if not self.frames and self.n_declared:
            raise ValueError(f"{path}: no frame chunks in LIST movi")

    def _hdrl(self, pos, end):
        streams = []
        for cid, body, n, kind in _chunks(self.data, pos, end):
            if cid != b"LIST" or kind != b"strl":
                continue
            strh = strf = None
            for c2, b2, n2, _ in _chunks(self.data, body + 4, body + n):
                if c2 == b"strh":
                    strh = self.data[b2:b2 + n2]
                elif c2 == b"strf":
                    strf = self.data[b2:b2 + n2]
            if strh is None:
                raise ValueError("AVI stream without a strh header")
            ftype, handler = strh[:4], strh[4:8]
            streams.append((ftype, handler))
            if ftype != b"vids" or self._video is not None:
                continue
            if strf is None or len(strf) < 20:
                raise ValueError("AVI video stream without a strf header")
            compression = strf[16:20]
            if (compression not in MJPEG_FOURCCS
                    and handler not in MJPEG_FOURCCS):
                raise ValueError(
                    f"AVI video codec {compression!r} (handler "
                    f"{handler!r}): only Motion-JPEG (MJPG) is read")
            scale, rate = struct.unpack_from("<II", strh, 20)
            self.n_declared = struct.unpack_from("<I", strh, 32)[0]
            if scale == 0 or rate == 0:
                raise ValueError("AVI video stream with a zero rate")
            self.fps = rate / scale
            w, h = struct.unpack_from("<ii", strf, 4)
            self.width, self.height = int(w), abs(int(h))
            self._video = len(streams) - 1
        return streams

    def _movi(self, pos, end):
        tag = b"%02d" % (self._video or 0)
        for cid, body, n, kind in _chunks(self.data, pos, end):
            if cid == b"LIST" and kind == b"rec ":
                self._movi(body + 4, body + n)
            elif cid[:2] == tag and cid[2:] in (b"dc", b"db") and n > 0:
                self.frames.append((body, n))

    def close(self) -> None:
        self.data.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return len(self.frames)

    def frame_bytes(self, i: int) -> bytes:
        pos, n = self.frames[i]
        return self.data[pos:pos + n]

    def read(self, i: int, device="cuda") -> np.ndarray:
        """Frame i as BGR u8 [H, W, 3]."""
        img = jpeg.decode(self.frame_bytes(i), device).cpu().numpy()
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + (
        b"\0" if len(body) & 1 else b"")


class AviWriter:
    """cv2.VideoWriter(path, fourcc("MJPG"), fps, (width, height)):
    ``write(bgr)`` then ``release()``."""

    def __init__(self, path, fps: float, size, quality: int = 95,
                 device="cuda"):
        self.path, self.quality, self.device = path, quality, device
        self.width, self.height = int(size[0]), int(size[1])
        frac = Fraction(fps).limit_denominator(1001)
        self.rate, self.scale = frac.numerator, frac.denominator
        if self.rate <= 0:
            raise ValueError(f"fps {fps} must be positive")
        self.index: list[tuple[int, int]] = []   # (offset in movi, size)
        self.biggest = 0
        self.movi_bytes = 4                       # the "movi" fourcc
        self._f = open(path, "wb")
        self._f.write(self._headers())
        self._f.flush()

    def _headers(self) -> bytes:
        """RIFF, ``LIST hdrl`` and the ``LIST movi`` header for the frames
        written so far; the same length whatever their number."""
        w, h, n, big = self.width, self.height, len(self.index), self.biggest
        usec = int(round(1e6 * self.scale / self.rate))
        avih = struct.pack("<14I", usec, big * self.rate // self.scale,
                           0, 0x10, n, 0, 1, big, w, h, 0, 0, 0, 0)
        strh = (b"vidsMJPG" + struct.pack(
            "<IHHIIIIIIiI4h", 0, 0, 0, 0, self.scale, self.rate, 0, n,
            big, -1, 0, 0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        hdrl = _chunk(b"LIST", b"hdrl" + _chunk(b"avih", avih) + _chunk(
            b"LIST", b"strl" + _chunk(b"strh", strh) + _chunk(b"strf",
                                                              strf)))
        riff = 4 + len(hdrl) + 8 + self.movi_bytes + 8 + 16 * n
        return (b"RIFF" + struct.pack("<I", riff) + b"AVI " + hdrl
                + b"LIST" + struct.pack("<I", self.movi_bytes) + b"movi")

    def write(self, bgr: np.ndarray) -> None:
        if bgr.shape[:2] != (self.height, self.width) or bgr.dtype != \
                np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
            raise ValueError(f"frame {bgr.dtype} {bgr.shape}: the writer "
                             f"takes u8 [{self.height}, {self.width}, 3]")
        if self._f is None:
            raise ValueError(f"{self.path}: write after release()")
        frame = jpeg.encode(bgr, quality=self.quality, device=self.device)
        chunk = _chunk(b"00dc", frame)
        n = len(self.index) + 1
        total = self._f.tell() + len(chunk) + 8 + 16 * n
        if total > AVI1_LIMIT:
            raise ValueError(
                f"{self.path}: frame {n - 1} would take the file to {total} "
                f"bytes, past the AVI 1.0 limit of {AVI1_LIMIT}; the "
                f"{n - 1} frames before it are kept by release()")
        self._f.write(chunk)
        self._f.flush()
        self.index.append((self.movi_bytes, len(frame)))
        self.movi_bytes += len(chunk)
        self.biggest = max(self.biggest, len(frame))

    def release(self) -> str:
        if self._f is not None:
            self._f.write(_chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc", 0x10, off, n)
                for off, n in self.index)))
            self._f.seek(0)
            self._f.write(self._headers())
            self._f.close()
            self._f = None
        return str(self.path)
