"""The port's Motion-JPEG AVI reader and writer (data/avi.py) against
OpenCV 5's FFMPEG backend on the CPU.

Reader, on files written by ``cv2.VideoWriter(..., "MJPG")`` (RIFF with
JUNK, odml, LIST INFO, COM markers in each frame): frame rate, size and
count equal to what ``cv2.VideoCapture`` reports; each frame bit-equal to
``cv2.imdecode`` of its own JPEG bytes. Against ``cv2.VideoCapture``'s
frames (ffmpeg's IDCT and swscale's chroma upsampling, not libjpeg's):
within 2 levels on frames without chroma (gray content); on colour
frames, where swscale upsamples chroma otherwise, the luma of the two
(cv2's BGR -> YCrCb) within 3 levels, each channel within 8 and their
mean difference under 1.5 levels (measured here: luma 2-3, channels 5-7,
mean 1.02-1.07). Writer: read back by
``cv2.VideoCapture`` with the same count, size and frame rate, its
frames bit-equal to the port's encoder on the input. Other containers
and codecs raise by name."""

import struct

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu_torch.data import avi, jpeg

torch.set_num_threads(2)


def frames(n, h, w, seed, gray=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for i in range(n):
        f = np.stack([128 + 90 * np.sin(xx / 23.0 + i + c)
                      * np.cos(yy / 31.0 - c) for c in range(3)], -1)
        f = np.clip(f + rng.normal(0, 3, f.shape), 0, 255).astype(np.uint8)
        if gray:
            f = np.repeat(f[..., :1], 3, -1)
        out.append(f)
    return out


def cv_write(path, fs, fps):
    h, w = fs[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                         (w, h))
    for f in fs:
        vw.write(f)
    vw.release()


def cv_read(path):
    cap = cv2.VideoCapture(str(path))
    meta = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return meta, out


@pytest.mark.parametrize("fps,size,n,gray", [
    (12.5, (48, 64), 5, True), (30.0, (60, 96), 4, False),
    (29.97, (480, 640), 3, True), (25.0, (120, 160), 6, False)])
def test_reader_matches_videocapture(tmp_path, fps, size, n, gray):
    path = tmp_path / "in.avi"
    cv_write(path, frames(n, *size, seed=n, gray=gray), fps)
    r = avi.AviReader(path)
    (cfps, ccount, cw, ch), cframes = cv_read(path)
    assert r.fps == pytest.approx(cfps, rel=1e-12)
    assert (len(r), r.width, r.height) == (ccount, cw, ch) == (
        len(cframes), size[1], size[0])
    for i, cf in enumerate(cframes):
        data = r.frame_bytes(i)
        assert data[:2] == b"\xff\xd8"
        mine = r.read(i, device="cpu")
        np.testing.assert_array_equal(
            mine, cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR))
        d = np.abs(mine.astype(np.int16) - cf)
        if gray:
            assert d.max() <= 2
        else:
            luma = [cv2.cvtColor(a, cv2.COLOR_BGR2YCrCb)[..., 0].astype(int)
                    for a in (mine, cf)]
            assert np.abs(luma[0] - luma[1]).max() <= 3
            assert d.max() <= 8 and d.mean() < 1.5


@pytest.mark.parametrize("fps,size", [(10.0, (48, 64)), (29.97, (61, 97)),
                                      (7.5, (240, 320))])
def test_writer_read_back_by_videocapture(tmp_path, fps, size):
    fs = frames(4, *size, seed=1)
    path = tmp_path / "out.avi"
    w = avi.AviWriter(path, fps, (size[1], size[0]), device="cpu")
    for f in fs:
        w.write(f)
    w.release()
    (cfps, ccount, cw, ch), cframes = cv_read(path)
    assert cfps == pytest.approx(fps, rel=1e-9)
    assert (ccount, cw, ch, len(cframes)) == (4, size[1], size[0], 4)
    r = avi.AviReader(path)
    assert (len(r), r.width, r.height) == (4, size[1], size[0])
    assert r.fps == pytest.approx(fps, rel=1e-9)
    for i, f in enumerate(fs):
        assert r.frame_bytes(i) == jpeg.encode(f, 95, device="cpu")
        np.testing.assert_array_equal(
            r.read(i, device="cpu"),
            cv2.imdecode(np.frombuffer(r.frame_bytes(i), np.uint8), 1))


def test_writer_streams_and_stops_at_the_avi1_limit(tmp_path, monkeypatch):
    """Each frame is on disk once written; a frame that would take the
    file past the AVI 1.0 limit raises, and release() keeps the frames
    before it as a whole file that cv2.VideoCapture reads."""
    fs = frames(6, 48, 64, seed=4)
    sizes = [len(jpeg.encode(f, 95, device="cpu")) for f in fs]
    path = tmp_path / "cut.avi"
    w = avi.AviWriter(path, 10.0, (64, 48), device="cpu")
    head = path.stat().st_size
    keep = 3
    chunks = [8 + n + (n & 1) for n in sizes]
    monkeypatch.setattr(avi, "AVI1_LIMIT",
                        head + sum(chunks[:keep]) + 8 + 16 * keep)
    for k in range(keep):
        w.write(fs[k])
        assert path.stat().st_size == head + sum(chunks[:k + 1])
    with pytest.raises(ValueError, match="AVI 1.0 limit"):
        w.write(fs[keep])
    assert path.stat().st_size == head + sum(chunks[:keep])
    w.release()
    assert path.stat().st_size == avi.AVI1_LIMIT
    (cfps, ccount, cw, ch), cframes = cv_read(path)
    assert (cfps, ccount, cw, ch, len(cframes)) == (10.0, keep, 64, 48, keep)
    with avi.AviReader(path) as r:
        assert len(r) == keep
        for i in range(keep):
            assert r.frame_bytes(i) == jpeg.encode(fs[i], 95, device="cpu")


def test_frames_without_huffman_tables_use_annex_k(tmp_path):
    """An AVI1-style frame (no DHT segment) decodes with the standard
    tables, as libjpeg's Motion-JPEG support does."""
    f = frames(1, 32, 48, seed=2)[0]
    data = jpeg.encode(f, 90, device="cpu")
    stripped, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            stripped += data[pos:pos + 2 + n]
        pos += 2 + n
    stripped += data[pos:]
    assert b"\xff\xc4" not in stripped[:pos]
    np.testing.assert_array_equal(jpeg.decode(bytes(stripped), "cpu").numpy(),
                                  jpeg.decode(data, "cpu").numpy())


def test_other_containers_and_codecs_raise(tmp_path):
    mp4 = tmp_path / "x.mp4"
    mp4.write_bytes(b"\0\0\0\x18ftypisom" + b"\0" * 32)
    with pytest.raises(ValueError, match="not an AVI"):
        avi.AviReader(mp4)
    path = tmp_path / "in.avi"
    cv_write(path, frames(2, 32, 48, seed=3), 10)
    data = bytearray(path.read_bytes())
    at = data.index(b"strf") + 8 + 16
    data[at:at + 4] = b"XVID"
    h = data.index(b"strh") + 8 + 4
    data[h:h + 4] = b"XVID"
    bad = tmp_path / "xvid.avi"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="XVID"):
        avi.AviReader(bad)
