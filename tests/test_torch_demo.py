"""The port's samples/demo.py and the balloon video branch against the JAX
modules on the CPU, at a small configuration (ResNet-50, 256^2, the 81
COCO classes): the same numpy-seeded weights on both sides (the JAX
``init_params`` replaced by them, the port's carried across by
``models/weights.load_jax_params``), ``random_colors`` seeded on both
sides (the JAX one shuffles unseeded).

demo: the same JPEG inputs (and one unreadable file, skipped by both);
the written ``_det.png`` files must be pixel-equal, and each must read
back equal to the composite the port's ``main`` returns.

balloon video: an MJPEG AVI written by ``cv2.VideoWriter``, of gray
frames and of coloured ones; the JAX branch reads it with
``cv2.VideoCapture`` and writes with ``cv2.VideoWriter`` (ffmpeg's
decoder and encoder), the port's with data/avi.py (libjpeg's
arithmetic). Both outputs must have the input's frame count, size and
frame rate. The port's frames must be the port's JPEG of
``color_splash`` of its decoded input under its masks, bit for bit.
Gray frames, against the JAX branch frame by frame: the masks of the two
detections agree on at least 99.5% of the pixels (the inputs differ by
the two decoders' 2 levels, which moves mask edges: 99.86% measured),
and where they agree the two splashes (the JAX one recomputed from the
``cv2.VideoCapture`` frame) lie within 2 levels, the difference of the
two decoders on gray content. The two written files hold different
encoders' JPEGs (ffmpeg's quantisation is not cv2.imencode's), so they
are held to each other only within JPEG loss: PSNR over 35 dB. Coloured
frames, where a wrong mask shows: the two decoders differ there by up to
26 levels at colour edges, so the port's masks and splash are held equal
to the JAX model's on the same decoded pixels."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slam_maskrcnn_tpu.samples.coco as jcoco
import slam_maskrcnn_tpu_torch.samples.coco as tcoco
from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.samples import balloon as jballoon
from slam_maskrcnn_tpu.samples import demo as jdemo
from slam_maskrcnn_tpu.viz import visualize as jv
from slam_maskrcnn_tpu_torch.data import avi, jpeg
from slam_maskrcnn_tpu_torch.data.image_io import imread
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
from slam_maskrcnn_tpu_torch.samples import balloon as tballoon
from slam_maskrcnn_tpu_torch.samples import demo as tdemo
from slam_maskrcnn_tpu_torch.viz import visualize as tv
from test_torch_north_star import _steady_heads, _variables

torch.set_num_threads(2)

SMALL = dict(NAME="demo_small", BACKBONE="resnet50", IMAGE_MIN_DIM=256,
             IMAGE_MAX_DIM=256, POST_NMS_ROIS_INFERENCE=100,
             PRE_NMS_LIMIT=400, DETECTION_MAX_INSTANCES=8,
             COMPUTE_DTYPE="float32")
_RANDOM_COLORS = jv.random_colors


def _seeded_colors(N, bright=True, seed=None):
    return _RANDOM_COLORS(N, bright, seed=3)


@pytest.fixture(scope="module")
def weights():
    cfg = type("JSmall", (jcoco.CocoInferenceConfig,), SMALL)()
    jm = JMaskRCNN("inference", cfg)
    v = _steady_heads(_variables(jm, 11))
    # class 1 over the 0.7 confidence floor among 81 classes; boxes not
    # widened past the image and objectness at full scale, so proposals
    # and detections are not clipped or near-tied copies of one another
    # (those reorder under ulps at random weights)
    cls = v["params"]["fpn_classifier"]
    cls["mrcnn_class_logits"]["bias"][1] += 3.0
    cls["mrcnn_bbox_fc"]["bias"][6:8] -= 10.0
    v["params"]["rpn_model"]["rpn_class_raw"]["kernel"] *= 20.0
    return v


@pytest.fixture
def small(monkeypatch, weights):
    """Both packages' CocoInferenceConfig cut to SMALL; both models'
    init_params giving `weights`; random_colors seeded."""
    jp = jax.tree.map(jnp.asarray, weights)
    monkeypatch.setattr(jcoco, "CocoInferenceConfig", type(
        "JSmall", (jcoco.CocoInferenceConfig,), SMALL))
    monkeypatch.setattr(tcoco, "CocoInferenceConfig", type(
        "TSmall", (tcoco.CocoInferenceConfig,), SMALL))
    monkeypatch.setattr(JMaskRCNN, "init_params",
                        lambda self, *a, **k: setattr(self, "params", jp))
    monkeypatch.setattr(MaskRCNN, "init_params",
                        lambda self, seed=0: load_jax_params(
                            weights, self, device="cpu"))
    monkeypatch.setattr(jv, "random_colors", _seeded_colors)
    monkeypatch.setattr(tv, "random_colors", _seeded_colors)


def _photo(h, w, seed):
    """Bright rectangles and discs on a textured ground."""
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 90, (h, w, 3)).astype(np.uint8)
    for _ in range(4):
        c = tuple(int(v) for v in rng.integers(120, 256, 3))
        y, x = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 60))
        cv2.rectangle(img, (x, y), (x + int(rng.integers(30, 90)),
                                    y + int(rng.integers(25, 70))), c, -1)
        cv2.circle(img, (int(rng.integers(20, w - 20)),
                         int(rng.integers(20, h - 20))),
                   int(rng.integers(8, 30)), c[::-1], -1)
    return cv2.GaussianBlur(img, (3, 3), 0)


def test_demo_main_matches_jax(small, tmp_path, monkeypatch):
    paths = []
    for k, (h, w) in enumerate(((200, 300), (240, 180))):
        p = tmp_path / f"img{k}.jpg"
        cv2.imwrite(str(p), _photo(h, w, k))
        paths.append(str(p))
    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0 not really a jpeg")
    paths.append(str(bad))
    jout, tout = tmp_path / "j", tmp_path / "t"
    monkeypatch.setattr("sys.argv", ["demo", *paths, "--out", str(jout)])
    jdemo.main()
    recs = tdemo.main([*paths, "--out", str(tout), "--device", "cpu"])
    assert [os.path.basename(r["out"]) for r in recs] == \
        ["img0_det.png", "img1_det.png"]
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout))
    n_det = 0
    for r in recs:
        want = cv2.imread(str(jout / os.path.basename(r["out"])))
        got = imread(r["out"])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, r["composite"][:, :, ::-1])
        n_det += len(r["detections"]["class_ids"])
        assert set(r["ms"]) == {"read", "detect", "composite", "write"}
    assert n_det > 0                       # captions were drawn


def _video_branches(tmp_path, gray):
    """Both balloon video branches on one cv2.VideoWriter MJPG file of 3
    frames. Checks the outputs' count, size and frame rate, and the
    port's frames against the port's JPEG of ``color_splash`` of its
    decoded input under its masks; returns the JAX model and, per frame,
    (port's decoded input RGB, port's masks, port's splash, cv2's decoded
    input RGB, JAX masks on it, JAX splash, port's output BGR, JAX's
    output BGR)."""
    H, W, n, fps = 120, 160, 3, 15.0
    src = tmp_path / "in.avi"
    vw = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                         (W, H))
    for k in range(n):
        f = _photo(H, W, 10 + k)
        if gray:
            f = np.ascontiguousarray(np.repeat(f[..., 1:2], 3, -1))
        vw.write(f)
    vw.release()
    cfg = type("JSmall", (jcoco.CocoInferenceConfig,), SMALL)()
    jm = JMaskRCNN("inference", cfg)
    jm.init_params()
    tm = MaskRCNN("inference", type("TSmall", (tcoco.CocoInferenceConfig,),
                                    SMALL)(), device="cpu")
    tm.init_params()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath = jballoon.detect_and_color_splash(jm, video_path=str(src),
                                             out_dir=str(tmp_path / "j"))
    tpath = tballoon.detect_and_color_splash(tm, video_path=str(src),
                                             out_dir=str(tmp_path / "t"))
    jr, tr, sr = (avi.AviReader(p) for p in (jpath, tpath, src))
    assert (len(tr), tr.width, tr.height) == (len(sr), sr.width, sr.height) \
        == (len(jr), jr.width, jr.height) == (n, W, H)
    assert tr.fps == sr.fps == fps
    cap = cv2.VideoCapture(tpath)
    assert cap.get(cv2.CAP_PROP_FPS) == fps
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
    jcap = cv2.VideoCapture(str(src))
    out = []
    for i in range(n):
        rgb = np.ascontiguousarray(sr.read(i, device="cpu")[:, :, ::-1])
        tmask = tm.detect([rgb])[0]["masks"]
        tsplash = tballoon.color_splash(rgb, tmask)
        assert tr.frame_bytes(i) == jpeg.encode(
            np.ascontiguousarray(tsplash[:, :, ::-1]), device="cpu")
        ok, jbgr = jcap.read()
        assert ok
        jrgb = np.ascontiguousarray(jbgr[:, :, ::-1])
        jmask = jm.detect([jrgb], verbose=0)[0]["masks"]
        jsplash = jballoon.color_splash(jrgb, jmask)
        out.append((rgb, tmask, tsplash, jrgb, jmask, jsplash,
                    tr.read(i, device="cpu"), jr.read(i, device="cpu")))
    return jm, out


def _any(mask):
    return mask.any(-1) if mask.shape[-1] else np.zeros(mask.shape[:2], bool)


def test_balloon_video_matches_jax(small, tmp_path):
    _, frames = _video_branches(tmp_path, gray=True)
    colored = 0
    for rgb, tmask, tsplash, jrgb, jmask, jsplash, tout, jout in frames:
        tany, jany = _any(tmask), _any(jmask)
        agree = tany == jany
        assert agree.mean() >= 0.995
        colored += int(tany.sum())
        d = np.abs(tsplash.astype(np.int16) - jsplash)
        assert d[agree].max(initial=0) <= 2
        mse = float(((tout.astype(np.float64) - jout) ** 2).mean())
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) > 35.0
    assert colored > 0                      # the splash kept some pixels


def test_balloon_video_colour_matches_jax(small, tmp_path):
    """Coloured frames, where a wrong mask shows: the splash keeps colour
    inside the masks and grays the rest. ffmpeg's and libjpeg's decodes
    of these frames differ by up to 26 levels at colour edges (swscale's
    chroma upsampling), which moves the two branches' masks apart, so the
    port's frame is held against the JAX model's detection and
    ``color_splash`` of the same decoded pixels: masks and splash
    equal."""
    jm, frames = _video_branches(tmp_path, gray=False)
    colored = 0
    for rgb, tmask, tsplash, *_ in frames:
        smask = jm.detect([rgb], verbose=0)[0]["masks"]
        np.testing.assert_array_equal(_any(tmask), _any(smask))
        np.testing.assert_array_equal(tsplash,
                                      jballoon.color_splash(rgb, smask))
        kept = _any(tmask)
        colored += int((np.ptp(rgb.astype(np.int16), -1)[kept] > 40).sum())
    assert colored > 0            # kept pixels with colour a gray lacks


def test_import_without_jax_cv2_matplotlib(tmp_path):
    """The slice's modules run with jax, flax, cv2, h5py, PIL and
    matplotlib blocked and load no module of the JAX package; the demo
    defaults to the card (raising without one); the matplotlib functions
    raise ImportError rather than standing in quietly."""
    import subprocess
    import sys

    code = r"""
import sys
for m in ("jax", "flax", "cv2", "h5py", "PIL", "matplotlib"):
    sys.modules[m] = None
import numpy as np
from slam_maskrcnn_tpu_torch.data import avi, image_io, jpeg
from slam_maskrcnn_tpu_torch.samples import balloon, demo
from slam_maskrcnn_tpu_torch.viz import font, visualize
bad = [m for m in sys.modules if m.startswith("slam_maskrcnn_tpu.")
       or m == "slam_maskrcnn_tpu"]
assert not bad, bad
img = np.full((24, 40, 3), 90, np.uint8)
data = jpeg.encode(img, device="cpu")
assert (jpeg.decode(data, "cpu").numpy() == image_io.imdecode(
    data, device="cpu")).all()
font.put_text(img, "person 0.987", (1, 12), 0, 0.4, (255, 0, 0), 1)
assert img.max() == 255
try:
    visualize.display_images([img])
    print("no ImportError")
except ImportError:
    print("ImportError")
root = sys.argv[1]
image_io.imwrite(root + "/a.jpg", img, device="cpu")
try:
    demo.main([root + "/a.jpg", "--out", root])
    print("no error")
except RuntimeError as e:
    print("CUDA" in str(e))
"""
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    if not torch.cuda.is_available():
        assert r.stdout.split() == ["ImportError", "True"], r.stdout
