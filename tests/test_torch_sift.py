"""The port's SIFT (ops/sift.py) against ``cv2.SIFT_create()
.detectAndCompute`` on the CPU: the JAX package's two-view input (a
200 x 260 blurred random texture, tests/test_samples.py) and one 480 x
640 view of the synthetic two-view scene (sfm/scene.py).

Bars, each cv2 keypoint paired to a port keypoint of the same octave
with ``pt`` within 0.01 px and angle within 1 degree: at least 95% of
cv2's keypoints paired (100% on both inputs when written), each paired
descriptor within 2% of the cv2 descriptor's norm, and at least 95% as
many port keypoints as cv2's and at most 105%. The pieces: the Gaussian
taps of cv::getGaussianKernel, the exact 2x upsampling, ``fast_atan2``
within 0.01 degree of atan2 (OpenCV's polynomial is that accurate), the
keypoints in cv2's order.
"""

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu_torch.ops import sift
from slam_maskrcnn_tpu_torch.sfm.scene import two_view_scene

torch.set_num_threads(2)

PT_TOL = 0.01        # px
ANGLE_TOL = 1.0      # degrees
DESC_TOL = 0.02      # of the cv2 descriptor's norm
MIN_PAIRED = 0.95


def _texture():
    rng = np.random.default_rng(2)
    tex = (rng.random((200, 260)) * 255).astype(np.uint8)
    return cv2.GaussianBlur(tex, (5, 5), 1.0)


IMAGES = {"texture": _texture, "scene": lambda: two_view_scene(0)[0]}


@pytest.fixture(scope="module", params=sorted(IMAGES))
def both(request):
    img = IMAGES[request.param]()
    k, d = cv2.SIFT_create().detectAndCompute(img, None)
    tk, td = sift.detect_and_compute(torch.from_numpy(img))
    return request.param, k, d, tk, td.numpy()


def _pairs(k, tk):
    cpt = np.array([p.pt for p in k], np.float32)
    coct = np.array([p.octave for p in k]) & 255
    cang = np.array([p.angle for p in k])
    toct = tk["octave"] & 255
    out = []
    for i in range(len(k)):
        dd = np.abs(tk["pt"] - cpt[i]).max(1)
        da = np.abs((tk["angle"] - cang[i] + 180) % 360 - 180)
        m = np.nonzero((dd <= PT_TOL) & (toct == coct[i])
                       & (da <= ANGLE_TOL))[0]
        if len(m):
            out.append((i, m[np.argmin(dd[m] + da[m])]))
    return out


def test_keypoints_pair_with_cv2(both):
    name, k, d, tk, td = both
    assert len(k) > 500, name
    pairs = _pairs(k, tk)
    share = len(pairs) / len(k)
    assert share >= MIN_PAIRED, (name, share)
    assert 0.95 * len(k) <= len(tk["pt"]) <= 1.05 * len(k)
    assert td.shape == (len(tk["pt"]), 128) and td.dtype == np.float32


def test_descriptors_within_two_percent(both):
    name, k, d, tk, td = both
    pairs = _pairs(k, tk)
    err = np.array([np.linalg.norm(td[j] - d[i]) / np.linalg.norm(d[i])
                    for i, j in pairs])
    assert (err <= DESC_TOL).all(), (name, float(err.max()))
    assert np.array_equal(td, np.rint(td)) and td.max() <= 255


def test_order_is_cv2s(both):
    """Sorted by x, then y (cv2's removeDuplicatedSorted), no exact
    duplicates."""
    _, _, _, tk, _ = both
    pt = tk["pt"]
    assert (np.diff(pt[:, 0]) >= 0).all()
    key = np.column_stack([pt, tk["size"], tk["angle"]])
    assert len(np.unique(key, axis=0)) == len(key)


@pytest.mark.parametrize("sigma", [1.2489996, 1.2262735, 1.5450077,
                                   1.9465878, 2.452547])
def test_gaussian_kernel_is_opencvs(sigma):
    want = cv2.getGaussianKernel(int(np.rint(sigma * 8 + 1)) | 1, sigma,
                                 cv2.CV_32F).ravel()
    np.testing.assert_array_equal(sift.gaussian_kernel(sigma), want)


def test_upsample_is_cv2_resize():
    img = np.random.default_rng(1).integers(0, 256, (23, 31)).astype(
        np.float32)
    want = cv2.resize(img, (62, 46), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(
        sift._upsample2(torch.from_numpy(img)).numpy(), want)


def test_blur_close_to_cv2():
    img = np.random.default_rng(2).random((40, 52)).astype(np.float32) * 255
    want = cv2.GaussianBlur(img, (0, 0), 1.6)
    got = sift.gaussian_blur(torch.from_numpy(img), 1.6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_fast_atan2():
    rng = np.random.default_rng(3)
    y, x = rng.normal(size=(2, 10000)).astype(np.float32)
    got = sift.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.degrees(np.arctan2(y, x)) % 360
    err = np.abs((got - want + 180) % 360 - 180)
    assert err.max() < 0.01
    assert ((got >= 0) & (got < 360)).all()


def test_takes_only_u8_gray():
    with pytest.raises(TypeError):
        sift.detect_and_compute(torch.zeros(8, 8))
