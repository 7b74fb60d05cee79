"""The port's cv2-free geometry ops against cv2 and the JAX package on the
CPU: ``warp_perspective`` (ops/warp.py), the brute-force matcher
(ops/match.py), the essential matrix (ops/essential.py) and the
uncalibrated rectification (ops/rectify.py).

Bars: warpPerspective bit-equal to cv2 (u8 gray, linear, border 0) on
random homographies at 37 x 53, 200 x 260 and 480 x 640; knnMatch's
indices and float32 distances equal to cv2's, and the ratio-test matches
the JAX package's (query, train, distance, order) on cv2's descriptors;
decomposeEssentialMat's {R1, R2} within 1e-9 of cv2's on the same E and
t equal up to its sign; on the synthetic three-plane scene
(sfm/scene.py), the port's RANSAC E gives R within 0.5 degree and t's
direction within 1 degree of the JAX package's (cv2's E), and both are
within 1 and 2 degrees of the ground truth; the five-point solver
recovers an exact E among its solutions; stereoRectifyUncalibrated's H1
and H2 within 1e-6 relative of cv2's.
"""

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.sfm import estimate_rt_from_e as j_rt
from slam_maskrcnn_tpu.sfm import match_features as j_match
from slam_maskrcnn_tpu_torch.ops import essential, match, rectify, sgbm, warp
from slam_maskrcnn_tpu_torch.sfm.scene import rotation, two_view_scene

torch.set_num_threads(2)

R_TOL, T_TOL = 0.5, 1.0          # degrees, the port against the JAX package
R_GT, T_GT = 1.0, 2.0            # degrees, both against the ground truth


def _deg(R1, R2):
    c = (np.trace(R1.T @ R2) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def _tdeg(a, b):
    a, b = np.ravel(a) / np.linalg.norm(a), np.ravel(b) / np.linalg.norm(b)
    return float(np.degrees(np.arccos(np.clip(abs(a @ b), -1, 1))))


@pytest.mark.parametrize("shape", [(37, 53), (200, 260), (480, 640)])
def test_warp_perspective_bit_equal(shape):
    h, w = shape
    rng = np.random.default_rng(h)
    for _ in range(4):
        src = cv2.GaussianBlur(rng.integers(0, 256, (h, w), dtype=np.uint8),
                               (5, 5), 1.0)
        H = np.eye(3) + rng.normal(0, 1, (3, 3)) * np.array(
            [[0.05, 0.05, 5], [0.05, 0.05, 5], [1e-4, 1e-4, 0.02]])
        want = cv2.warpPerspective(src, H, (w, h))
        got = warp.warp_perspective(torch.from_numpy(src), H, (w, h))
        np.testing.assert_array_equal(got.numpy(), want)


def test_fma32_t_is_fma32():
    rng = np.random.default_rng(0)
    a, b, c = rng.normal(size=(3, 100000)).astype(np.float32) * 300
    np.testing.assert_array_equal(
        warp.fma32_t(*map(torch.from_numpy, (a, b, c))).numpy(),
        warp.fma32(a, b, c))


@pytest.fixture(scope="module")
def descs():
    rng = np.random.default_rng(2)
    tex = cv2.GaussianBlur((rng.random((200, 260)) * 255).astype(np.uint8),
                           (5, 5), 1.0)
    img2 = cv2.warpAffine(tex, np.float32([[1, 0, 12], [0, 1, 0]]),
                          (260, 200))
    s = cv2.SIFT_create()
    return s.detectAndCompute(tex, None), s.detectAndCompute(img2, None)


def test_knn_match_equals_bfmatcher(descs):
    (_, d1), (_, d2) = descs
    raw = cv2.BFMatcher(cv2.NORM_L2).knnMatch(d1, d2, k=2)
    idx, dist = match.knn2(torch.from_numpy(d1), torch.from_numpy(d2))
    np.testing.assert_array_equal(
        idx.numpy(), [[m.trainIdx, n.trainIdx] for m, n in raw])
    np.testing.assert_array_equal(
        dist.numpy(), np.float32([[m.distance, n.distance] for m, n in raw]))


def test_ratio_matches_equal_the_jax_selection(descs):
    (_, d1), (_, d2) = descs
    raw = cv2.BFMatcher(cv2.NORM_L2).knnMatch(d1, d2, k=2)
    good = sorted([m for m, n in raw if m.distance < 0.75 * n.distance],
                  key=lambda m: m.distance)[:500]
    q, t, d = match.ratio_matches(torch.from_numpy(d1), torch.from_numpy(d2))
    np.testing.assert_array_equal(np.stack([q.numpy(), t.numpy()], 1),
                                  [[m.queryIdx, m.trainIdx] for m in good])
    np.testing.assert_array_equal(d.numpy(),
                                  np.float32([m.distance for m in good]))
    assert len(good) == 500


@pytest.fixture(scope="module")
def scene():
    img1, img2, K, R, t = two_view_scene(0)
    p1, p2 = j_match(img1, img2)
    return img1, img2, K, R, t, p1, p2


def test_decompose_equals_cv2(scene):
    *_, K, R, t, p1, p2 = scene
    E, _ = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC, prob=0.999,
                                threshold=1.0)
    rng = np.random.default_rng(0)
    for Em in (E, rng.normal(size=(3, 3))):
        a1, a2, at = cv2.decomposeEssentialMat(Em)
        b1, b2, bt = essential.decompose_essential_mat(Em)
        same = max(np.abs(a1 - b1).max(), np.abs(a2 - b2).max())
        swap = max(np.abs(a1 - b2).max(), np.abs(a2 - b1).max())
        assert min(same, swap) <= 1e-9
        assert min(np.abs(at - bt).max(), np.abs(at + bt).max()) <= 1e-9


def test_essential_ransac_pose(scene):
    *_, K, R, t, p1, p2 = scene
    Ej, mj = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC, prob=0.999,
                                  threshold=1.0)
    sel = mj.ravel() > 0
    Rj, tj, _ = j_rt(Ej, p1[sel], p2[sel], K)
    E, mask = essential.find_essential_mat(p1, p2, K, seed=0)
    assert E.shape == (3, 3) and mask.sum() >= 0.9 * len(p1)
    Rp, tp, _ = j_rt(E, p1[mask], p2[mask], K)
    assert _deg(Rp, Rj) <= R_TOL and _tdeg(tp, tj) <= T_TOL
    for Rx, tx in ((Rp, tp), (Rj, tj)):
        assert _deg(Rx, R) <= R_GT and _tdeg(tx, t) <= T_GT
    # a second seed draws other samples: a pose within the same bars
    E2, m2 = essential.find_essential_mat(p1, p2, K, seed=1)
    R2, t2, _ = j_rt(E2, p1[m2], p2[m2], K)
    assert _deg(R2, R) <= R_GT and _tdeg(t2, t) <= T_GT


def test_five_point_recovers_exact_e():
    rng = np.random.default_rng(4)
    R = rotation(0.1, -0.2, 0.05)
    t = np.array([0.6, -0.2, 0.3])
    X = rng.uniform([-1, -1, 3], [1, 1, 6], (5, 3))
    x1 = X[:, :2] / X[:, 2:]
    Y = X @ R.T + t
    x2 = Y[:, :2] / Y[:, 2:]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    E /= np.linalg.norm(E)
    sols = essential.five_point(x1[None], x2[None])[0]
    assert 1 <= len(sols) <= 10
    err = [min(np.abs(s / np.linalg.norm(s) - E).max(),
               np.abs(s / np.linalg.norm(s) + E).max()) for s in sols]
    assert min(err) < 1e-8


def test_rectify_equals_cv2(scene):
    *_, K, R, t, p1, p2 = scene
    E, m = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC, prob=0.999,
                                threshold=1.0)
    sel = m.ravel() > 0
    Ki = np.linalg.inv(K)
    F = Ki.T @ E @ Ki
    for a, b, thr in ((p1[sel], p2[sel], 5.0), (p1, p2, 5.0),
                      (p1[sel], p2[sel], 0.0)):
        ok, H1, H2 = cv2.stereoRectifyUncalibrated(a, b, F, (640, 480),
                                                   threshold=thr)
        ok2, G1, G2 = rectify.stereo_rectify_uncalibrated(a, b, F,
                                                          (640, 480), thr)
        assert ok and ok2
        for want, got in ((H1, G1), (H2, G2)):
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.fixture(scope="module")
def rectified(scene):
    """The JAX path's rectified pair of the scene (cv2's E, rectification
    and warps)."""
    img1, img2, K, R, t, p1, p2 = scene
    E, m = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC, prob=0.999,
                                threshold=1.0)
    sel = m.ravel() > 0
    Ki = np.linalg.inv(K)
    ok, H1, H2 = cv2.stereoRectifyUncalibrated(p1[sel], p2[sel],
                                               Ki.T @ E @ Ki, (640, 480))
    assert ok
    return (cv2.warpPerspective(img1, H1, (640, 480)),
            cv2.warpPerspective(img2, H2, (640, 480)), H1, H2)


def test_rectifying_warps_bit_equal(scene, rectified):
    img1, img2 = scene[:2]
    r1, r2, H1, H2 = rectified
    for img, H, want in ((img1, H1, r1), (img2, H2, r2)):
        got = warp.warp_perspective(torch.from_numpy(img), H, (640, 480))
        np.testing.assert_array_equal(got.numpy(), want)


def _cv2_sgbm(a, b):
    return cv2.StereoSGBM_create(minDisparity=0, numDisparities=64,
                                 blockSize=9).compute(a, b)


def test_sgbm_defaults_are_the_ported_ones():
    """Every parameter but the three given reads 0 (OpenCV substitutes
    P1 2, P2 5, pre-filter cap 15, disp12MaxDiff 1 when it computes)."""
    st = cv2.StereoSGBM_create(minDisparity=0, numDisparities=64,
                               blockSize=9)
    assert [st.getP1(), st.getP2(), st.getPreFilterCap(),
            st.getUniquenessRatio(), st.getDisp12MaxDiff(),
            st.getSpeckleWindowSize(), st.getSpeckleRange(),
            st.getMode()] == [0] * 8
    assert (sgbm.P1, sgbm.P2, sgbm.FTZERO, sgbm.DISP12_MAX_DIFF) == (
        2, 5, 15, 1)


def test_sgbm_bit_equal_on_the_rectified_pair(rectified):
    r1, r2 = rectified[:2]
    got = sgbm.sgbm_disparity(torch.from_numpy(r1), torch.from_numpy(r2))
    want = _cv2_sgbm(r1, r2)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.3


@pytest.mark.parametrize("shape,shift", [((37, 90), 5), ((64, 160), 23),
                                         ((50, 70), 2), ((20, 80), 4)])
def test_sgbm_bit_equal_on_random_pairs(shape, shift):
    rng = np.random.default_rng(shape[1])
    a = cv2.GaussianBlur(rng.integers(0, 256, shape, dtype=np.uint8),
                         (5, 5), 1.0)
    b = np.roll(a, -shift, axis=1)
    b[: shape[0] // 3] = rng.integers(0, 256, b[: shape[0] // 3].shape,
                                      dtype=np.uint8)
    got = sgbm.sgbm_disparity(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), _cv2_sgbm(a, b))


def test_sgbm_refuses_what_cv2_refuses():
    a = np.zeros((20, 68), np.uint8)
    with pytest.raises(cv2.error):
        _cv2_sgbm(a, a)
    with pytest.raises(ValueError, match="too narrow"):
        sgbm.sgbm_disparity(torch.from_numpy(a), torch.from_numpy(a))
