"""Two-view structure from motion.

Port of slam_maskrcnn_tpu/sfm/two_view.py (the reference's experimental
``slam()`` path, src/main.py:104-203, src/utils.py:39-185) without cv2:

* ``match_features``: SIFT (ops/sift.py) on both gray images and the
  ratio-test matching of ops/match.py, on ``device``;
* ``triangulate``: DLT and Gauss-Newton refinement of the reprojection
  error, batched over the points in float64 torch on the points' device,
  with the JAX function's per-point stops (a point at infinity, a
  singular normal matrix);
* ``estimate_rt_from_e``: the four decompositions of E
  (ops/essential.py) voted on by positive depth;
* ``slam_two_view``: match, essential-matrix RANSAC (ops/essential.py,
  its draws from ``seed``; the JAX package's cv2 draws from cv::RNG), the
  pose, the triangulated points; with ``depth_estimate``, the
  uncalibrated rectification (ops/rectify.py), the two perspective warps
  (ops/warp.py) and SGBM's disparity (ops/sgbm.py) on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.ops.blur import rgb_to_gray
from slam_maskrcnn_tpu_torch.ops.essential import (decompose_essential_mat,
                                                   find_essential_mat)
from slam_maskrcnn_tpu_torch.ops.match import ratio_matches
from slam_maskrcnn_tpu_torch.ops.sift import detect_and_compute


def _gray(img) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) for a u8 BGR image; a gray one
    as it is."""
    img = img.cpu().numpy() if isinstance(img, torch.Tensor) else \
        np.asarray(img)
    return rgb_to_gray(img[..., ::-1]) if img.ndim == 3 else img


def _sift_match(t1: torch.Tensor, t2: torch.Tensor, ratio: float,
                max_matches: int, mark):
    """(pts1, pts2, keypoints1, keypoints2) of two u8 gray tensors:
    SIFT, then the ratio-test matches; ``mark`` after each."""
    (k1, d1), (k2, d2) = detect_and_compute(t1), detect_and_compute(t2)
    mark("sift")
    pts1 = pts2 = np.zeros((0, 2))
    if len(d1) and len(d2) >= 2:
        q, t, _ = ratio_matches(d1, d2, ratio, max_matches)
        q, t = q.cpu().numpy(), t.cpu().numpy()
        pts1 = k1["pt"][q].astype(np.float64)
        pts2 = k2["pt"][t].astype(np.float64)
    mark("match")
    return pts1, pts2, k1, k2


def _tensors(img1, img2, dev):
    g1, g2 = _gray(img1), _gray(img2)
    return g1, g2, *(torch.from_numpy(np.ascontiguousarray(g)).to(dev)
                     for g in (g1, g2))


def match_features(img1, img2, ratio: float = 0.75, max_matches: int = 500,
                   device="cuda"):
    """SIFT + ratio-test matching (utils.py:151-185) of two u8 images
    (gray, or BGR), on ``device``. Returns (pts1 [N, 2], pts2 [N, 2])
    float64 numpy, best match first."""
    _, _, t1, t2 = _tensors(img1, img2, resolve_device(device))
    return _sift_match(t1, t2, ratio, max_matches, lambda stage: None)[:2]


def triangulate(P1, P2, pts1, pts2, gn_iters: int = 5,
                device="cuda") -> np.ndarray:
    """DLT triangulation + Gauss-Newton reprojection refinement
    (utils.py:39-105) of every point at once, float64 on ``device``.
    Returns [N, 3] float64 numpy."""
    dev = resolve_device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    P1, P2, p1, p2 = f64(P1), f64(P2), f64(pts1), f64(pts2)
    N = p1.shape[0]
    if N == 0:
        return np.zeros((0, 3))
    A = torch.stack([p1[:, 0:1] * P1[2] - P1[0], p1[:, 1:2] * P1[2] - P1[1],
                     p2[:, 0:1] * P2[2] - P2[0], p2[:, 1:2] * P2[2] - P2[1]],
                    1)
    Xh = torch.linalg.svd(A).Vh[:, -1]
    x = Xh[:, :3] / Xh[:, 3:4]
    live = torch.ones(N, dtype=torch.bool, device=dev)
    eye = torch.eye(3, dtype=torch.float64, device=dev) * 1e-9
    for _ in range(gn_iters):
        xh = torch.cat([x, torch.ones_like(x[:, :1])], 1)
        r, J, finite = [], [], live.clone()
        for P, pt in ((P1, p1), (P2, p2)):
            p = xh @ P.T
            finite &= p[:, 2].abs() >= 1e-12
            u, v = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
            r += [u - pt[:, 0], v - pt[:, 1]]
            J += [(P[0, :3] - u[:, None] * P[2, :3]) / p[:, 2:3],
                  (P[1, :3] - v[:, None] * P[2, :3]) / p[:, 2:3]]
        J = torch.stack(J, 1)
        r = torch.stack(r, 1)
        Jt = J.transpose(1, 2)
        dx, info = torch.linalg.solve_ex(Jt @ J + eye,
                                         -(Jt @ r[..., None]))
        step = finite & (info == 0)
        x = torch.where(step[:, None], x + dx[..., 0], x)
        live = step
    return x.cpu().numpy()


def _normalized(pts, K3):
    h = np.column_stack([pts, np.ones(len(pts))])
    return (np.linalg.inv(K3) @ h.T).T[:, :2]


def estimate_rt_from_e(E, pts1, pts2, K, device="cuda"):
    """The (R, t) of the four decompositions of E with the most points in
    front of both cameras (utils.py:118-148), the first on a tie; the
    points triangulated on ``device``. Returns (R [3, 3], t [3], votes)."""
    R1, R2, t = decompose_essential_mat(E)
    K3 = np.asarray(K, np.float64)[:3, :3]
    n1, n2 = _normalized(pts1, K3), _normalized(pts2, K3)
    best, best_votes = None, -1
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    for R in (R1, R2):
        for tt in (t, -t):
            P2 = np.hstack([R, tt.reshape(3, 1)])
            X = triangulate(P1, P2, n1, n2, gn_iters=0, device=device)
            z1 = X[:, 2]
            z2 = (R @ X.T + tt.reshape(3, 1))[2]
            votes = int(((z1 > 0) & (z2 > 0)).sum())
            if votes > best_votes:
                best_votes = votes
                best = (R, tt.reshape(3))
    return best[0], best[1], best_votes


def slam_two_view(img1, img2, K, depth_estimate: bool = True,
                  device="cuda", seed: int = 0, mark=None) -> dict:
    """The slam() pipeline (src/main.py:104-203) on ``device``: match, the
    essential matrix by RANSAC (draws from ``seed``), the pose, the
    triangulated points; with ``depth_estimate``, SGBM's disparity after
    the uncalibrated rectification. Returns a dict as the JAX function's
    (R, t, points, matches, positive_depth_votes, and "disparity", a
    float32 tensor on ``device``, when the rectification succeeds), plus
    E, the keypoints of both images, the rectified pair and its
    homographies. ``mark(stage)``,
    if given, is called after "sift", "match", "ransac", "pose",
    "rectify" and "sgbm"."""
    from slam_maskrcnn_tpu_torch.ops.rectify import \
        stereo_rectify_uncalibrated
    from slam_maskrcnn_tpu_torch.ops.sgbm import sgbm_disparity
    from slam_maskrcnn_tpu_torch.ops.warp import warp_perspective

    dev = resolve_device(device)
    mark = mark or (lambda stage: None)
    g1, g2, t1, t2 = _tensors(img1, img2, dev)
    pts1, pts2, k1, k2 = _sift_match(t1, t2, 0.75, 500, mark)
    if len(pts1) < 8:
        raise ValueError(f"too few matches: {len(pts1)}")
    K3 = np.asarray(K, np.float64)[:3, :3]
    E, inliers = find_essential_mat(pts1, pts2, K3, prob=0.999,
                                    threshold=1.0, seed=seed)
    if E is None:
        raise ValueError("no essential matrix: RANSAC found no model")
    mark("ransac")
    pts1, pts2 = pts1[inliers], pts2[inliers]
    R, t, votes = estimate_rt_from_e(E, pts1, pts2, K3, device=dev)
    n1, n2 = _normalized(pts1, K3), _normalized(pts2, K3)
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t.reshape(3, 1)])
    X = triangulate(P1, P2, n1, n2, device=dev)
    mark("pose")
    out = dict(R=R, t=t, points=X, matches=(pts1, pts2),
               positive_depth_votes=votes, E=E, keypoints=(k1, k2))
    if depth_estimate:
        Kinv = np.linalg.inv(K3)
        F = Kinv.T @ E @ Kinv
        size = (g1.shape[1], g1.shape[0])
        ok, H1, H2 = stereo_rectify_uncalibrated(pts1, pts2, F, size)
        if ok:
            r1 = warp_perspective(t1, H1, size)
            r2 = warp_perspective(t2, H2, size)
            out["rectified"], out["homographies"] = (r1, r2), (H1, H2)
            mark("rectify")
            out["disparity"] = sgbm_disparity(r1, r2).to(torch.float32) \
                / 16.0
            mark("sgbm")
    return out
