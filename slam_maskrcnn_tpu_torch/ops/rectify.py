"""``cv2.stereoRectifyUncalibrated`` without cv2: Hartley's rectification
of two views from their fundamental matrix and matches. A handful of 3x3
products and one small least-squares fit, so it runs on the host in
float64 numpy, as OpenCV does.

F is made rank 2 by its SVD; matches farther than ``threshold`` px from
either epipolar line (lines scaled to unit normals) are dropped; H2 moves
the image centre (cvRound((size - 1) / 2)) to the origin, rotates the
second epipole (F's left null vector, its last coordinate made positive)
onto the x axis and sends it to infinity; H1 = Ha H2 ([e2]x F + e2 1^T),
Ha the affine row [a, b, c] that best maps the first view's transformed
x onto the second's (least squares); both are mirrored about the centre
when the rotated epipole lay on the negative x axis.
"""

from __future__ import annotations

import numpy as np


def _epilines(pts: np.ndarray, F: np.ndarray, which: int) -> np.ndarray:
    """cv::computeCorrespondEpilines: lines [N, 3] in the other image of
    points in image ``which`` (1 or 2), scaled so a^2 + b^2 = 1."""
    h = np.column_stack([pts, np.ones(len(pts))])
    lines = h @ (F.T if which == 1 else F)
    t = lines[:, 0] ** 2 + lines[:, 1] ** 2
    t = np.where(t != 0, 1.0 / np.sqrt(np.where(t != 0, t, 1.0)), 1.0)
    return lines * t[:, None]


def _transform(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    h = np.column_stack([pts, np.ones(len(pts))]) @ H.T
    return h[:, :2] / h[:, 2:3]


def stereo_rectify_uncalibrated(pts1, pts2, F, size, threshold: float = 5.0):
    """= cv2.stereoRectifyUncalibrated(pts1, pts2, F, size, threshold):
    (ok, H1, H2) with H1, H2 [3, 3] float64 (None when no match is left
    within the threshold). ``size`` = (width, height)."""
    w, h = int(size[0]), int(size[1])
    U, s, Vt = np.linalg.svd(np.asarray(F, np.float64).reshape(3, 3))
    F = U @ np.diag([s[0], s[1], 0.0]) @ Vt
    m1 = np.asarray(pts1, np.float64).reshape(-1, 2)
    m2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    if threshold > 0:
        l2, l1 = _epilines(m1, F, 1), _epilines(m2, F, 2)
        keep = ((np.abs(m1[:, 0] * l1[:, 0] + m1[:, 1] * l1[:, 1] + l1[:, 2])
                 <= threshold)
                & (np.abs(m2[:, 0] * l2[:, 0] + m2[:, 1] * l2[:, 1]
                          + l2[:, 2]) <= threshold))
        m1, m2 = m1[keep], m2[keep]
        if not len(m1):
            return False, None, None
    e2 = U[:, 2] * (1.0 if U[2, 2] > 0 else -1.0)
    cx, cy = float(np.rint((w - 1) * 0.5)), float(np.rint((h - 1) * 0.5))
    T = np.array([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]])
    e = T @ e2
    mirror = e[0] < 0
    d = max(np.sqrt(e[0] * e[0] + e[1] * e[1]), np.finfo(np.float64).eps)
    a, b = e[0] / d, e[1] / d
    Rz = np.array([[a, b, 0.0], [-b, a, 0.0], [0.0, 0.0, 1.0]])
    T = Rz @ T
    e = Rz @ e
    invf = 0.0 if abs(e[2]) < 1e-6 * abs(e[0]) else -e[2] / e[0]
    Kp = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [invf, 0.0, 1.0]])
    iT = np.array([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]])
    H2 = iT @ (Kp @ T)
    e2x = np.array([[0.0, -e2[2], e2[1]], [e2[2], 0.0, -e2[0]],
                    [-e2[1], e2[0], 0.0]])
    H0 = H2 @ (e2x @ F + np.repeat(e2[:, None], 3, 1))
    m1t, m2t = _transform(H0, m1), _transform(H2, m2)
    A = np.column_stack([m1t, np.ones(len(m1t))])
    x = np.linalg.lstsq(A, m2t[:, 0], rcond=None)[0]
    H1 = np.array([[x[0], x[1], x[2]], [0.0, 1.0, 0.0],
                   [0.0, 0.0, 1.0]]) @ H0
    if mirror:
        MM = np.array([[-1.0, 0.0, 2 * cx], [0.0, -1.0, 2 * cy],
                       [0.0, 0.0, 1.0]])
        H1, H2 = MM @ H1, MM @ H2
    return True, H1, H2
