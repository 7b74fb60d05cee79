"""The essential matrix: ``cv2.findEssentialMat(..., method=RANSAC,
prob=0.999, threshold=1.0)`` and ``cv2.decomposeEssentialMat``, without
cv2.

Both are inherently serial and small (5-point hypotheses, 3x3 SVDs), so
they run on the host in float64 numpy, as OpenCV does; the hypotheses
are batched.

* ``find_essential_mat``: the points are normalised by the camera matrix
  and the threshold by the mean focal length (five-point.cpp); RANSAC
  draws 5-point samples from an explicit generator made from ``seed`` (so
  two runs on the same matches agree; OpenCV's ``cv::RNG`` draws are not
  repeated), solves each with the five-point method, scores every
  solution by OpenCV's error (the Sampson distance, rounded to float32)
  against the squared threshold in float32, keeps the solution with the
  most inliers (the first on a tie) and stops when OpenCV's adaptive
  count of iterations (``RANSACUpdateNumIters``, at most 1000) is spent.
* The five-point solver: the essential matrix is x E1 + y E2 + z E3 + E4
  over the null space of the 5 x 9 epipolar constraints; its 10 cubic
  constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0) are eliminated on
  the 10 cubic monomials, which leaves multiplication by x as a 10 x 10
  action matrix on the monomials of degree <= 2; its real eigenvectors
  give the solutions.
* ``decompose_essential_mat``: E = U D V^T with det U = det V = +1 (each
  negated otherwise); R1 = U W V^T, R2 = U W^T V^T, t = U's third column
  with W = [[0, 1, 0], [-1, 0, 0], [0, 0, 1]]. The pair {R1, R2} does not
  depend on the SVD's choice of signs; t does, up to its sign.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

MODEL_POINTS = 5
MAX_ITERS = 1000     # cv2.findEssentialMat's default maxIters
BATCH = 50           # hypotheses drawn and solved at once

# monomials of degree <= 3 in (x, y, z): the 10 cubic ones first (they
# are eliminated), then the basis of the action matrix, degree <= 2
_MONO = ([m for m in itertools.product(range(4), repeat=3) if sum(m) == 3]
         + [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
            (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)])
_INDEX = {m: i for i, m in enumerate(_MONO)}
_MUL = np.zeros((20, 20, 20))
for _a, _ma in enumerate(_MONO):
    for _b, _mb in enumerate(_MONO):
        _m = tuple(p + q for p, q in zip(_ma, _mb))
        if sum(_m) <= 3:
            _MUL[_a, _b, _INDEX[_m]] = 1.0


def _pmul(p, q):
    return np.einsum("...a,...b,abc->...c", p, q, _MUL)


def five_point(x1: np.ndarray, x2: np.ndarray) -> list:
    """Essential matrices [M, 3, 3] of batches of 5 normalised
    correspondences x1, x2 [B, 5, 2]: for each sample, the list of its
    real solutions."""
    B = x1.shape[0]
    a, b = x1[..., 0], x1[..., 1]
    c, d = x2[..., 0], x2[..., 1]
    one = np.ones_like(a)
    Q = np.stack([a * c, b * c, c, a * d, b * d, d, a, b, one], -1)
    _, _, vt = np.linalg.svd(Q, full_matrices=True)
    basis = vt[:, 5:9]                           # E1..E4 rows [B, 4, 9]
    # E as polynomials: entry (i, j) = x E1 + y E2 + z E3 + E4
    E = np.zeros((B, 3, 3, 20))
    for k, m in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]):
        E[..., _INDEX[m]] = basis[:, k].reshape(B, 3, 3)
    EEt = np.einsum("nika,njkb,abc->nijc", E, E, _MUL)
    tr = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    EEtE = np.einsum("nika,nkjb,abc->nijc", EEt, E, _MUL)
    cons = 2.0 * EEtE - _pmul(tr[:, None, None, :], E)
    det = (_pmul(E[:, 0, 0], _pmul(E[:, 1, 1], E[:, 2, 2])
                 - _pmul(E[:, 1, 2], E[:, 2, 1]))
           - _pmul(E[:, 0, 1], _pmul(E[:, 1, 0], E[:, 2, 2])
                   - _pmul(E[:, 1, 2], E[:, 2, 0]))
           + _pmul(E[:, 0, 2], _pmul(E[:, 1, 0], E[:, 2, 1])
                   - _pmul(E[:, 1, 1], E[:, 2, 0])))
    A = np.concatenate([det[:, None], cons.reshape(B, 9, 20)], 1)
    out = []
    for n in range(B):
        try:
            C = np.linalg.solve(A[n, :, :10], A[n, :, 10:])
        except np.linalg.LinAlgError:
            out.append(np.zeros((0, 3, 3)))
            continue
        # x times each basis monomial, as a row over the basis
        M = np.zeros((10, 10))
        for k, m in enumerate(_MONO[10:]):
            xm = (m[0] + 1, m[1], m[2])
            j = _INDEX[xm]
            if j >= 10:
                M[k, j - 10] = 1.0
            else:
                M[k] = -C[j]
        w, v = np.linalg.eig(M)
        real = np.abs(w.imag) <= 1e-9 * np.maximum(1.0, np.abs(w.real))
        sols = []
        for vec in v[:, real].T.real:
            if abs(vec[9]) < 1e-300:
                continue
            x, y, z = vec[6] / vec[9], vec[7] / vec[9], vec[8] / vec[9]
            e = x * basis[n, 0] + y * basis[n, 1] + z * basis[n, 2] \
                + basis[n, 3]
            sols.append(e.reshape(3, 3))
        out.append(np.array(sols).reshape(-1, 3, 3))
    return out


def sampson_error(E: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """OpenCV's EMEstimatorCallback::computeError of models E [M, 3, 3]
    on normalised points [N, 2]: float32 [M, N]."""
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    h2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    Ex1 = np.einsum("mij,nj->mni", E, h1)
    Etx2 = np.einsum("mji,nj->mni", E, h2)
    x2tEx1 = np.einsum("ni,mni->mn", h2, Ex1)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (x2tEx1 * x2tEx1 / den).astype(np.float32)


def _update_iters(p: float, ep: float, model_points: int,
                  max_iters: int) -> int:
    """cv::RANSACUpdateNumIters."""
    p = max(p, 0.0)
    p = min(p, 1.0)
    ep = max(ep, 0.0)
    ep = min(ep, 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - math.pow(1.0 - ep, model_points)
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if (denom >= 0 or -num >= max_iters * (-denom)) \
        else int(round(num / denom))


def find_essential_mat(pts1, pts2, K, prob: float = 0.999,
                       threshold: float = 1.0, seed: int = 0):
    """= cv2.findEssentialMat(pts1, pts2, K, method=cv2.RANSAC, prob,
    threshold) with its own seeded draws. pts [N, 2] pixel coordinates;
    K a 3x3 (or 4x4) camera matrix. Returns (E [3, 3] float64, inlier
    mask [N] bool), or (None, all-False mask) without a model."""
    p1 = np.asarray(pts1, np.float64)
    p2 = np.asarray(pts2, np.float64)
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x1 = np.stack([(p1[:, 0] - cx) / fx, (p1[:, 1] - cy) / fy], 1)
    x2 = np.stack([(p2[:, 0] - cx) / fx, (p2[:, 1] - cy) / fy], 1)
    n = len(x1)
    thr = np.float32((threshold / ((fx + fy) / 2)) ** 2)
    rng = np.random.default_rng(seed)
    best, best_count, best_mask = None, MODEL_POINTS - 1, np.zeros(n, bool)
    niters, it = MAX_ITERS, 0
    if n < MODEL_POINTS:
        return None, best_mask
    while it < niters:
        m = min(BATCH, niters - it)
        idx = np.stack([rng.choice(n, MODEL_POINTS, replace=False)
                        for _ in range(m)])
        sols = five_point(x1[idx], x2[idx])
        for models in sols:
            it += 1
            if not len(models):
                continue
            inl = sampson_error(models, x1, x2) <= thr
            counts = inl.sum(1)
            k = int(np.argmax(counts))
            if counts[k] > max(best_count, MODEL_POINTS - 1):
                best, best_count, best_mask = models[k], int(counts[k]), inl[k]
                niters = _update_iters(prob, (n - best_count) / n,
                                       MODEL_POINTS, niters)
            if it >= niters:
                break
    return best, best_mask


def decompose_essential_mat(E):
    """= cv2.decomposeEssentialMat(E): (R1, R2, t [3, 1]) float64."""
    U, _, Vt = np.linalg.svd(np.asarray(E, np.float64).reshape(3, 3))
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2:3].copy()
