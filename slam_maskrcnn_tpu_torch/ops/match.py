"""Brute-force descriptor matching: ``cv2.BFMatcher(cv2.NORM_L2)``'s
``knnMatch(k=2)``, then sfm/two_view.py's ratio test and sort, in torch on
the descriptors' device.

SIFT descriptors hold integers in [0, 255], so every squared distance is
an integer below 2^24: summed in float64 (the cross term by a matrix
product) it is exact whatever the order, and its square root in float64
rounded to float32 is OpenCV's distance bit for bit (torch's float32
square root on the CPU rounds some values near a half-ulp differently in
its vector body and its scalar tail). cv::batchDistance keeps, per query, the
two smallest distances, the lower train index first on a tie (a stable
sort here). The ratio test compares in double as the JAX package's Python
does, and the matches are sorted by distance stably (Python's ``sorted``),
the first ``max_matches`` kept.
"""

from __future__ import annotations

import torch


def knn2(d1: torch.Tensor, d2: torch.Tensor, chunk: int = 4096):
    """= BFMatcher(NORM_L2).knnMatch(d1, d2, k=2): (train indices [N, 2]
    int64, distances [N, 2] float32), nearest first, for float32
    descriptors of integer values on one device."""
    if d2.shape[0] < 2:
        raise ValueError("knn2 needs at least two train descriptors")
    a, b = d1.double(), d2.double()
    bb = (b * b).sum(1)
    idx, dist = [], []
    for s in range(0, a.shape[0], chunk):
        q = a[s:s + chunk]
        sq = (q * q).sum(1)[:, None] + bb[None, :] - 2.0 * (q @ b.T)
        d = torch.sqrt(sq.clamp_min(0)).float()
        srt = torch.sort(d, dim=1, stable=True)
        idx.append(srt.indices[:, :2])
        dist.append(srt.values[:, :2])
    return torch.cat(idx), torch.cat(dist)


def ratio_matches(d1: torch.Tensor, d2: torch.Tensor, ratio: float = 0.75,
                  max_matches: int = 500):
    """The JAX package's ``match_features`` selection: the nearest train
    descriptor of each query where its distance is below ``ratio`` times
    the second nearest's, sorted by distance (stable), at most
    ``max_matches``. Returns (query indices, train indices, distances)."""
    idx, dist = knn2(d1, d2)
    good = dist[:, 0].double() < ratio * dist[:, 1].double()
    q = torch.nonzero(good)[:, 0]
    order = torch.sort(dist[q, 0], stable=True).indices[:max_matches]
    q = q[order]
    return q, idx[q, 0], dist[q, 0]
