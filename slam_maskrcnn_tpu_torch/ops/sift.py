"""SIFT keypoints and descriptors with OpenCV's ``cv2.SIFT_create()``
defaults, without cv2, in torch on the image's device.

The JAX package's two-view SfM (sfm/two_view.py ``match_features``) calls
``cv2.SIFT_create().detectAndCompute`` on a u8 gray image. This is that
call's algorithm (OpenCV's sift.dispatch.cpp / sift.simd.hpp) at its
defaults: 3 layers an octave, sigma 1.6, contrast threshold 0.04, edge
threshold 10, no feature cap, the image doubled first (octave -1):

* the base: the u8 image as float32, doubled by linear interpolation
  (exact: weights 3/4 and 1/4 of u8 values), blurred to sigma 1.6 from an
  assumed 1.0 (2 x 0.5);
* octaves of 6 Gaussian images (the incremental sigmas of the layers,
  kernels of round(8 sigma + 1) | 1 taps, BORDER_REFLECT_101, rows then
  columns), an octave's first image the previous one's layer 3 with every
  other pixel; 5 differences of Gaussians;
* extrema of 26 neighbours (>= / <=) above |1| in layers 1-3, 5 pixels in
  from the border; up to 5 quadratic refinements (Cramer's rule on the 3x3
  Hessian, moving by the rounded offset), then the contrast (0.04 / 3)
  and edge ((10 + 1)^2 / 10) tests;
* the orientation histogram: 36 bins of gradient magnitude times a
  Gaussian of 1.5 scales within 4.5 scales, OpenCV's ``fastAtan2``
  polynomial, the [1, 4, 6, 4, 1] / 16 smoothing, one keypoint per peak
  at or above 0.8 of the highest, the peak interpolated by a parabola;
* the descriptor: 4 x 4 cells of 8 orientation bins over a window of 3
  scales a cell, trilinear votes weighted by a Gaussian of half the
  window, clipped at 0.2 of the norm, scaled to 512 / norm and rounded to
  integers in [0, 255] (float32, as cv2's default descriptor type);
* the keypoints sorted and deduplicated as ``KeyPointsFilter::
  removeDuplicatedSorted``: by x, y, size (larger first), angle.

OpenCV computes its blurs, the refinement and the histograms in float32,
with fused multiply-adds where its compiler contracts them; the order of
those roundings is not repeated here, so a keypoint's position and angle
agree to float32 rounding (``tests/test_torch_sift.py`` states the bar),
and a candidate within a rounding of a threshold may fall either way.
Every step runs on the image's device; the per-keypoint windows are
batched over keypoints.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_LAYERS = 3
SIGMA = 1.6
CONTRAST = 0.04
EDGE = 10.0
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_BINS = 36
ORI_SIG_FCTR = np.float32(1.5)
ORI_RADIUS = np.float32(3 * 1.5)
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_BINS = 8
DESCR_SCL_FCTR = np.float32(3.0)
DESCR_MAG_THR = np.float32(0.2)
INT_DESCR_FCTR = np.float32(512.0)
FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# OpenCV's fastAtan2 coefficients, each folded with 180 / pi in float32
_P = [np.float32(c) * np.float32(180 / np.pi) for c in
      (0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
       -0.04432655554792128)]


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 in degrees [0, 360): a 7th-order polynomial of the
    smaller over the larger magnitude."""
    ax, ay = x.abs(), y.abs()
    eps = torch.tensor(np.float32(np.finfo(np.float64).eps),
                       device=x.device)
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + eps)
    cc = c * c
    a = (((_P[3] * cc + _P[2]) * cc + _P[1]) * cc + _P[0]) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """cv::getGaussianKernel(round(8 sigma + 1) | 1, sigma, CV_32F): the
    taps in float64, normalised, rounded to float32."""
    n = int(np.rint(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source indices of 0 - r .. n - 1 + r under BORDER_REFLECT_101."""
    i = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 image [H, W]:
    the separable kernel, rows then columns, symmetric taps paired
    (k0 x0 + k1 (x-1 + x1) + ...), BORDER_REFLECT_101."""
    k = gaussian_kernel(sigma)
    r = len(k) // 2
    kt = torch.from_numpy(k).to(img.device)
    H, W = img.shape
    for axis, n in ((1, W), (0, H)):
        idx = torch.from_numpy(_reflect101(n, r)).to(img.device)
        p = img.index_select(axis, idx)
        sl = lambda s: p.narrow(axis, s, n)
        out = kt[r] * sl(r)
        for j in range(1, r + 1):
            out = out + kt[r + j] * (sl(r - j) + sl(r + j))
        img = out
    return img


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    """cv2.resize(img, (2W, 2H), INTER_LINEAR) of a float32 image of u8
    values: exact (weights 3/4, 1/4; the border replicated)."""
    for axis in (1, 0):
        n = img.shape[axis]
        lo = torch.cat([img.narrow(axis, 0, 1), img.narrow(axis, 0, n - 1)],
                       axis)
        hi = torch.cat([img.narrow(axis, 1, n - 1),
                        img.narrow(axis, n - 1, 1)], axis)
        even = 0.25 * lo + 0.75 * img
        odd = 0.75 * img + 0.25 * hi
        img = torch.stack([even, odd], axis + 1).flatten(axis, axis + 1)
    return img


def _downsample(img: torch.Tensor) -> torch.Tensor:
    """cv2.resize(img, (W // 2, H // 2), INTER_NEAREST)."""
    H, W = img.shape
    idx = [torch.from_numpy(np.minimum(np.floor(
        np.arange(n // 2) * (1.0 / ((n // 2) / n))), n - 1).astype(
            np.int64)).to(img.device) for n in (H, W)]
    return img.index_select(0, idx[0]).index_select(1, idx[1])


def build_pyramids(gray_u8: torch.Tensor):
    """(Gaussian octaves [6, h, w], DoG octaves [5, h, w]) lists of the
    doubled base, OpenCV's octave count."""
    base = _upsample2(gray_u8.to(torch.float32))
    s32 = np.float32(SIGMA)
    sig_diff = float(np.sqrt(max(s32 * s32 - np.float32(0.5 * 0.5 * 4),
                                 np.float32(0.01))))
    base = gaussian_blur(base, sig_diff)
    n_oct = int(np.rint(math.log(min(base.shape)) / math.log(2.0) - 2)) + 1
    sig = [SIGMA]
    k = 2.0 ** (1.0 / N_LAYERS)
    for i in range(1, N_LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        sig.append(math.sqrt((prev * k) ** 2 - prev * prev))
    gauss, dog = [], []
    for o in range(n_oct):
        layers = [base if o == 0 else _downsample(gauss[-1][N_LAYERS])]
        for i in range(1, N_LAYERS + 3):
            layers.append(gaussian_blur(layers[-1], sig[i]))
        g = torch.stack(layers)
        gauss.append(g)
        dog.append(g[1:] - g[:-1])
    return gauss, dog


def _extrema(d: torch.Tensor) -> torch.Tensor:
    """Candidates (layer, row, col) [N, 3] of one octave's DoG [5, h, w]:
    |v| > 1 and >= (or <=) its 26 neighbours, layers 1-3, 5 px in."""
    L, h, w = d.shape
    b = IMG_BORDER
    if h <= 2 * b or w <= 2 * b:
        return torch.zeros((0, 3), dtype=torch.int64, device=d.device)
    thr = math.floor(0.5 * CONTRAST / N_LAYERS * 255)
    mx = torch.nn.functional.max_pool3d(d[None, None], 3, 1, 1)[0, 0]
    mn = -torch.nn.functional.max_pool3d(-d[None, None], 3, 1, 1)[0, 0]
    ok = (d.abs() > thr) & (((d > 0) & (d >= mx)) | ((d < 0) & (d <= mn)))
    mask = torch.zeros_like(ok)
    mask[1:L - 1, b:h - b, b:w - b] = True
    return torch.nonzero(ok & mask)


def _refine(d: torch.Tensor, cand: torch.Tensor):
    """adjustLocalExtrema for every candidate of one octave: (keep [N],
    layer, r, c [N] int64, xi, xr, xc, contr [N] f32)."""
    dev = d.device
    L, h, w = d.shape
    flat = d.reshape(-1)
    lay, r, c = cand[:, 0].clone(), cand[:, 1].clone(), cand[:, 2].clone()
    n = lay.numel()
    f = lambda v: torch.tensor(np.float32(v), device=dev)
    img_scale = f(np.float32(1) / np.float32(255))
    deriv = f(np.float32(1) / np.float32(255) * np.float32(0.5))
    cross = f(np.float32(1) / np.float32(255) * np.float32(0.25))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    done = torch.zeros_like(alive)
    xi = torch.zeros(n, dtype=torch.float32, device=dev)
    xr, xc = xi.clone(), xi.clone()

    def at(dl, dy, dx):
        ll = (lay + dl).clamp(0, L - 1)
        yy = (r + dy).clamp(0, h - 1)
        xx = (c + dx).clamp(0, w - 1)
        return flat[(ll * h + yy) * w + xx]

    def derivs():
        v = at(0, 0, 0)
        dD = torch.stack([(at(0, 0, 1) - at(0, 0, -1)) * deriv,
                          (at(0, 1, 0) - at(0, -1, 0)) * deriv,
                          (at(1, 0, 0) - at(-1, 0, 0)) * deriv], -1)
        v2 = v * 2
        dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * img_scale
        dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * img_scale
        dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * img_scale
        dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1)
               + at(0, -1, -1)) * cross
        dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1)
               + at(-1, 0, -1)) * cross
        dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0)
               + at(-1, -1, 0)) * cross
        return v, dD, (dxx, dyy, dss, dxy, dxs, dys)

    big = float(np.float32((2 ** 31 - 1) // 3))
    for _ in range(MAX_INTERP_STEPS):
        act = alive & ~done
        if not bool(act.any()):
            break
        _, dD, (dxx, dyy, dss, dxy, dxs, dys) = derivs()
        a = [[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]]
        b = [dD[:, 0], dD[:, 1], dD[:, 2]]
        det = (a[0][0] * (a[1][1] * a[2][2] - a[2][1] * a[1][2])
               - a[0][1] * (a[1][0] * a[2][2] - a[2][0] * a[1][2])
               + a[0][2] * (a[1][0] * a[2][1] - a[2][0] * a[1][1]))
        sing = det == 0
        dinv = 1 / torch.where(sing, torch.ones_like(det), det)
        x0 = dinv * (b[0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
                     - a[0][1] * (b[1] * a[2][2] - a[1][2] * b[2])
                     + a[0][2] * (b[1] * a[2][1] - a[1][1] * b[2]))
        x1 = dinv * (a[0][0] * (b[1] * a[2][2] - a[1][2] * b[2])
                     - b[0] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
                     + a[0][2] * (a[1][0] * b[2] - b[1] * a[2][0]))
        x2 = dinv * (a[0][0] * (a[1][1] * b[2] - b[1] * a[2][1])
                     - a[0][1] * (a[1][0] * b[2] - b[1] * a[2][0])
                     + b[0] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
        zero = torch.zeros_like(x0)
        x0, x1, x2 = (torch.where(sing, zero, v) for v in (x0, x1, x2))
        xi = torch.where(act, -x2, xi)
        xr = torch.where(act, -x1, xr)
        xc = torch.where(act, -x0, xc)
        conv = (xi.abs() < 0.5) & (xr.abs() < 0.5) & (xc.abs() < 0.5)
        done = done | (act & conv)
        move = act & ~conv
        huge = (xi.abs() > big) | (xr.abs() > big) | (xc.abs() > big)
        alive = alive & ~(move & huge)
        move = move & ~huge
        c = torch.where(move, c + torch.round(xc).to(torch.int64), c)
        r = torch.where(move, r + torch.round(xr).to(torch.int64), r)
        lay = torch.where(move, lay + torch.round(xi).to(torch.int64), lay)
        out = ((lay < 1) | (lay > N_LAYERS) | (c < IMG_BORDER)
               | (c >= w - IMG_BORDER) | (r < IMG_BORDER)
               | (r >= h - IMG_BORDER))
        alive = alive & ~(move & out)
    keep = alive & done
    v, dD, (dxx, dyy, _, dxy, _, _) = derivs()
    t = dD[:, 0] * xc + dD[:, 1] * xr + dD[:, 2] * xi
    contr = v * img_scale + t * 0.5
    keep &= (contr.abs() * N_LAYERS).double() >= CONTRAST
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    keep &= (det > 0) & ((tr * tr).double() * EDGE
                         < (EDGE + 1) ** 2 * det.double())
    return keep, lay, r, c, xi, xr, xc, contr


def _orientations(g: torch.Tensor, o: int, lay, r, c, size):
    """calcOrientationHist and its peaks for one octave's keypoints:
    (keypoint index [M], angle [M]) of every peak."""
    dev = g.device
    L, h, w = g.shape
    n = lay.numel()
    scl = size * np.float32(0.5) / np.float32(1 << o)
    radius = torch.round(ORI_RADIUS * scl).to(torch.int64)
    sig = ORI_SIG_FCTR * scl
    escale = -1.0 / (2.0 * sig * sig)
    R = int(radius.max()) if n else 0
    off = torch.arange(-R, R + 1, device=dev)
    ii, jj = off[:, None].expand(-1, 2 * R + 1).reshape(-1), \
        off[None, :].expand(2 * R + 1, -1).reshape(-1)
    y = r[:, None] + ii
    x = c[:, None] + jj
    ok = ((ii.abs() <= radius[:, None]) & (jj.abs() <= radius[:, None])
          & (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1))
    flat = g.reshape(-1)
    base = lay[:, None] * (h * w)
    yc, xc = y.clamp(1, h - 2), x.clamp(1, w - 2)
    dx = flat[base + yc * w + xc + 1] - flat[base + yc * w + xc - 1]
    dy = flat[base + (yc - 1) * w + xc] - flat[base + (yc + 1) * w + xc]
    wgt = torch.exp((ii * ii + jj * jj).to(torch.float32) * escale[:, None])
    ori = fast_atan2(dy, dx)
    mag = torch.sqrt(dx * dx + dy * dy)
    b = torch.round(ori * np.float32(ORI_BINS / 360.0)).to(torch.int64)
    b = torch.where(b >= ORI_BINS, b - ORI_BINS, b)
    b = torch.where(b < 0, b + ORI_BINS, b)
    vals = torch.where(ok, wgt * mag, torch.zeros_like(mag))
    hist = torch.zeros(n, ORI_BINS, dtype=torch.float32, device=dev)
    hist.scatter_add_(1, b, vals)
    t = lambda s: torch.roll(hist, s, 1)
    sm = ((t(2) + t(-2)) * np.float32(1 / 16) + (t(1) + t(-1))
          * np.float32(4 / 16) + hist * np.float32(6 / 16))
    omax = sm.max(1).values
    left, right = torch.roll(sm, 1, 1), torch.roll(sm, -1, 1)
    peak = ((sm > left) & (sm > right)
            & (sm >= (omax * ORI_PEAK_RATIO).to(torch.float32)[:, None]))
    kp, j = torch.nonzero(peak, as_tuple=True)
    lv, cv, rv = left[kp, j], sm[kp, j], right[kp, j]
    bin_ = j.to(torch.float32) + 0.5 * (lv - rv) / (lv - 2 * cv + rv)
    bin_ = torch.where(bin_ < 0, ORI_BINS + bin_,
                       torch.where(bin_ >= ORI_BINS, bin_ - ORI_BINS, bin_))
    angle = 360.0 - np.float32(360.0 / ORI_BINS) * bin_
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON,
                        torch.zeros_like(angle), angle)
    return kp, angle


def _descriptors(g: torch.Tensor, lay, pt, size, angle,
                 chunk: int = 256) -> torch.Tensor:
    """calcSIFTDescriptor for keypoints of one octave image stack ``g``
    ([6, h, w]), their position and size in that octave's pixels:
    float32 [N, 128]."""
    dev = g.device
    L, h, w = g.shape
    d, nb = DESCR_WIDTH, DESCR_BINS
    out = []
    flat = g.reshape(-1)
    for s in range(0, lay.numel(), chunk):
        sl = slice(s, s + chunk)
        lay_, pt_, scl = lay[sl], pt[sl], size[sl] * np.float32(0.5)
        ori = 360.0 - angle[sl]
        ori = torch.where((ori - 360.0).abs() < FLT_EPSILON,
                          torch.zeros_like(ori), ori)
        px = torch.round(pt_[:, 0]).to(torch.int64)
        py = torch.round(pt_[:, 1]).to(torch.int64)
        rad = ori * np.float32(np.pi / 180)
        hw = DESCR_SCL_FCTR * scl
        cos_t = torch.cos(rad) / hw
        sin_t = torch.sin(rad) / hw
        radius = torch.round(hw * np.float32(1.4142135623730951)
                             * np.float32((d + 1) * 0.5)).to(torch.int64)
        radius = radius.clamp(max=int(math.sqrt(float(w) * w
                                                + float(h) * h)))
        R = int(radius.max())
        off = torch.arange(-R, R + 1, device=dev)
        ii = off[:, None].expand(-1, 2 * R + 1).reshape(-1)
        jj = off[None, :].expand(2 * R + 1, -1).reshape(-1)
        fi, fj = ii.to(torch.float32), jj.to(torch.float32)
        c_rot = fj * cos_t[:, None] - fi * sin_t[:, None]
        r_rot = fj * sin_t[:, None] + fi * cos_t[:, None]
        rbin = r_rot + d // 2 - np.float32(0.5)
        cbin = c_rot + d // 2 - np.float32(0.5)
        y = py[:, None] + ii
        x = px[:, None] + jj
        ok = ((ii.abs() <= radius[:, None]) & (jj.abs() <= radius[:, None])
              & (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
              & (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1))
        base = lay_[:, None] * (h * w)
        yc, xc = y.clamp(1, h - 2), x.clamp(1, w - 2)
        dx = flat[base + yc * w + xc + 1] - flat[base + yc * w + xc - 1]
        dy = flat[base + (yc - 1) * w + xc] - flat[base + (yc + 1) * w + xc]
        wgt = torch.exp((c_rot * c_rot + r_rot * r_rot)
                        * np.float32(-1.0 / (d * d * 0.5)))
        obin = (fast_atan2(dy, dx) - ori[:, None]) * np.float32(nb / 360.0)
        mag = torch.sqrt(dx * dx + dy * dy) * wgt
        r0, c0, o0 = (torch.floor(v) for v in (rbin, cbin, obin))
        rb, cb, ob = rbin - r0, cbin - c0, obin - o0
        r0, c0, o0 = (v.to(torch.int64) for v in (r0, c0, o0))
        o0 = torch.where(o0 < 0, o0 + nb, o0)
        o0 = torch.where(o0 >= nb, o0 - nb, o0)
        v_r1 = mag * rb
        v_r0 = mag - v_r1
        parts = []
        for vr, dr in ((v_r0, 0), (v_r1, 1)):
            v_c1 = vr * cb
            for vc, dc in ((vr - v_c1, 0), (v_c1, 1)):
                v_o1 = vc * ob
                for vo, do in ((vc - v_o1, 0), (v_o1, 1)):
                    parts.append((vo, dr, dc, do))
        hist = torch.zeros(lay_.numel(), (d + 2) * (d + 2) * (nb + 2),
                           dtype=torch.float32, device=dev)
        idx0 = ((r0 + 1) * (d + 2) + c0 + 1) * (nb + 2) + o0
        for vo, dr, dc, do in parts:
            idx = idx0 + (dr * (d + 2) + dc) * (nb + 2) + do
            hist.scatter_add_(1, torch.where(ok, idx, torch.zeros_like(idx)),
                              torch.where(ok, vo, torch.zeros_like(vo)))
        hist = hist.view(-1, d + 2, d + 2, nb + 2)[:, 1:d + 1, 1:d + 1]
        desc = hist[..., :nb].clone()
        desc[..., 0] += hist[..., nb]
        desc[..., 1] += hist[..., nb + 1]
        desc = desc.reshape(-1, d * d * nb)
        thr = torch.sqrt((desc * desc).sum(1)) * DESCR_MAG_THR
        desc = torch.minimum(desc, thr[:, None])
        nrm = INT_DESCR_FCTR / torch.sqrt((desc * desc).sum(1)).clamp_min(
            FLT_EPSILON)
        out.append(torch.round(desc * nrm[:, None]).clamp(0, 255))
    if not out:
        return torch.zeros((0, d * d * nb), dtype=torch.float32, device=dev)
    return torch.cat(out)


def detect_and_compute(gray: torch.Tensor):
    """= cv2.SIFT_create().detectAndCompute(gray, None) on a u8 gray image
    [H, W] on its device. Returns (keypoints, descriptors): a dict of numpy
    arrays ``pt`` [N, 2] f32, ``size``, ``angle``, ``response`` [N] f32 and
    ``octave`` [N] int32 (cv::KeyPoint's packed octave | layer << 8 |
    round((xi + 0.5) * 255) << 16), and float32 descriptors [N, 128] on
    the device, in cv2's order."""
    if gray.dtype != torch.uint8 or gray.dim() != 2:
        raise TypeError("detect_and_compute takes a u8 gray image [H, W]")
    gauss, dog = build_pyramids(gray)
    per = []
    for o, (g, dg) in enumerate(zip(gauss, dog)):
        cand = _extrema(dg)
        if not cand.shape[0]:
            continue
        keep, lay, r, c, xi, xr, xc, contr = _refine(dg, cand)
        lay, r, c, xi, xr, xc, contr = (v[keep] for v in (
            lay, r, c, xi, xr, xc, contr))
        if not lay.numel():
            continue
        scale = np.float32(1 << o)
        ptx = (c.to(torch.float32) + xc) * scale
        pty = (r.to(torch.float32) + xr) * scale
        size = (SIGMA * torch.pow(torch.tensor(2.0, device=g.device),
                                  (lay.to(torch.float32) + xi) / N_LAYERS
                                  ).double() * float(1 << o) * 2).float()
        octv = (o + (lay << 8) + (torch.round((xi + 0.5) * 255).to(
            torch.int64) << 16))
        kp, angle = _orientations(g, o, lay, r, c, size)
        # octave -1: the keypoint in the input's pixels
        octv = (octv[kp] & ~255) | ((octv[kp] - 1) & 255)
        pt = torch.stack([ptx[kp], pty[kp]], 1) * np.float32(0.5)
        ksize = size[kp] * np.float32(0.5)
        # the descriptor reads the octave's image at the octave's scale
        dscale = np.float32(2.0) / np.float32(1 << o)
        desc = _descriptors(g, lay[kp], pt * dscale, ksize * dscale, angle)
        per.append((pt, ksize, angle, contr[kp].abs(), octv, desc))
    if not per:
        empty = np.zeros((0,), np.float32)
        return (dict(pt=np.zeros((0, 2), np.float32), size=empty,
                     angle=empty, response=empty,
                     octave=np.zeros((0,), np.int32)),
                torch.zeros((0, 128), dtype=torch.float32,
                            device=gray.device))
    pt, size, angle, resp, octv, desc = (torch.cat(v) for v in zip(*per))
    kps = dict(pt=pt.cpu().numpy(), size=size.cpu().numpy(),
               angle=angle.cpu().numpy(), response=resp.cpu().numpy(),
               octave=octv.to(torch.int32).cpu().numpy())
    order = np.lexsort((-kps["octave"], -kps["response"], kps["angle"],
                        -kps["size"], kps["pt"][:, 1], kps["pt"][:, 0]))
    k = {f: v[order] for f, v in kps.items()}
    same = np.zeros(len(order), bool)
    same[1:] = ((k["pt"][1:] == k["pt"][:-1]).all(1)
                & (k["size"][1:] == k["size"][:-1])
                & (k["angle"][1:] == k["angle"][:-1]))
    keep = np.nonzero(~same)[0]
    k = {f: v[keep] for f, v in k.items()}
    return k, desc[torch.from_numpy(order[keep]).to(desc.device)]
