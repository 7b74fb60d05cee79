"""Semi-global block matching: ``cv2.StereoSGBM_create(minDisparity=0,
numDisparities=64, blockSize=9).compute(left, right)`` without cv2, in
torch on the images' device.

Every other parameter of that call reads 0, and OpenCV
(stereosgbm.cpp ``computeDisparitySGBM``) substitutes P1 = 2, P2 =
max(5, P1 + 1) = 5, a pre-filter cap of max(0, 15) | 1 = 15,
disp12MaxDiff 1, uniqueness ratio 0 (no test), no speckle filter, the
5-direction single pass (MODE_SGBM). Integer arithmetic throughout, so
the result is OpenCV's bit for bit:

* per pixel two channels: the x derivative (2 dI/dx of the row plus those
  of the rows above and below, clipped to [-15, 15] and offset by 15; 15
  at the first and last column) and the intensity; the Birchfield-Tomasi
  cost of each disparity (the two sampling-insensitive distances, the
  intensity channel's shifted right by 2), for x in [64, W);
* the 9 x 9 block sum (replicated borders), plus P2 (OpenCV's buffer
  offset);
* path costs L = C + min(L'[d], L'[d -+ 1] + P1, min L' + P2) - min L' -
  P2 along 5 directions: left to right, from the row above at dx = -1, 0,
  +1, and right to left; their saturated int16 sum S;
* the winner (lowest S, the first on a tie), the parabola's subpixel
  offset in 1/16 px (C division), the right view's winners for the
  left-right check (|d2 - d| > 1 at both roundings invalidates); -16
  where invalid, then a 3 x 3 median (replicated border).

The path recurrences are scans: left to right and right to left over the
columns with every row at once, top to bottom over the rows with every
column at once, each a few tensor operations a step.
"""

from __future__ import annotations

import torch

MIN_DISP = 0
NUM_DISP = 64
BLOCK = 9
P1 = 2
P2 = 5
FTZERO = 15
DISP12_MAX_DIFF = 1
DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
MAX_COST = 32767


def _prefilter(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's x-derivative channel [H, W] int32 in [0, 2 * FTZERO]."""
    H, W = img.shape
    i = img.to(torch.int32)
    up = torch.cat([i[:1], i[:-1]])
    dn = torch.cat([i[1:], i[-1:]])
    dx = lambda r: r[:, 2:] - r[:, :-2]
    g = dx(i) * 2 + dx(up) + dx(dn)
    g = g.clamp(-FTZERO, FTZERO) + FTZERO
    edge = torch.full((H, 1), FTZERO, dtype=torch.int32, device=img.device)
    return torch.cat([edge, g, edge], 1)


def _raw(img: torch.Tensor) -> torch.Tensor:
    """The intensity channel: the pixels, FTZERO at the first and last
    column (OpenCV's row buffer ends)."""
    i = img.to(torch.int32).clone()
    i[:, 0] = FTZERO
    i[:, -1] = FTZERO
    return i


def _minmax(ch: torch.Tensor):
    """(lo, hi) of each pixel and its half-way values to its row
    neighbours (integer halves; the pixel itself at the ends)."""
    left = torch.cat([ch[:, :1], (ch[:, 1:] + ch[:, :-1]) // 2], 1)
    right = torch.cat([(ch[:, :-1] + ch[:, 1:]) // 2, ch[:, -1:]], 1)
    left[:, 0] = ch[:, 0]
    right[:, -1] = ch[:, -1]
    lo = torch.minimum(torch.minimum(left, right), ch)
    hi = torch.maximum(torch.maximum(left, right), ch)
    return lo, hi


def pixel_costs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The Birchfield-Tomasi cost [H, W - 64, 64] int32 of x in [64, W)
    (calcPixelCostBT)."""
    H, W = left.shape
    D = NUM_DISP
    x0 = max(MIN_DISP + NUM_DISP, 0)
    xs = torch.arange(x0, W, device=left.device)
    ds = torch.arange(MIN_DISP, MIN_DISP + D, device=left.device)
    xr = (xs[:, None] - ds[None, :]).clamp(0, W - 1)     # [W1, D]
    cost = torch.zeros((H, W - x0, D), dtype=torch.int32,
                       device=left.device)
    for ch, shift in ((_prefilter, 0), (_raw, 2)):
        u = ch(left)
        v = ch(right)
        u0, u1 = _minmax(u)
        v0, v1 = _minmax(v)
        uu, uu0, uu1 = (a[:, x0:, None] for a in (u, u0, u1))
        vv, vv0, vv1 = (a[:, xr] for a in (v, v0, v1))
        c0 = torch.maximum(torch.maximum(uu - vv1, vv0 - uu),
                           torch.zeros((), dtype=torch.int32,
                                       device=left.device))
        c1 = torch.maximum(torch.maximum(vv - uu1, uu0 - vv),
                           torch.zeros((), dtype=torch.int32,
                                       device=left.device))
        cost += torch.minimum(c0, c1) >> shift
    return cost


def block_costs(cost: torch.Tensor) -> torch.Tensor:
    """C = the 9 x 9 block sum of the pixel costs (replicated borders)
    plus P2."""
    H, W1, D = cost.shape
    r = BLOCK // 2
    dev = cost.device
    ix = torch.arange(W1, device=dev)
    hs = sum(cost[:, (ix + j).clamp(0, W1 - 1)] for j in range(-r, r + 1))
    iy = torch.arange(H, device=dev)
    vs = sum(hs[(iy + j).clamp(0, H - 1)] for j in range(-r, r + 1))
    return vs + P2


def _step(C, Lp, minp):
    """One path step: L = C + min(L'[d], L'[d -+ 1] + P1, min L' + P2)
    - min L' - P2, and min L (per row of the batch)."""
    big = torch.full_like(Lp[..., :1], MAX_COST)
    lm = torch.cat([big, Lp[..., :-1]], -1)
    lp = torch.cat([Lp[..., 1:], big], -1)
    delta = (minp + P2)[..., None]
    L = C + torch.minimum(torch.minimum(Lp, lm + P1),
                          torch.minimum(lp + P1, delta)) - delta
    return L, L.min(-1).values


def path_sum(C: torch.Tensor) -> torch.Tensor:
    """S: the saturated sum of the 5 directions' path costs [H, W1, D]."""
    H, W1, D = C.shape
    dev = C.device
    zrow = torch.zeros((H, D), dtype=torch.int32, device=dev)
    zmin = torch.zeros((H,), dtype=torch.int32, device=dev)
    S = torch.zeros_like(C)
    # left to right, every row at once
    Lp, mp = zrow, zmin
    for x in range(W1):
        Lp, mp = _step(C[:, x], Lp, mp)
        S[:, x] += Lp
    # from the row above, three directions, every column at once
    zc = torch.zeros((W1, D), dtype=torch.int32, device=dev)
    zm = torch.zeros((W1,), dtype=torch.int32, device=dev)
    prev = [(zc, zm)] * 3
    pad = lambda t, s: (torch.cat([torch.zeros_like(t[:1]), t[:-1]])
                        if s == -1 else torch.cat([t[1:],
                                                   torch.zeros_like(t[:1])])
                        if s == 1 else t)
    for y in range(H):
        nxt = []
        for k, s in enumerate((-1, 0, 1)):
            Lq, mq = prev[k]
            L, m = _step(C[y], pad(Lq, s), pad(mq, s))
            S[y] += L
            nxt.append((L, m))
        prev = nxt
    S = S.clamp(max=MAX_COST)
    # right to left, every row at once
    Lp, mp = zrow, zmin
    for x in range(W1 - 1, -1, -1):
        Lp, mp = _step(C[:, x], Lp, mp)
        S[:, x] = (S[:, x] + Lp).clamp(max=MAX_COST)
    return S


def _median3(disp: torch.Tensor) -> torch.Tensor:
    """cv2.medianBlur(disp, 3) of an int16 image (replicated border)."""
    H, W = disp.shape
    iy = torch.arange(H, device=disp.device)
    ix = torch.arange(W, device=disp.device)
    nb = [disp[(iy + dy).clamp(0, H - 1)][:, (ix + dx).clamp(0, W - 1)]
          for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return torch.stack(nb).median(0).values


def sgbm_disparity(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """= cv2.StereoSGBM_create(0, 64, 9).compute(left, right): int16
    disparity [H, W] in 1/16 px (-16 where invalid) of two u8 gray images
    on one device."""
    if left.dtype != torch.uint8 or left.shape != right.shape \
            or left.dim() != 2:
        raise TypeError("sgbm_disparity takes two u8 gray images [H, W]")
    H, W = left.shape
    D, minD = NUM_DISP, MIN_DISP
    x0 = max(minD + D, 0)
    dev = left.device
    invalid = (minD - 1) * DISP_SCALE
    if W - (minD + D) <= BLOCK // 2:
        raise ValueError(f"an image {W} px wide is too narrow for "
                         f"{D} disparities and a {BLOCK} px block (OpenCV "
                         f"refuses it too)")
    S = path_sum(block_costs(pixel_costs(left, right)))
    W1 = W - x0
    minS, best = S.min(-1)                          # first on a tie
    inner = (best > 0) & (best < D - 1)
    bi = best.clamp(1, D - 2)
    sm = S.gather(-1, (bi - 1)[..., None])[..., 0]
    sc = S.gather(-1, bi[..., None])[..., 0]
    sp = S.gather(-1, (bi + 1)[..., None])[..., 0]
    denom2 = (sm + sp - 2 * sc).clamp(min=1)
    sub = torch.div((sm - sp) * DISP_SCALE + denom2, denom2 * 2,
                    rounding_mode="trunc")
    d16 = torch.where(inner, best * DISP_SCALE + sub, best * DISP_SCALE)
    disp = torch.full((H, W), invalid, dtype=torch.int32, device=dev)
    disp[:, x0:] = d16 + minD * DISP_SCALE
    # the right view's winner: the lowest S, the largest x on a tie
    xs = torch.arange(W1, device=dev)
    x2 = xs[None, :] + x0 - best - minD
    key = minS.to(torch.int64) * (W1 + 1) + (W1 - 1 - xs)[None, :]
    key = torch.where(minS < MAX_COST, key, torch.full_like(key, 1 << 62))
    bestkey = torch.full((H, W), 1 << 62, dtype=torch.int64, device=dev)
    bestkey.scatter_reduce_(1, x2, key, "amin")
    has = bestkey < (1 << 62)
    winner = (W1 - 1) - (bestkey % (W1 + 1))
    d2 = torch.gather(best, 1, winner.clamp(0, W1 - 1)) + minD
    disp2 = torch.where(has, d2, torch.full_like(d2, invalid))
    # left-right check at both roundings of the subpixel disparity
    d1 = disp[:, x0:]
    lo = d1 >> DISP_SHIFT
    hi = (d1 + DISP_SCALE - 1) >> DISP_SHIFT
    xx = xs[None, :] + x0

    def bad(dd):
        xq = xx - dd
        inside = (xq >= 0) & (xq < W)
        v = torch.gather(disp2, 1, xq.clamp(0, W - 1))
        return inside & (v >= minD) & ((v - dd).abs() > DISP12_MAX_DIFF)

    drop = (d1 != invalid) & bad(lo) & bad(hi)
    disp[:, x0:] = torch.where(drop, torch.full_like(d1, invalid), d1)
    return _median3(disp.to(torch.int16))
