"""PatchMatch stereo with slanted planes and adaptive bilateral weights.

Port of slam_maskrcnn_tpu/sfm/patchmatch.py (the reference's
``PatchMatch`` / ``mloss``, src/utils.py:188-334) to torch: the plane
field, the images, the Laplacians and the costs live on the device as
float32 tensors, and every cost call is the dense 5 x 5 (``patch`` x
``patch``) window of shifted gathers that the JAX module computes with
numpy, in its arithmetic and order:

* per pixel a slanted plane in depth space z(x, y) = a x + b y + c
  (utils.py:230-239), the centre pixel's plane evaluated at each window
  pixel, disparity d = bf / z truncated toward zero for the column shift
  (the reference's ``np.int``, utils.py:203);
* bilateral weights w = exp(-|I1(q) - I1(p)|_1 / gamma) and the cost
  rho = (1 - alpha) |I1(q) - I2(q - d)|_1 + alpha |lap1(q) - lap2(q - d)|,
  normalised by the full window with 1000 per invalid sample
  (utils.py:211-215);
* jump-flooding propagation (shifts 1, 2, 4, 8 up, left, down, right;
  ``torch.roll`` wraps as ``np.roll``) and the c-only random refinement
  with a halving radius (utils.py:308-321).

The weights and the window gathers depend on the images only, so they are
computed once, not once a cost call. The random draws (the plane
initialisation and each refinement's jitter) come from
``np.random.default_rng(seed)`` on the host in the JAX module's order and
are then moved to the device: the draws are the reference's. The plane
initialisation is computed on the host in float64 as the JAX module does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from slam_maskrcnn_tpu_torch.device import resolve_device


def _gray(img: torch.Tensor) -> torch.Tensor:
    return img if img.dim() == 2 else img.mean(-1)


def _laplacian(gray: torch.Tensor) -> torch.Tensor:
    """cv2.Laplacian CV_32F with the 3x3 kernel [[0,1,0],[1,-4,1],[0,1,0]]
    and BORDER_REFLECT_101 (the JAX module's ``_laplacian``)."""
    p = F.pad(gray[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * gray)


class PatchMatch:
    """The JAX module's API: ``PatchMatch(left, right, patch, max_disp,
    gamma, alpha, min_disp, bf, seed)``, ``run(iters)``, ``depth``,
    ``disp``; images are numpy arrays or tensors (gray [H, W] or color
    [H, W, C]); ``device`` holds every tensor (the card unless the caller
    asks for the CPU). ``run``, ``depth`` and ``disp`` return float32
    tensors on that device."""

    def __init__(self, left, right, patch=5, max_disp=48, gamma=10.0,
                 alpha=0.0, min_disp=0.5, bf=None, seed=0, device="cuda"):
        dev = self.device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(
            a.cpu() if isinstance(a, torch.Tensor) else a, np.float32)
        ).to(dev)
        self.left, self.right = f32(left), f32(right)
        self.color_l = (self.left if self.left.dim() == 3
                        else self.left[..., None])
        self.color_r = (self.right if self.right.dim() == 3
                        else self.right[..., None])
        self.patch = patch
        self.gamma = gamma
        self.alpha = alpha
        self.max_disp = float(max_disp)
        self.min_disp = float(min_disp)
        self.bf = float(bf) if bf is not None else 1.0
        self.zmin = self.bf / self.max_disp
        self.zmax = self.bf / self.min_disp
        self.rng = np.random.default_rng(seed)

        H, W = self.left.shape[:2]
        xv, yv = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        # random slanted-plane init (utils.py:230-239), host float64
        z0 = self.zmin + self.rng.random((H, W)) * (self.zmax - self.zmin)
        r1 = self.rng.random((H, W))
        r2 = self.rng.random((H, W))
        nx = np.cos(2 * math.pi * r2) * np.sqrt(1 - r1 * r1)
        ny = np.sin(2 * math.pi * r2) * np.sqrt(1 - r1 * r1)
        nz = np.maximum(r1, 1e-3)
        fp = np.stack([-nx / nz, -ny / nz, (nx * xv + ny * yv) / nz + z0],
                      -1).astype(np.float32)
        self.fp = torch.from_numpy(fp).to(dev)
        self.xv = torch.from_numpy(xv).to(dev)
        self.yv = torch.from_numpy(yv).to(dev)
        self.lap_l = _laplacian(_gray(self.left))
        self.lap_r = _laplacian(_gray(self.right))
        # every division by a constant divides by a 0-dim tensor: on CUDA,
        # dividing by a Python number is a reciprocal multiply
        self._c = {k: torch.tensor(float(v), dtype=torch.float32,
                                   device=dev)
                   for k, v in (("bf", self.bf), ("gamma", gamma),
                                ("n_win", patch * patch), ("tiny", 1e-6),
                                ("zero", 0.0))}
        self._window()
        self.cost = None

    def _window(self):
        """What a cost call reads that does not depend on the planes, per
        window offset (dy, dx): the offset coordinates, the clipped rows
        and columns, the in-image mask, I1(q), lap1(q) and the bilateral
        weight."""
        H, W = self.lap_l.shape
        r = self.patch // 2
        center = self.color_l
        self.win = []
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                xo, yo = self.xv + dx, self.yv + dy
                ys = yo.clamp(0, H - 1).to(torch.int64)
                xs = xo.clamp(0, W - 1).to(torch.int64)
                in_img = (yo >= 0) & (yo < H) & (xo >= 0) & (xo < W)
                i1q = self.color_l[ys, xs]
                w = torch.exp(-(i1q - center).abs().sum(-1)
                              / self._c["gamma"])
                self.win.append((xo, yo, ys, xs, in_img, i1q,
                                 self.lap_l[ys, xs], w))

    def _cost(self, fp: torch.Tensor) -> torch.Tensor:
        """Dense mloss (utils.py:188-218) of a plane field [H, W, 3]."""
        H, W = self.lap_l.shape
        acc = torch.zeros((H, W), dtype=torch.float32, device=self.device)
        invalid = torch.zeros_like(acc)
        a, b, c = fp[..., 0], fp[..., 1], fp[..., 2]
        bf, tiny, zero = self._c["bf"], self._c["tiny"], self._c["zero"]
        for xo, yo, ys, xs, in_img, i1q, lap1q, w in self.win:
            zq = a * xo + b * yo + c
            zq = torch.where(zq.abs() < tiny, tiny, zq)
            d = bf / zq
            x2 = xs - d.to(torch.int64)      # truncation toward zero
            ok = in_img & (x2 >= 0) & (x2 < W)
            x2c = x2.clamp(0, W - 1)
            i2q = self.color_r[ys, x2c]
            rho = ((1 - self.alpha) * (i1q - i2q).abs().sum(-1)
                   + self.alpha * (lap1q - self.lap_r[ys, x2c]).abs())
            acc += torch.where(ok, w * rho, zero)
            invalid += (~ok).to(torch.float32)
        return acc / self._c["n_win"] + 1000.0 * invalid

    def _improve(self, fp_cand: torch.Tensor) -> None:
        new_cost = self._cost(fp_cand)
        # planes whose centre depth leaves the valid range are rejected
        zc = (fp_cand[..., 0] * self.xv + fp_cand[..., 1] * self.yv
              + fp_cand[..., 2])
        ok = (zc >= 0.5 * self.zmin) & (zc <= 2.0 * self.zmax)
        better = (new_cost < self.cost) & ok
        self.fp = torch.where(better[..., None], fp_cand, self.fp)
        self.cost = torch.where(better, new_cost, self.cost)

    @property
    def depth(self) -> torch.Tensor:
        return self.fp[..., 0] * self.xv + self.fp[..., 1] * self.yv \
            + self.fp[..., 2]

    @property
    def disp(self) -> torch.Tensor:
        return self._c["bf"] / self.depth.clamp_min(1e-6)

    def run(self, iters=5) -> torch.Tensor:
        self.cost = self._cost(self.fp)
        for _ in range(iters):
            for step in (1, 2, 4, 8):
                for shift in ((step, 0), (0, step), (-step, 0), (0, -step)):
                    self._improve(torch.roll(self.fp, shift, (0, 1)))
            dz = (self.zmax - self.zmin) / 2.0
            while dz > 0.1 * (self.zmax - self.zmin) / self.max_disp:
                jit = ((self.rng.random(tuple(self.cost.shape)) * 2 - 1)
                       * dz).astype(np.float32)
                cand = self.fp.clone()
                cand[..., 2] += torch.from_numpy(jit).to(self.device)
                self._improve(cand)
                dz /= 2.0
        return self.disp
