"""The benchmark's one traffic generator: seeded RGB-D sequences of a
crowded sphere scene, made on the device.

A torch copy of the port's ``data/synthetic.py`` ``hard_scene`` and
``hard_sequence`` (analytic ray casts against spheres and a back plane,
TUM depth units, per-frame local mask ids 1..k in the order of the scene
ids present, as ``mask_detect`` numbers a frame's instances), with two
changes for a benchmark that cycles through its frames:

* the camera's orbit closes: frame k of an orbit of n frames sits at
  orbit angle 2 pi k / n, and the forward push goes out and back,
  push (1 - cos(2 pi k / n)) / 2, so frame n follows frame n - 1 as
  smoothly as any other pair;
* the orbit's frame count is a workload parameter (``frames_per_orbit``),
  which sets its angular step.

Every parameter comes from the workload's ``traffic`` object; the scene
(sphere centres, radii, colours) is drawn from the run's seed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Sequence:
    """One orbit of frames on ``device``: depth u16 [N, H, W], color BGR
    u8 [N, H, W, 3] (the scene's colours as the sensor's channel order),
    mask u8 [N, H, W] local ids, e2i f32 [N, 4, 4] each frame's
    world->camera composed with frame 0's camera->world (numpy), and the
    depth in metres at which frame 0 sizes the volume (the traffic's
    ``volume_depth_m``: frame 0's own mean depth moves with the scene's
    arrangement, and the volume with it, which changed the surface shell
    by up to 1.9x from seed to seed)."""

    depth: torch.Tensor
    color: torch.Tensor
    mask: torch.Tensor
    e2i: np.ndarray
    extrinsic: np.ndarray
    mean_depth: float

    def __len__(self) -> int:
        return self.depth.shape[0]


def strata(rng, lo: float, hi: float, n: int) -> np.ndarray:
    """The midpoints of ``n`` equal strata of [lo, hi), in an order drawn
    from ``rng``: every seed gets the same set of values."""
    return lo + (hi - lo) * (rng.permutation(n) + 0.5) / n


def scene(seed: int, n_spheres: int, plane_z: float):
    """``hard_scene``'s ranges (spheres over a shallow dome in front of a
    back plane), each quantity a stratified set that the seed orders, so
    that seeds arrange one set of sizes differently and the work a frame
    gives stays alike. Returns (centers [S, 3], radii [S], colors u8
    [S, 3]) numpy."""
    rng = np.random.default_rng(seed)
    ang = strata(rng, 0, 2 * np.pi, n_spheres)
    rad = strata(rng, 0.15, 0.52, n_spheres)
    centers = np.stack([rad * np.cos(ang), rad * np.sin(ang) * 0.6,
                        strata(rng, 0.9, 1.7, n_spheres)], -1)
    radii = strata(rng, 0.06, 0.13, n_spheres)
    colors = np.stack([strata(rng, 40, 255, n_spheres) for _ in range(3)],
                      -1).astype(np.uint8)
    return centers, radii, colors


def take(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[idx]`` along dim 0 (CUDA has no index kernel for uint16: the
    rows move as int16)."""
    i = torch.as_tensor(idx, device=t.device)
    if t.dtype == torch.uint16:
        return t.view(torch.int16)[i].view(torch.uint16)
    return t[i]


def poses(n: int, orbit: float, push: float) -> np.ndarray:
    """World->camera extrinsics [n, 4, 4] f32 of the closed orbit."""
    a = 2 * np.pi * np.arange(n) / n
    E = np.tile(np.eye(4), (n, 1, 1))
    E[:, 0, 3] = -orbit * np.cos(a)
    E[:, 1, 3] = -orbit * 0.5 * np.sin(a)
    E[:, 2, 3] = -push * (1 - np.cos(a)) / 2
    return E.astype(np.float32)


def render(centers, radii, colors, plane_z, E, K, H, W, depth_scale, dev):
    """``render_frame`` for one extrinsic, in float64 on ``dev``. Returns
    (depth i32 [H, W] TUM units, color u8 [H, W, 3], scene id i64 [H, W],
    0 for plane and background)."""
    f64 = dict(dtype=torch.float64, device=dev)
    E = torch.as_tensor(np.asarray(E, np.float64), **f64)
    R, t = E[:3, :3], E[:3, 3]
    cam_o = -R.T @ t
    K_inv = torch.linalg.inv(torch.as_tensor(np.asarray(K, np.float64),
                                             **f64)[:3, :3])
    ys, xs = torch.meshgrid(torch.arange(H, **f64) + 0.5,
                            torch.arange(W, **f64) + 0.5, indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)
    dirs = (pix @ K_inv.T) @ R
    unit = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)

    def zdepth(tn):
        fin = torch.isfinite(tn)
        pts = cam_o + torch.where(fin, tn, 0.0)[..., None] * unit
        z = pts @ R[2] + t[2]
        return torch.where(fin & (z > 1e-6), z, math.inf)

    c = torch.as_tensor(centers, **f64)
    r = torch.as_tensor(radii, **f64)
    oc = cam_o - c                                          # [S, 3]
    b = unit @ oc.T                                         # [H, W, S]
    disc = b * b - ((oc * oc).sum(-1) - r * r)
    tn = -b - torch.sqrt(disc.clamp_min(0.0))
    tn = torch.where((disc >= 0) & (tn > 1e-6), tn, math.inf)
    zbuf = torch.full((H, W), math.inf, **f64)
    sid = torch.zeros((H, W), dtype=torch.int64, device=dev)
    for s in range(len(radii)):          # the reference's draw order
        z = zdepth(tn[..., s])
        sel = z < zbuf
        zbuf = torch.where(sel, z, zbuf)
        sid = torch.where(sel, s + 1, sid)
    uz = unit[..., 2]
    u = torch.where(uz.abs() > 1e-9, (plane_z - cam_o[2]) / uz, math.inf)
    z = zdepth(torch.where(u > 1e-6, u, math.inf))
    sel = z < zbuf
    zbuf = torch.where(sel, z, zbuf)
    sid = torch.where(sel, 0, sid)
    palette = torch.cat([torch.zeros(1, 3, dtype=torch.uint8),
                         torch.as_tensor(colors)]).to(dev)
    color = palette[sid]
    color = torch.where((sel & (sid == 0))[..., None],
                        torch.tensor(120, dtype=torch.uint8, device=dev),
                        color)
    depth = torch.where(torch.isfinite(zbuf), zbuf * depth_scale, 0.0)
    return depth.clamp(0, 65535).to(torch.int32), color, sid


def local_ids(sid: torch.Tensor, n_spheres: int) -> torch.Tensor:
    """Scene ids -> the frame's local ids 1..k, in ascending scene id."""
    present = torch.zeros(n_spheres + 1, dtype=torch.int64, device=sid.device)
    present[sid.reshape(-1)] = 1
    present[0] = 0
    lut = torch.cumsum(present, 0) * present
    return lut[sid].to(torch.uint8)


def sequence(traffic: dict, camera: dict, seed: int, dev) -> Sequence:
    """One closed orbit of frames for a workload's ``traffic`` parameters
    and a configuration's ``camera`` (H, W, fx, fy, cx, cy, depth_scale),
    the scene drawn from ``seed``."""
    H, W = camera["height"], camera["width"]
    K = intrinsic(camera)
    n_sph = traffic["n_spheres"]
    plane_z = traffic["plane_z_m"]
    centers, radii, colors = scene(seed, n_sph, plane_z)
    n = traffic["frames_per_orbit"]
    E = poses(n, traffic["orbit_radius_m"], traffic["push_m"])
    depths, cols, masks = [], [], []
    for k in range(n):
        d, c, sid = render(centers, radii, colors, plane_z, E[k], K, H, W,
                           camera["depth_scale"], dev)
        depths.append(d)
        cols.append(c)
        masks.append(local_ids(sid, n_sph))
    e0i = np.linalg.inv(E[0].astype(np.float64)).astype(np.float32)
    return Sequence(depth=torch.stack(depths).to(torch.uint16),
                    color=torch.stack(cols), mask=torch.stack(masks),
                    e2i=np.stack([(e @ e0i).astype(np.float32) for e in E]),
                    extrinsic=E, mean_depth=traffic["volume_depth_m"])


def intrinsic(camera: dict) -> np.ndarray:
    """The configuration's 4x4 intrinsic (tsdf.cu:137-147)."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = camera["fx"], camera["fy"]
    K[0, 2], K[1, 2] = camera["cx"], camera["cy"]
    return K
