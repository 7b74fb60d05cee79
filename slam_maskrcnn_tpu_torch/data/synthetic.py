"""Synthetic RGB-D sequences with analytic geometry — the CI fixture.

The reference has no test suite; its closest analog is the procedurally
generated shapes dataset ("Images are generated on the fly... No file
access required", ``Mask_RCNN/samples/shapes/shapes.py:80-82``). This module
is the RGB-D/fusion counterpart: scenes of spheres (+ an optional back
plane) rendered analytically from known camera poses, giving exact depth,
per-instance masks, and ground-truth SDF values to assert against.

All host-side numpy; used by tests and benchmarks. Copy of
slam_maskrcnn_tpu/data/synthetic.py (the port keeps its own copy).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SphereScene:
    centers: np.ndarray   # [S, 3] world
    radii: np.ndarray     # [S]
    colors: np.ndarray    # [S, 3] uint8
    plane_z: float | None = None  # optional back plane at world z=plane_z

    def sdf(self, points: np.ndarray) -> np.ndarray:
        """Exact signed distance at world points [..., 3] (union of spheres)."""
        d = np.linalg.norm(points[..., None, :] - self.centers, axis=-1) - self.radii
        d = d.min(-1)
        if self.plane_z is not None:
            d = np.minimum(d, self.plane_z - points[..., 2])
        return d


def default_scene() -> SphereScene:
    return SphereScene(
        centers=np.array([[-0.25, 0.0, 1.0], [0.3, 0.1, 1.3]]),
        radii=np.array([0.2, 0.25]),
        colors=np.array([[200, 40, 40], [40, 200, 60]], np.uint8),
        plane_z=2.0,
    )


def _ray_sphere(o, d, c, r):
    """t of first intersection (inf if none). o [3], d [...,3]."""
    oc = o - c
    b = (d * oc).sum(-1)
    disc = b * b - ((oc * oc).sum() - r * r)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return np.where((disc >= 0) & (t > 1e-6), t, np.inf)


def render_frame(scene: SphereScene, extrinsic: np.ndarray,
                 intrinsic: np.ndarray, H: int, W: int,
                 depth_scale: float = 5000.0):
    """Analytic render from a world->camera extrinsic.

    Returns (depth u16 [H,W] in TUM units, color u8 [H,W,3],
    mask u8 [H,W] with sphere s -> id s+1, plane/background -> 0).
    """
    E = np.asarray(extrinsic, np.float64)
    R, t = E[:3, :3], E[:3, 3]
    cam_o = -R.T @ t
    K = np.asarray(intrinsic, np.float64)
    xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)
    K_inv = np.linalg.inv(K[:3, :3])
    dirs_cam = pix @ K_inv.T
    dirs = dirs_cam @ R  # world-frame ray directions, R^T @ dir per pixel
    norms = np.linalg.norm(dirs, axis=-1)
    unit = dirs / norms[..., None]

    def zdepth_of(tn):
        """Camera-frame z of the hit point at ray parameter tn (unit dirs):
        z = (R @ p + t)[2]; inf where no hit."""
        tn_f = np.where(np.isfinite(tn), tn, 0.0)
        pts = cam_o[None, None] + tn_f[..., None] * unit
        z = pts @ R[2] + t[2]
        return np.where(np.isfinite(tn) & (z > 1e-6), z, np.inf)

    zbuf = np.full((H, W), np.inf)
    mask = np.zeros((H, W), np.uint8)
    color = np.zeros((H, W, 3), np.uint8)
    for s in range(len(scene.radii)):
        tn = _ray_sphere(cam_o, unit, scene.centers[s], scene.radii[s])
        z = zdepth_of(tn)
        sel = z < zbuf
        zbuf = np.where(sel, z, zbuf)
        mask[sel] = s + 1
        color[sel] = scene.colors[s]
    if scene.plane_z is not None:
        # back plane z = plane_z in world: (cam_o + u*unit).z = plane_z
        uz = unit[..., 2]
        u = np.where(np.abs(uz) > 1e-9, (scene.plane_z - cam_o[2]) / uz, np.inf)
        u = np.where(u > 1e-6, u, np.inf)
        z = zdepth_of(u)
        sel = z < zbuf
        zbuf = np.where(sel, z, zbuf)
        mask[sel] = 0
        color[sel] = np.array([120, 120, 120], np.uint8)
    tbest = zbuf
    depth = np.where(np.isfinite(tbest), tbest * depth_scale, 0.0)
    depth = np.clip(depth, 0, 65535).astype(np.uint16)
    return depth, color, mask


def identity_pose_sequence(n: int, radius: float = 0.08) -> list[np.ndarray]:
    """Small camera orbit around the origin looking down +z: n world->camera
    extrinsics with slight translation jitter (enough baseline for fusion
    without leaving the first frame's volume)."""
    out = []
    for k in range(n):
        ang = 2 * np.pi * k / max(n, 1)
        E = np.eye(4)
        E[:3, 3] = [-radius * np.cos(ang), -radius * np.sin(ang), 0.0]
        out.append(E.astype(np.float32))
    return out


def hard_scene(n_spheres: int = 12, seed: int = 4) -> SphereScene:
    """A crowded scene for the stress sequence: `n_spheres` spheres spread
    over a shallow dome in front of a back plane. With a moving camera
    only a few are visible per frame, so the per-frame (detector-style)
    mask ids churn across the sequence."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_spheres)
    rad = rng.uniform(0.15, 0.52, n_spheres)
    centers = np.stack([rad * np.cos(ang), rad * np.sin(ang) * 0.6,
                        rng.uniform(0.9, 1.7, n_spheres)], -1)
    return SphereScene(
        centers=centers,
        radii=rng.uniform(0.06, 0.13, n_spheres),
        colors=rng.integers(40, 255, (n_spheres, 3)).astype(np.uint8),
        plane_z=2.2,
    )


def hard_sequence(scene: SphereScene, intrinsic: np.ndarray, H: int, W: int,
                  n_frames: int = 20, depth_scale: float = 5000.0,
                  push: float = 0.5, orbit: float = 0.12):
    """The stress trajectory: the camera orbits
    AND pushes forward by `push` meters over the sequence — by the second
    half it is inside the volume bbox inferred from frame 0, exercising
    the fuse kernel on voxels near and behind the camera plane. Masks carry per-frame
    LOCAL ids (1..k in scan order, like ``mask_detect`` output,
    dmask.py:47-59), so cross-frame identity exists only through
    association; each frame dict carries ``local_to_scene`` for asserting
    id stability."""
    # per-frame deltas stay sensor-plausible (~3-4 cm chords): the
    # reference's Bayesian association (tsdf.cu:304-416) assumes
    # frame-to-frame overlap of recently-fused surface; 10+ cm jumps make
    # it allocate fresh ids for everything (measured — see goldens)
    frames = []
    for k in range(n_frames):
        a = 2 * np.pi * k / max(n_frames, 1)
        E = np.eye(4)
        E[:3, 3] = [-orbit * np.cos(a), -orbit * 0.5 * np.sin(a),
                    -push * k / max(n_frames - 1, 1)]
        E = E.astype(np.float32)
        depth, color, mask_g = render_frame(scene, E, intrinsic, H, W,
                                            depth_scale)
        # global sphere ids -> per-frame local ids (detector contract)
        present = np.unique(mask_g)
        present = present[present > 0]
        local = np.zeros(int(mask_g.max()) + 1, np.uint8)
        for j, g in enumerate(present):
            local[g] = j + 1
        mask = local[mask_g]
        valid = depth > 0
        md = float((depth[valid] / depth_scale).mean()) if valid.any() else 0.0
        frames.append(dict(depth=depth, color=color, mask=mask,
                           extrinsic=E, mean_depth=md,
                           local_to_scene=present.astype(np.int32)))
    return frames


def make_sequence(scene: SphereScene, intrinsic: np.ndarray, H: int, W: int,
                  n_frames: int, depth_scale: float = 5000.0):
    """Full synthetic sequence: list of frame dicts shaped like
    TUMSequence.__getitem__ output."""
    frames = []
    for E in identity_pose_sequence(n_frames):
        depth, color, mask = render_frame(scene, E, intrinsic, H, W, depth_scale)
        valid = depth > 0
        md = float((depth[valid] / depth_scale).mean()) if valid.any() else 0.0
        frames.append(dict(depth=depth, color=color, mask=mask,
                           extrinsic=E, mean_depth=md))
    return frames
