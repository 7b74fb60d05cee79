"""A synthetic two-view scene for the SfM path: three textured planes at
different depths and slants, seen by two pinhole cameras whose relative
pose is known. The scene is not planar, so the essential matrix is well
posed (a single plane seen twice is not: the JAX package's
``test_slam_two_view_synthetic`` recovers t = (-0.03, 0, -1) for a pure
x shift of one plane). numpy only, made from a seed.
"""

from __future__ import annotations

import numpy as np

# (normal, offset): the planes n . X = offset
_PLANES = (
    (np.array([0.0, 0.0, 1.0]), 4.0),                       # back wall
    (np.array([0.45, 0.0, 1.0]), 2.6),                      # left panel
    (np.array([-0.35, -0.3, 1.0]), 2.2),                    # right panel
)
TEX = 512            # texture side, pixels
TEX_PER_M = 100.0    # texture pixels a metre


def _texture(rng, n: int) -> np.ndarray:
    """A periodic random texture [n, n] in [0, 255]: uniform noise
    blurred by three passes of the binomial [1, 4, 6, 4, 1] / 16 per
    axis, plus a coarser octave of the same."""
    def blur(t, passes):
        k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
        for _ in range(passes):
            for ax in (0, 1):
                t = sum(k[i] * np.roll(t, i - 2, axis=ax) for i in range(5))
        return t
    fine = blur(rng.random((n, n)), 2)
    coarse = np.kron(blur(rng.random((n // 8, n // 8)), 1), np.ones((8, 8)))
    t = fine + 0.6 * blur(coarse, 3)
    t = (t - t.min()) / (t.max() - t.min())
    return t * 255.0


def rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    """R = Rz @ Ry @ Rx of angles in radians."""
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def render(K: np.ndarray, R: np.ndarray, t: np.ndarray, H: int, W: int,
           textures: list) -> np.ndarray:
    """The u8 gray view [H, W] of the planes by the camera X_c = R X_w +
    t: per pixel the nearest plane in front, its texture sampled
    bilinearly (periodic) at the hit's in-plane coordinates."""
    Kinv = np.linalg.inv(np.asarray(K, np.float64)[:3, :3])
    u, v = np.meshgrid(np.arange(W) + 0.0, np.arange(H) + 0.0)
    rays = np.stack([u, v, np.ones_like(u)], -1) @ Kinv.T   # camera frame
    d = rays @ R                         # R^T d, world frame
    o = -R.T @ t                         # camera centre, world frame
    best = np.full((H, W), np.inf)
    img = np.zeros((H, W))
    for (n, off), tex in zip(_PLANES, textures):
        off = off / np.linalg.norm(n)
        n = n / np.linalg.norm(n)
        den = d @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = (off - o @ n) / den
        ok = (lam > 0) & (lam < best)
        X = o + lam[..., None] * d
        e1 = np.cross([0.0, 1.0, 0.0], n)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        s = (X @ e1) * TEX_PER_M
        r = (X @ e2) * TEX_PER_M
        s0, r0 = np.floor(s), np.floor(r)
        fs, fr = s - s0, r - r0
        s0 = np.nan_to_num(s0).astype(np.int64) % TEX
        r0 = np.nan_to_num(r0).astype(np.int64) % TEX
        s1, r1 = (s0 + 1) % TEX, (r0 + 1) % TEX
        val = ((1 - fs) * (1 - fr) * tex[r0, s0] + fs * (1 - fr) * tex[r0, s1]
               + (1 - fs) * fr * tex[r1, s0] + fs * fr * tex[r1, s1])
        img = np.where(ok, val, img)
        best = np.where(ok, lam, best)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def two_view_scene(seed: int = 0, H: int = 480, W: int = 640,
                   f: float = 520.0):
    """(img1, img2, K [3, 3], R, t): the planes seen from the origin and
    from X_c = R X_w + t, with a rotation of a few degrees and a mostly
    sideways baseline (|t| = 1, so t is the direction)."""
    rng = np.random.default_rng(seed)
    textures = [_texture(rng, TEX) for _ in _PLANES]
    K = np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])
    R = rotation(0.03, -0.08, 0.02)
    t = np.array([-0.35, 0.04, 0.06])
    t = t / np.linalg.norm(t)
    base = 0.5                           # metres between the cameras
    img1 = render(K, np.eye(3), np.zeros(3), H, W, textures)
    img2 = render(K, R, t * base, H, W, textures)
    return img1, img2, K, R, t
