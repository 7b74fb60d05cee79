"""Fusion configuration and volume geometry.

Port of the production part of slam_maskrcnn_tpu/fusion/state.py. The JAX
package's ``pallas_*``, rect, budget and sparse knobs choose TPU layouts
that give bit-identical results and have no counterpart here.

Semantics kept from the reference (``src/SfM_CUDA/tsdf.cu``): the volume
is axis-aligned in the first camera's frame, sized from the first depth
frame's nonzero bounding rect at the mean depth; voxel = (end - start) /
(dim - 1); mu = mu_factor * voxel.x; the SDF starts at +mu (metric) and
fused values are normalized to [-1, 1].
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Static fusion configuration (reference ``configuration.h:2-9`` and
    ``tsdf.cuh:4,52``)."""

    vol_dim: tuple[int, int, int] = (256, 256, 256)
    max_objects: int = 32            # MAX_OBJECTS, tsdf.cuh:4
    prior_mrcnn_err_rate: float = 0.05   # configuration.h:8
    duplicate_thresh: float = 0.5        # configuration.h:9
    mu_factor: float = 5.0               # mu = mu_factor * voxel.x, tsdf.cu:199
    depth_scale: float = 5000.0          # raw u16 / depth_scale = m, tsdf.cu:49
    color_diff_gate: float = 0.99        # color/hist update gate, tsdf.cu:57
    box_mask_thresh: float = 0.3         # probe box_mask threshold, tsdf.cu:128
    # association probe: "depth" back-projects the live depth map to voxel
    # ids (fusion/splat.py depth_probe). The splat probe is not ported yet.
    probe_mode: str = "depth"
    # probe every probe_stride-th pixel (association sums over thousands
    # of pixels per mask, so a 2x subsample keeps outcomes)
    probe_stride: int = 1

    def __post_init__(self):
        if self.probe_mode != "depth":
            raise NotImplementedError("only probe_mode='depth' is ported")

    @property
    def n_voxels(self) -> int:
        dx, dy, dz = self.vol_dim
        return dx * dy * dz


def volume_bbox_from_depth(depth: np.ndarray, intrinsic: np.ndarray,
                           mean_depth: float) -> tuple[np.ndarray, np.ndarray]:
    """Volume AABB from the first depth frame (``tsdf.cu:177-196``):
    bounding rect of nonzero pixels, its corners back-projected at
    ``mean_depth``, a cube about their midpoint with half-side = half the
    corners' (x, y) diagonal. numpy in, numpy f32 out."""
    ys, xs = np.nonzero(depth)
    if len(xs) == 0:
        raise ValueError("first depth frame has no valid (nonzero) pixels")
    tlx, tly = float(xs.min()), float(ys.min())
    brx, bry = float(xs.max() + 1), float(ys.max() + 1)  # cv::Rect::br()
    K_inv = np.linalg.inv(np.asarray(intrinsic, np.float64))
    tl = K_inv[:3, :3] @ np.array([tlx, tly, 1.0]) * mean_depth
    br = K_inv[:3, :3] @ np.array([brx, bry, 1.0]) * mean_depth
    half_side = float(np.hypot(tl[0] - br[0], tl[1] - br[1]) / 2.0)
    center = (tl + br) / 2.0
    return ((center - half_side).astype(np.float32),
            (center + half_side).astype(np.float32))


def make_intrinsic(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """4x4 intrinsic matrix as the reference builds it (``tsdf.cu:137-147``)."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K
