"""Fusion configuration and volume geometry.

Port of the production part of slam_maskrcnn_tpu/fusion/state.py. The JAX
package's ``pallas_*``, rect, budget and sparse knobs choose TPU layouts
that give bit-identical results and have no counterpart here; neither has
``splat_select_approx`` (the TPU's ``approx_min_k`` candidate selection):
the exact stable sort is the semantics.

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
    max_march_steps: int = 4096          # ray-march oracle (fusion/raycast.py)
    # splat probe/renderer compaction budgets (fusion/splat.py): 8x8x32
    # blocks holding surface, 128-voxel rows of them kept by the level-1
    # compaction, and (exact form) visible surface voxels kept for the
    # z-buffer. Exceeding a budget is counted into the step's miss channel.
    splat_max_blocks: int = 2048
    splat_max_surface: int = 256 * 1024
    splat_max_rows: int = 16384
    # surface shell thickness: normalized SDF in (-band, 0)
    splat_shell_band: float = 0.999
    # > 0: keep this many z-nearest visible voxels per 128-voxel row
    # (clipped entries are counted into the separate clip channel); 0: the
    # exact compaction. None resolves to 24 for fine volumes (>= 256^3) and
    # 0 for coarse ones.
    splat_row_cap: int | None = None
    # association probe: "splat" projects the stored surface shell
    # (fusion/splat.py splat_probe); "depth" back-projects the live depth
    # map to voxel ids (depth_probe)
    probe_mode: str = "splat"
    # probe every probe_stride-th pixel (association sums over thousands
    # of pixels per mask, so a 2x subsample keeps outcomes). Only the depth
    # probe honors it.
    probe_stride: int = 1
    # north-star chunk: refresh the render's candidate set every N frames
    # instead of every frame (needs probe_mode="depth"). 1 = every frame.
    shell_refresh_every: int = 1
    # paired-frame fusion: inject the pair-first frame's relabeled mask
    # into the pair-second frame's probe as a depth-gated one-hot vote
    # (fusion/pipeline.py fusion_step_pair)
    pair_probe_boost: bool = True

    def __post_init__(self):
        if self.probe_mode not in ("splat", "depth"):
            raise ValueError(f"probe_mode {self.probe_mode!r}: 'splat' or "
                             "'depth'")
        if self.splat_row_cap is None:
            object.__setattr__(self, "splat_row_cap",
                               24 if min(self.vol_dim) >= 256 else 0)

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
