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

``TSDFState`` is the dense volume of both fuse paths (the JAX package's
``TSDFState``, state.py:332-355). Its histogram counts are stored in a
signed integer tensor of the same width holding the unsigned bits (torch
has little unsigned support on CUDA): u16 in int16, u32 in int32;
``fusion/fuse.py`` ``to_dense`` / ``from_dense`` convert.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device

# histogram dtype (numpy, as FusionConfig.hist_dtype) -> the signed tensor
# dtype of the same width that stores its bits
HIST_STORE = {np.dtype(np.uint16): torch.int16,
              np.dtype(np.uint32): torch.int32}


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
    # histogram count type of the dense ("xla") path: u32 as the reference
    # (tsdf.cu:249), or u16 (half the memory). The fuse kernel's store is
    # always u16 (fusion/fuse.py).
    hist_dtype: type = np.uint32
    # "majority-vote" single-id mode of the TSDF_Python prototype
    # (src/TSDF_Python/tsdf.cu:48-57): a Boyer-Moore id and counter per
    # voxel instead of the histogram. Dense path only.
    majority_vote: bool = False

    def __post_init__(self):
        if np.dtype(self.hist_dtype) not in HIST_STORE:
            raise ValueError(f"hist_dtype {self.hist_dtype!r}: np.uint16 or "
                             "np.uint32")
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


@dataclasses.dataclass
class TSDFState:
    """The fused volume + association bookkeeping (the JAX package's
    ``TSDFState``). Tensors live on one device; the geometry is float32
    numpy on the host (it is fixed at init) and ``n_obs`` a host int. The
    update functions work in place."""

    diff: torch.Tensor       # f32 [X, Y, Z]: +mu metric at init, then normalized
    color: torch.Tensor      # u8  [X, Y, Z, 3] running-mean color (BGR)
    weight: torch.Tensor     # i32 [X, Y, Z] observation count
    hist: torch.Tensor       # i16 / i32 [X, Y, Z, K]: u16 / u32 counts
    vol_start: np.ndarray    # f32 [3] AABB min corner (first-camera frame)
    vol_end: np.ndarray      # f32 [3]
    voxel: np.ndarray        # f32 [3] voxel pitch
    mu: np.float32           # truncation band (metric)
    n_obs: int               # frames fused so far
    num_objs: torch.Tensor   # i32 [] global instance-id high-water mark (+1)
    # majority-vote mode only ((1, 1, 1) zero placeholders otherwise, and
    # hist a (1, 1, 1, 1) placeholder in that mode)
    mv_id: torch.Tensor      # i32 [X, Y, Z] current majority instance id
    mv_cnt: torch.Tensor     # i32 [X, Y, Z] Boyer-Moore counter

    @property
    def device(self) -> torch.device:
        return self.diff.device

    def clone(self) -> "TSDFState":
        """A deep copy (the update functions work in place)."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).clone()
                     for f in ("diff", "color", "weight", "hist", "num_objs",
                               "mv_id", "mv_cnt")})


def init_state(cfg: FusionConfig, vol_start, vol_end, device="cuda",
               num_objs: int = 0, hist_dtype=None) -> TSDFState:
    """An empty volume over [vol_start, vol_end] (tsdf.cu:197-214, 230-253;
    the JAX package's state.py:356). ``hist_dtype`` overrides
    ``cfg.hist_dtype``."""
    dev = resolve_device(device)
    dim = tuple(cfg.vol_dim)
    vs = np.asarray(vol_start, np.float32)
    ve = np.asarray(vol_end, np.float32)
    voxel = (ve - vs) / (np.asarray(dim, np.float32) - np.float32(1.0))
    mu = np.float32(cfg.mu_factor) * voxel[0]
    store = HIST_STORE[np.dtype(hist_dtype or cfg.hist_dtype)]
    i32 = dict(dtype=torch.int32, device=dev)
    if cfg.majority_vote:
        hist = torch.zeros((1, 1, 1, 1), dtype=store, device=dev)
        mv_id, mv_cnt = torch.zeros(dim, **i32), torch.zeros(dim, **i32)
    else:
        hist = torch.zeros(dim + (cfg.max_objects,), dtype=store, device=dev)
        mv_id = torch.zeros((1, 1, 1), **i32)
        mv_cnt = torch.zeros((1, 1, 1), **i32)
    return TSDFState(
        diff=torch.full(dim, float(mu), dtype=torch.float32, device=dev),
        color=torch.zeros(dim + (3,), dtype=torch.uint8, device=dev),
        weight=torch.zeros(dim, **i32), hist=hist,
        vol_start=vs, vol_end=ve, voxel=voxel, mu=mu, n_obs=0,
        num_objs=torch.tensor(num_objs, **i32), mv_id=mv_id, mv_cnt=mv_cnt)


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


def init_from_first_frame(cfg: FusionConfig, depth: np.ndarray,
                          intrinsic: np.ndarray, mean_depth: float,
                          device="cuda", num_objs: int = 0) -> TSDFState:
    """First-frame lazy init of the dense volume (the ``!init_`` branch of
    parse_frame, tsdf.cu:173-214; the JAX package's state.py:421): the
    first frame only sizes the volume."""
    vs, ve = volume_bbox_from_depth(np.asarray(depth), intrinsic, mean_depth)
    return init_state(cfg, vs, ve, device, num_objs)


def make_intrinsic(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """4x4 intrinsic matrix as the reference builds it (``tsdf.cu:137-147``)."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K
