"""The fused volume and its per-frame TSDF update.

Port of the blocked-state fusion path of the JAX package
(slam_maskrcnn_tpu/ops/pallas/fuse_kernel.py ``fuse_frame_blocked_impl``,
the reference's ``tsdf_kernel``, src/SfM_CUDA/tsdf.cu:18-70). The TPU's
[NB, 16, 128] block tiling is not carried over: the volume is dense
C-order [X, Y, Z] (diff f32, weight i32), [X, Y, Z, 3] u8 color and a
[X, Y, Z, K] histogram of u16 counts (stored as int16, whose wrap-around
bits equal u16's; ``to_dense`` returns them as uint16). At 512^3 with
K = 32 that is about 10 GB.

``fuse_frame`` updates the volume IN PLACE (a functional update would
need a second 10 GB copy): on CUDA tensors through the kernel of
csrc/fuse.cu, on CPU tensors through ``fuse_frame_plain``. Both use the
Pallas kernel's arithmetic (``fuse_params``), so they agree bit for bit.

``fuse_frames2`` fuses two frames in one pass over the volume (the JAX
package's ``fuse_frames2_blocked_impl`` / ``fuse_frames2_blocked_prepped``):
per voxel frame 1's update, then frame 2's, bit-identical to two
``fuse_frame`` calls. The TPU side's ``pair_prep_static``,
``inject_mask_banded``, ``pair_prepable`` and the blocks it excludes for a
second pass are banded-table and rect layout for its on-chip memory; a
kernel that gathers each voxel's pixel needs none of them, and they have
no counterpart here.

Semantics (tsdf.cu, with the JAX package's deliberate z > 0 guard):
nearest pixel by floor; skip voxels behind the camera, outside the image,
with zero depth or with diff <= -mu; diff blends as a running mean of
min(diff, mu) / mu; where that is < 0.99 the color blends as an integer
truncating mean and histogram bin mask[pixel] (clipped to K-1) counts
one; then weight += 1.
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.device import on_cuda, resolve_device
from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                  volume_bbox_from_depth)


@dataclasses.dataclass
class TSDFVolume:
    """Fused volume + association bookkeeping. Tensors live on one device;
    the geometry is float32 numpy on the host (it is fixed at init)."""

    diff: torch.Tensor       # f32 [X, Y, Z]: +mu metric at init, then normalized
    color: torch.Tensor      # u8  [X, Y, Z, 3] running-mean color (BGR)
    weight: torch.Tensor     # i32 [X, Y, Z] observation count
    hist: torch.Tensor       # i16 [X, Y, Z, K] u16 instance-id counts
    vol_start: np.ndarray    # f32 [3] AABB min corner (first-camera frame)
    vol_end: np.ndarray      # f32 [3]
    voxel: np.ndarray        # f32 [3] voxel pitch
    mu: np.float32           # truncation band (metric)
    n_obs: int               # frames fused so far
    num_objs: torch.Tensor   # i32 [] global instance-id high-water mark (+1)

    @property
    def device(self) -> torch.device:
        return self.diff.device

    def clone(self) -> "TSDFVolume":
        """A deep copy (the update functions work in place)."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).clone()
                     for f in ("diff", "color", "weight", "hist", "num_objs")})


def init_state(cfg: FusionConfig, vol_start, vol_end, device="cuda",
               num_objs: int = 0) -> TSDFVolume:
    """An empty volume over [vol_start, vol_end] (tsdf.cu:197-214, 230-253)."""
    dev = resolve_device(device)
    dim = tuple(cfg.vol_dim)
    vs = np.asarray(vol_start, np.float32)
    ve = np.asarray(vol_end, np.float32)
    voxel = (ve - vs) / (np.asarray(dim, np.float32) - np.float32(1.0))
    mu = np.float32(cfg.mu_factor) * voxel[0]
    return TSDFVolume(
        diff=torch.full(dim, float(mu), dtype=torch.float32, device=dev),
        color=torch.zeros(dim + (3,), dtype=torch.uint8, device=dev),
        weight=torch.zeros(dim, dtype=torch.int32, device=dev),
        hist=torch.zeros(dim + (cfg.max_objects,), dtype=torch.int16,
                         device=dev),
        vol_start=vs, vol_end=ve, voxel=voxel, mu=mu, n_obs=0,
        num_objs=torch.tensor(num_objs, dtype=torch.int32, device=dev))


def init_from_first_frame(cfg: FusionConfig, depth: np.ndarray,
                          intrinsic: np.ndarray, mean_depth: float,
                          device="cuda", num_objs: int = 0) -> TSDFVolume:
    """First-frame lazy init (the ``!init_`` branch of parse_frame,
    tsdf.cu:173-214): the first frame only sizes the volume."""
    vs, ve = volume_bbox_from_depth(np.asarray(depth), intrinsic, mean_depth)
    return init_state(cfg, vs, ve, device, num_objs)


def to_dense(vol: TSDFVolume) -> SimpleNamespace:
    """The volume as numpy arrays in the JAX ``TSDFState`` layout (diff,
    color, weight, hist as uint16, geometry, n_obs, num_objs)."""
    return SimpleNamespace(
        diff=vol.diff.cpu().numpy(), color=vol.color.cpu().numpy(),
        weight=vol.weight.cpu().numpy(),
        hist=vol.hist.cpu().numpy().view(np.uint16),
        vol_start=vol.vol_start, vol_end=vol.vol_end, voxel=vol.voxel,
        mu=vol.mu, n_obs=vol.n_obs, num_objs=int(vol.num_objs))


def from_dense(state, device="cuda") -> TSDFVolume:
    """A volume from arrays in the JAX ``TSDFState`` layout (any object
    with those attributes, e.g. a TSDFState or ``to_dense``'s output)."""
    dev = resolve_device(device)
    f = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)
    hist = np.ascontiguousarray(np.asarray(state.hist).astype(np.uint16))
    return TSDFVolume(
        diff=f(np.asarray(state.diff, np.float32), torch.float32),
        color=f(np.asarray(state.color, np.uint8), torch.uint8),
        weight=f(np.asarray(state.weight, np.int32), torch.int32),
        hist=torch.from_numpy(hist.view(np.int16)).to(dev),
        vol_start=np.asarray(state.vol_start, np.float32),
        vol_end=np.asarray(state.vol_end, np.float32),
        voxel=np.asarray(state.voxel, np.float32),
        mu=np.float32(np.asarray(state.mu)), n_obs=int(state.n_obs),
        num_objs=torch.tensor(int(state.num_objs), dtype=torch.int32,
                              device=dev))


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def fuse_params(vol: TSDFVolume, extrinsic2init, intrinsic,
                cfg: FusionConfig) -> np.ndarray:
    """The per-frame camera constants, float32 [19], as the Pallas kernel
    builds them (fuse_kernel.py:1810-1820): ax = E[:3,0]*voxel.x, ay, az,
    base = E[:3,:3] @ vol_start + E[:3,3], fx, fy, cx, cy, mu,
    depth_scale, color_diff_gate."""
    E = _host_f32(extrinsic2init)
    K = _host_f32(intrinsic)
    vs, vx = vol.vol_start, vol.voxel
    base = ((E[:3, 0] * vs[0] + E[:3, 1] * vs[1]) + E[:3, 2] * vs[2]) \
        + E[:3, 3]
    return np.concatenate([
        E[:3, 0] * vx[0], E[:3, 1] * vx[1], E[:3, 2] * vx[2], base,
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2], vol.mu, cfg.depth_scale,
         cfg.color_diff_gate]]).astype(np.float32)


def fuse_frame_plain(vol: TSDFVolume, depth: torch.Tensor,
                     color: torch.Tensor, mask: torch.Tensor,
                     params: np.ndarray, slab: int = 32) -> None:
    """Plain PyTorch version of the fuse kernel, in place, over x-slabs of
    ``slab`` planes (bounds the temporaries at 512^3). Same arithmetic and
    evaluation order as csrc/fuse.cu."""
    X, Y, Z = vol.diff.shape
    H, W = depth.shape
    K = vol.hist.shape[-1]
    dev = vol.diff.device
    s = [torch.tensor(float(v), dtype=torch.float32, device=dev)
         for v in params]
    ax, ay, az, b0 = s[0:3], s[3:6], s[6:9], s[9:12]
    fx, fy, cx, cy, mu, dscale, gate_thr = s[12:19]
    d_flat = depth.reshape(-1).to(torch.int32)
    c_flat = color.reshape(-1, 3).to(torch.int32)
    m_flat = mask.reshape(-1).to(torch.int64).clamp(0, K - 1)
    gy = torch.arange(Y, dtype=torch.float32, device=dev)[None, :, None]
    gz = torch.arange(Z, dtype=torch.float32, device=dev)[None, None, :]
    tiny = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    for x0 in range(0, X, slab):
        x1 = min(X, x0 + slab)
        gx = torch.arange(x0, x1, dtype=torch.float32,
                          device=dev)[:, None, None]
        px, py, pz = (((b0[r] + ax[r] * gx) + ay[r] * gy) + az[r] * gz
                      for r in range(3))
        safe_z = torch.where(pz.abs() < tiny, tiny, pz)
        u = torch.floor((fx * px + cx * pz) / safe_z)
        v = torch.floor((fy * py + cy * pz) / safe_z)
        in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (pz > 0)
        sel = torch.nonzero(in_img.reshape(-1))[:, 0]
        pix = (v.reshape(-1)[sel] * W + u.reshape(-1)[sel]).long()
        d_raw = d_flat[pix]
        diff_m = d_raw.float() / dscale - pz.reshape(-1)[sel]
        valid = (d_raw > 0) & (diff_m > -mu)
        sel, pix, diff_m = sel[valid], pix[valid], diff_m[valid]
        dn = torch.minimum(diff_m, mu) / mu

        diff_s = vol.diff[x0:x1].view(-1)
        w_s = vol.weight[x0:x1].view(-1)
        w = w_s[sel]
        wt = w.float()
        diff_s[sel] = (diff_s[sel] * wt + dn) / (wt + 1.0)
        w_s[sel] = w + 1

        gate = dn < gate_thr
        sel, pix, w = sel[gate], pix[gate], w[gate][:, None]
        col_s = vol.color[x0:x1].view(-1, 3)
        col_s[sel] = ((col_s[sel].to(torch.int32) * w + c_flat[pix])
                      // (w + 1)).to(torch.uint8)
        hist_s = vol.hist[x0:x1].view(-1, K)
        m = m_flat[pix]
        hist_s[sel, m] = hist_s[sel, m] + 1


def _frame_for_kernel(vol: TSDFVolume, depth, color, mask):
    """The frame as contiguous tensors of the kernel's types on the
    volume's device."""
    H, W = depth.shape
    if depth.dtype not in (torch.uint16, torch.int16):
        depth = depth.to(torch.int32).to(torch.uint16)   # raw u16 units
    depth = depth.to(vol.device).contiguous()
    color = color.to(vol.device, torch.uint8).contiguous()
    mask = mask.to(vol.device, torch.uint8).contiguous()
    if color.shape != (H, W, 3) or mask.shape != (H, W):
        raise ValueError("depth [H, W], color [H, W, 3], mask [H, W] expected")
    return depth, color, mask


def _check_volume(vol: TSDFVolume) -> None:
    for t, dt in ((vol.diff, torch.float32), (vol.color, torch.uint8),
                  (vol.weight, torch.int32), (vol.hist, torch.int16)):
        if t.dtype != dt or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("volume tensors must be contiguous CUDA tensors "
                             "of the TSDFVolume dtypes")


def _fuse_cuda(vol: TSDFVolume, depth, color, mask, params) -> None:
    X, Y, Z = vol.diff.shape
    K = vol.hist.shape[-1]
    H, W = depth.shape
    _check_volume(vol)
    depth, color, mask = _frame_for_kernel(vol, depth, color, mask)
    p = np.ascontiguousarray(params, np.float32)
    fn = kernels.lib("fuse").fuse_frame_cuda
    kernels.launches.add("fuse")
    err = fn(kernels.ptr(vol.diff), kernels.ptr(vol.color),
             kernels.ptr(vol.weight), kernels.ptr(vol.hist), X, Y, Z, K,
             kernels.ptr(depth), kernels.ptr(color), kernels.ptr(mask), H, W,
             p.ctypes.data_as(ctypes.c_void_p),
             kernels.stream_ptr(vol.device))
    kernels.check(err, "fuse kernel")


def fuse_frames2_plain(vol: TSDFVolume, depth1, color1, mask1, params1,
                       depth2, color2, mask2, params2) -> None:
    """Plain PyTorch version of the paired fuse kernel: the single-frame
    plain version twice, in place."""
    fuse_frame_plain(vol, depth1, color1, mask1, params1)
    fuse_frame_plain(vol, depth2, color2, mask2, params2)


def _fuse_pair_cuda(vol: TSDFVolume, depth1, color1, mask1, params1,
                    depth2, color2, mask2, params2) -> None:
    X, Y, Z = vol.diff.shape
    K = vol.hist.shape[-1]
    H, W = depth1.shape
    if depth2.shape != (H, W):
        raise ValueError("both frames of a pair must have one size")
    _check_volume(vol)
    depth1, color1, mask1 = _frame_for_kernel(vol, depth1, color1, mask1)
    depth2, color2, mask2 = _frame_for_kernel(vol, depth2, color2, mask2)
    p1 = np.ascontiguousarray(params1, np.float32)
    p2 = np.ascontiguousarray(params2, np.float32)
    fn = kernels.lib("fuse").fuse_frames2_cuda
    kernels.launches.add("fuse_pair")
    err = fn(kernels.ptr(vol.diff), kernels.ptr(vol.color),
             kernels.ptr(vol.weight), kernels.ptr(vol.hist), X, Y, Z, K,
             kernels.ptr(depth1), kernels.ptr(color1), kernels.ptr(mask1),
             p1.ctypes.data_as(ctypes.c_void_p),
             kernels.ptr(depth2), kernels.ptr(color2), kernels.ptr(mask2),
             p2.ctypes.data_as(ctypes.c_void_p), H, W,
             kernels.stream_ptr(vol.device))
    kernels.check(err, "paired fuse kernel")


def fuse_frame(vol: TSDFVolume, depth: torch.Tensor, color: torch.Tensor,
               mask: torch.Tensor, extrinsic2init, intrinsic,
               cfg: FusionConfig) -> TSDFVolume:
    """Fuse one frame into ``vol`` in place and count it (n_obs += 1).

    depth u16 [H, W] raw (0 = invalid); color u8 [H, W, 3] (BGR); mask u8
    [H, W] global instance ids; extrinsic2init f32 [4, 4] (this frame's
    world->camera composed with the first frame's camera->world);
    intrinsic f32 [4, 4]. Returns ``vol``."""
    params = fuse_params(vol, extrinsic2init, intrinsic, cfg)
    if on_cuda(vol.diff):
        _fuse_cuda(vol, depth, color, mask, params)
    else:
        fuse_frame_plain(vol, depth, color, mask, params)
    vol.n_obs += 1
    return vol


def fuse_frames2(vol: TSDFVolume, depth1, color1, mask1, extrinsic2init1,
                 depth2, color2, mask2, extrinsic2init2, intrinsic,
                 cfg: FusionConfig) -> TSDFVolume:
    """Fuse two frames into ``vol`` in place in one pass (n_obs += 2):
    frame 1's update, then frame 2's, per voxel. Arguments per frame as
    ``fuse_frame``. Returns ``vol``."""
    p1 = fuse_params(vol, extrinsic2init1, intrinsic, cfg)
    p2 = fuse_params(vol, extrinsic2init2, intrinsic, cfg)
    if on_cuda(vol.diff):
        _fuse_pair_cuda(vol, depth1, color1, mask1, p1,
                        depth2, color2, mask2, p2)
    else:
        fuse_frames2_plain(vol, depth1, color1, mask1, p1,
                           depth2, color2, mask2, p2)
    vol.n_obs += 2
    return vol
