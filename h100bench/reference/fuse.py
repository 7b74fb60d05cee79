"""The TSDF update, plain PyTorch: a frozen copy of the port's
``fusion/fuse.py`` plain path (the arithmetic and evaluation order of its
fuse kernel, tsdf.cu:18-70), without the kernels. ``fuse_frames2`` is the
plain version of the paired kernel: frame 1's update, then frame 2's.

``FUSE_DTYPE`` is the precision of the per-voxel arithmetic: float32 as
the configuration states; the precision control sets bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference import state as _state
from h100bench.reference.state import (FusionConfig, TSDFState,
                                       volume_bbox_from_depth)

FUSE_DTYPE = torch.float32


def init_state(cfg: FusionConfig, vol_start, vol_end, device="cuda",
               num_objs: int = 0) -> TSDFState:
    """An empty volume for the fuse kernel over [vol_start, vol_end]
    (tsdf.cu:197-214, 230-253): a u16 histogram whatever
    ``cfg.hist_dtype`` says, the kernel's store."""
    if cfg.majority_vote:
        raise ValueError("the fuse kernel keeps the histogram; majority-vote "
                         "mode runs on the dense path (backend='xla')")
    return _state.init_state(cfg, vol_start, vol_end, device, num_objs,
                             hist_dtype=np.uint16)


def init_from_first_frame(cfg: FusionConfig, depth: np.ndarray,
                          intrinsic: np.ndarray, mean_depth: float,
                          device="cuda", num_objs: int = 0) -> TSDFState:
    """First-frame lazy init (the ``!init_`` branch of parse_frame,
    tsdf.cu:173-214) of the kernel's volume: the first frame only sizes
    the volume."""
    vs, ve = volume_bbox_from_depth(np.asarray(depth), intrinsic, mean_depth)
    return init_state(cfg, vs, ve, device, num_objs)


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def fuse_params(vol: TSDFState, extrinsic2init, intrinsic,
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


def fuse_frame_plain(vol: TSDFState, depth: torch.Tensor,
                     color: torch.Tensor, mask: torch.Tensor,
                     params: np.ndarray, slab: int = 32, x0: int = 0) -> None:
    """Plain PyTorch version of the fuse kernel, in place, over x-slabs of
    ``slab`` planes (bounds the temporaries at 512^3). Same arithmetic and
    evaluation order as csrc/fuse.cu. ``x0``: ``vol`` is the x-slab at x0
    of the volume ``params`` describe (its voxels take their global x)."""
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
    for xa in range(0, X, slab):
        xb = min(X, xa + slab)
        gx = torch.arange(x0 + xa, x0 + xb, dtype=torch.float32,
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

        diff_s = vol.diff[xa:xb].view(-1)
        w_s = vol.weight[xa:xb].view(-1)
        w = w_s[sel]
        wt = w.float()
        if FUSE_DTYPE == torch.float32:
            diff_s[sel] = (diff_s[sel] * wt + dn) / (wt + 1.0)
        else:
            lo = lambda t: t.to(FUSE_DTYPE)
            diff_s[sel] = ((lo(diff_s[sel]) * lo(wt) + lo(dn))
                           / lo(wt + 1.0)).float()
        w_s[sel] = w + 1

        gate = dn < gate_thr
        sel, pix, w = sel[gate], pix[gate], w[gate][:, None]
        col_s = vol.color[xa:xb].view(-1, 3)
        col_s[sel] = ((col_s[sel].to(torch.int32) * w + c_flat[pix])
                      // (w + 1)).to(torch.uint8)
        hist_s = vol.hist[xa:xb].view(-1, K)
        m = m_flat[pix]
        hist_s[sel, m] = hist_s[sel, m] + 1


def fuse_frame(vol: TSDFState, depth: torch.Tensor, color: torch.Tensor,
               mask: torch.Tensor, extrinsic2init, intrinsic,
               cfg: FusionConfig, x0: int = 0) -> TSDFState:
    """Fuse one frame into ``vol`` in place and count it (n_obs += 1).

    depth u16 [H, W] raw (0 = invalid); color u8 [H, W, 3] (BGR); mask u8
    [H, W] global instance ids; extrinsic2init f32 [4, 4] (this frame's
    world->camera composed with the first frame's camera->world);
    intrinsic f32 [4, 4]. ``x0``: ``vol`` is the x-slab [x0, x0 + X) of a
    volume whose geometry (``vol_start``, ``voxel``) it carries: each voxel
    is computed from its global x, by the same expression as in the whole
    volume. Returns ``vol``."""
    params = fuse_params(vol, extrinsic2init, intrinsic, cfg)
    fuse_frame_plain(vol, depth, color, mask, params, x0=x0)
    vol.n_obs += 1
    return vol


def fuse_frames2(vol: TSDFState, depth1, color1, mask1, extrinsic2init1,
                 depth2, color2, mask2, extrinsic2init2, intrinsic,
                 cfg: FusionConfig) -> TSDFState:
    """Fuse two frames into ``vol`` in place in one pass (n_obs += 2):
    frame 1's update, then frame 2's, per voxel. Arguments per frame as
    ``fuse_frame``. Returns ``vol``."""
    p1 = fuse_params(vol, extrinsic2init1, intrinsic, cfg)
    p2 = fuse_params(vol, extrinsic2init2, intrinsic, cfg)
    fuse_frame_plain(vol, depth1, color1, mask1, p1)
    fuse_frame_plain(vol, depth2, color2, mask2, p2)
    vol.n_obs += 2
    return vol
