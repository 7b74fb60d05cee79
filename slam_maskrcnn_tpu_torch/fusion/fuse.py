"""The fused volume and its per-frame TSDF update.

Port of the blocked-state fusion path of the JAX package
(slam_maskrcnn_tpu/ops/pallas/fuse_kernel.py ``fuse_frame_blocked_impl``,
the reference's ``tsdf_kernel``, src/SfM_CUDA/tsdf.cu:18-70), and at the
end of this module of its dense path (``fuse_frame_dense``, the jnp
``fuse_frame``). The TPU's [NB, 16, 128] block tiling is not carried
over: the volume (fusion/state.py ``TSDFState``) is dense C-order
[X, Y, Z] (diff f32, weight i32), [X, Y, Z, 3] u8 color and a
[X, Y, Z, K] histogram; the kernel path's counts are u16 (stored as
int16, whose wrap-around bits equal u16's; ``to_dense`` returns them as
uint16). At 512^3 with K = 32 that is about 10 GB.

``fuse_frame`` updates the volume IN PLACE (a functional update would
need a second 10 GB copy): on CUDA tensors through the kernel of
csrc/fuse.cu, on CPU tensors through ``fuse_frame_plain``. Both use the
Pallas kernel's arithmetic (``fuse_params``), so they agree bit for bit.

The kernel works brick by brick (8 x 8 x 32 voxels) and first sorts each
brick, per frame, into skip (no voxel can fuse), free (every voxel fuses
with dn == 1: a closed-form update of diff and weight) and full (the dense
per-voxel update), from the brick's 8 projected corners and the min / max
of the depth image's 32 x 32 tiles: the JAX package's ``_block_origins``
pre-classification. ``depth_tiles_plain`` and ``brick_classes_plain`` are
that classification in torch, with the kernel's arithmetic and the slacks
of ``brick_slacks``; the dense ``fuse_frame_plain`` knows nothing of the
classes and is what they are judged against: a brick may be skip or free
only where the per-voxel arithmetic could not decide otherwise.

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
from types import SimpleNamespace

import numpy as np
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.device import on_cuda, resolve_device
from slam_maskrcnn_tpu_torch.fusion import state as _state
from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig, TSDFState,
                                                  volume_bbox_from_depth)
from slam_maskrcnn_tpu_torch.utils.profiling import to_host


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


def _unsigned(t: torch.Tensor) -> np.ndarray:
    """A histogram store (int16 / int32 bits) as u16 / u32 numpy."""
    a = t.cpu().numpy()
    return a.view({np.dtype(np.int16): np.uint16,
                   np.dtype(np.int32): np.uint32}[a.dtype])


def to_dense(vol: TSDFState) -> SimpleNamespace:
    """The volume as numpy arrays in the JAX ``TSDFState`` layout (diff,
    color, weight, hist as uint16 / uint32, geometry, n_obs, num_objs,
    mv_id, mv_cnt)."""
    return SimpleNamespace(
        diff=vol.diff.cpu().numpy(), color=vol.color.cpu().numpy(),
        weight=vol.weight.cpu().numpy(), hist=_unsigned(vol.hist),
        vol_start=vol.vol_start, vol_end=vol.vol_end, voxel=vol.voxel,
        mu=vol.mu, n_obs=vol.n_obs, num_objs=int(vol.num_objs),
        mv_id=vol.mv_id.cpu().numpy(), mv_cnt=vol.mv_cnt.cpu().numpy())


def from_dense(state, device="cuda", hist_dtype=np.uint16) -> TSDFState:
    """A volume from arrays in the JAX ``TSDFState`` layout (any object
    with those attributes, e.g. a TSDFState or ``to_dense``'s output), its
    histogram stored as ``hist_dtype`` (the kernel's u16 by default). A
    count that does not fit ``hist_dtype`` raises ValueError: it is never
    wrapped. Missing ``mv_id`` / ``mv_cnt`` read as the placeholders."""
    dev = resolve_device(device)
    f = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)
    hist = np.asarray(state.hist)
    want = np.dtype(hist_dtype)
    if hist.size and int(hist.max()) > np.iinfo(want).max:
        raise ValueError(
            f"histogram count {int(hist.max())} does not fit the {want} "
            f"store (at most {np.iinfo(want).max}); load it into a "
            f"uint32 volume (backend='xla', hist_dtype=np.uint32)")
    if hist.size and int(hist.min()) < 0:
        raise ValueError("negative histogram counts")
    hist = np.ascontiguousarray(hist.astype(want))
    placeholder = np.zeros((1, 1, 1), np.int32)
    mv = [np.asarray(getattr(state, k, placeholder), np.int32)
          for k in ("mv_id", "mv_cnt")]
    return TSDFState(
        diff=f(np.asarray(state.diff, np.float32), torch.float32),
        color=f(np.asarray(state.color, np.uint8), torch.uint8),
        weight=f(np.asarray(state.weight, np.int32), torch.int32),
        hist=torch.from_numpy(hist.view(f"<i{want.itemsize}")).to(dev),
        vol_start=np.asarray(state.vol_start, np.float32),
        vol_end=np.asarray(state.vol_end, np.float32),
        voxel=np.asarray(state.voxel, np.float32),
        mu=np.float32(np.asarray(state.mu)), n_obs=int(state.n_obs),
        num_objs=torch.tensor(int(state.num_objs), dtype=torch.int32,
                              device=dev),
        mv_id=f(mv[0], torch.int32), mv_cnt=f(mv[1], torch.int32))


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = to_host("host_f32", a.detach()).numpy()
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


# Brick and depth-tile shape of the fuse kernel: mirrored in csrc/fuse.cu
# (BRICK_X, BRICK_Y, BRICK_Z, TILE); change both together. The slacks below
# exist only here: the kernel gets them with each frame's parameters.
BRICK = (8, 8, 32)
DEPTH_TILE = 32
BRICK_PX_SLACK = 2.0    # px added around a brick's projected corner box
BRICK_Z_SLACK = 1e-4    # metres added around its camera-z range
SKIP, FULL, FREE = 0, 1, 2
_EPS32 = float(np.finfo(np.float32).eps)


def brick_slacks(params: np.ndarray, dims) -> np.ndarray:
    """The slacks of the brick classification for one frame, float32 [3]:
    (z_slack, z_near, px_slack).

    A voxel's camera-space position is three products and three sums in
    f32, each term at most M = max_r(|base_r| + |ax_r|(X-1) + |ay_r|(Y-1) +
    |az_r|(Z-1)) in size, so it is off the exact affine value by at most
    4 eps M. ``z_slack`` (0.1 mm plus 16 eps M) covers that on the z range
    of a brick's corners. A brick counts as in front of the camera only
    from ``z_near`` on, chosen so that the projection's error there stays
    under a quarter pixel for a corner and for a voxel alike; ``px_slack``
    (2 px) covers both with room to spare."""
    p = np.asarray(params, np.float64)
    ext = np.asarray(dims, np.float64) - 1.0
    M = float(np.max(np.abs(p[9:12]) + np.abs(p[0:3]) * ext[0]
                     + np.abs(p[3:6]) * ext[1] + np.abs(p[6:9]) * ext[2]))
    z_slack = BRICK_Z_SLACK + 16.0 * _EPS32 * M
    z_near = z_slack + 16.0 * float(np.abs(p[12:16]).sum()) * _EPS32 * M
    return np.array([z_slack, z_near, BRICK_PX_SLACK], np.float32)


def depth_tiles_plain(depth: torch.Tensor):
    """(tile_min, tile_max), int32 [ceil(H/32), ceil(W/32)]: the least and
    the greatest raw depth of each 32 x 32 tile of the image (an edge tile
    over the pixels it has). A tile with a hole (a 0) has minimum 0."""
    T = DEPTH_TILE
    H, W = depth.shape
    d = depth.to(torch.int32) & 0xFFFF
    ph, pw = (-H) % T, (-W) % T
    th, tw = (H + ph) // T, (W + pw) // T
    pad = lambda fill: torch.nn.functional.pad(
        d, (0, pw, 0, ph), value=fill).view(th, T, tw, T)
    return pad(0xFFFF).amin((1, 3)), pad(0).amax((1, 3))


def brick_classes_plain(vol: TSDFState, params: np.ndarray,
                        tile_min: torch.Tensor, tile_max: torch.Tensor,
                        H: int, W: int, x0: int = 0) -> torch.Tensor:
    """The fuse kernel's class of every brick for one frame, int8
    [nbx, nby, nbz]: SKIP (0), FULL (1), FREE (2). Plain PyTorch version of
    ``classify_brick`` in csrc/fuse.cu, same arithmetic and order. ``x0``:
    ``vol`` is the x-slab at x0 of the volume ``params`` describe.

    SKIP: all 8 corner voxels behind the camera; or all in front (z >=
    z_near) and the corners' projected box, widened by px_slack, misses the
    image; or all in front and even the deepest pixel of the tiles under the
    box leaves every voxel at depth - z <= -mu. FREE: all in front, the
    widened box inside the image, no hole in the tiles under it, their
    nearest pixel at depth - z >= mu for every voxel, and a gate that dn == 1
    does not pass. FULL: everything else."""
    X, Y, Z = vol.diff.shape
    dev = vol.diff.device
    s = [torch.tensor(float(v), dtype=torch.float32, device=dev)
         for v in np.concatenate([np.asarray(params, np.float32)[:19],
                                  brick_slacks(params, (x0 + X, Y, Z))])]
    ax, ay, az, b0 = s[0:3], s[3:6], s[6:9], s[9:12]
    fx, fy, cx, cy, mu, dscale, gate, z_slack, z_near, px_slack = s[12:22]

    def ends(n, b, shape, off=0):
        lo = torch.arange(0, n, b, device=dev)
        hi = torch.clamp(lo + (b - 1), max=n - 1)
        return (lo + off).float().view(shape), (hi + off).float().view(shape)

    xs = ends(X, BRICK[0], (-1, 1, 1), x0)
    ys = ends(Y, BRICK[1], (1, -1, 1))
    zs = ends(Z, BRICK[2], (1, 1, -1))
    inf = torch.tensor(float("inf"), device=dev)
    zmin, zmax = inf, -inf
    corners = []
    for c in range(8):
        gx, gy, gz = xs[(c >> 2) & 1], ys[(c >> 1) & 1], zs[c & 1]
        p = [((b0[r] + ax[r] * gx) + ay[r] * gy) + az[r] * gz
             for r in range(3)]
        corners.append(p)
        zmin, zmax = torch.minimum(zmin, p[2]), torch.maximum(zmax, p[2])
    behind = zmax < -z_slack
    front = zmin >= z_near
    umin, umax, vmin, vmax = inf, -inf, inf, -inf
    for px, py, pz in corners:
        u = (fx * px + cx * pz) / pz
        v = (fy * py + cy * pz) / pz
        umin, umax = torch.minimum(umin, u), torch.maximum(umax, u)
        vmin, vmax = torch.minimum(vmin, v), torch.maximum(vmax, v)
    zero = torch.zeros((), device=dev)
    # boxes of bricks that are not in front are never read: keep them finite
    ulo, uhi, vlo, vhi = (torch.where(front, a, zero) for a in
                          (umin - px_slack, umax + px_slack,
                           vmin - px_slack, vmax + px_slack))
    miss = (uhi < 0) | (ulo >= W) | (vhi < 0) | (vlo >= H)
    # the tiles that hold every pixel a voxel of the brick can hit
    T = DEPTH_TILE
    th, tw = tile_min.shape
    tile_of = lambda a: torch.div(a.to(torch.int32), T, rounding_mode="floor")
    tu0 = tile_of(ulo.clamp(0, W - 1))
    tu1 = tile_of(uhi.clamp(0, W - 1))
    tv0 = tile_of(vlo.clamp(0, H - 1))
    tv1 = tile_of(vhi.clamp(0, H - 1))
    shape = zmin.shape
    ti = torch.arange(th, device=dev).view(1, th, 1)
    tj = torch.arange(tw, device=dev).view(1, 1, tw)
    cover = ((ti >= tv0.reshape(-1, 1, 1)) & (ti <= tv1.reshape(-1, 1, 1))
             & (tj >= tu0.reshape(-1, 1, 1)) & (tj <= tu1.reshape(-1, 1, 1)))
    big = torch.tensor(0xFFFF, dtype=torch.int32, device=dev)
    small = torch.zeros((), dtype=torch.int32, device=dev)
    dmin = torch.where(cover, tile_min.to(dev)[None], big) \
        .amin((1, 2)).view(shape)
    dmax = torch.where(cover, tile_max.to(dev)[None], small) \
        .amax((1, 2)).view(shape)
    occluded = (dmax == 0) | (dmax.float() / dscale - (zmin - z_slack) <= -mu)
    inside = (ulo >= 0) & (uhi < W) & (vlo >= 0) & (vhi < H)
    free = (inside & (dmin > 0) & ~(1.0 < gate)
            & (dmin.float() / dscale - (zmax + z_slack) >= mu))
    cls = torch.where(free, FREE, FULL)
    cls = torch.where(miss | occluded, SKIP, cls)
    cls = torch.where(front, cls, FULL)
    cls = torch.where(behind, SKIP, cls)
    return cls.to(torch.int8)


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
        diff_s[sel] = (diff_s[sel] * wt + dn) / (wt + 1.0)
        w_s[sel] = w + 1

        gate = dn < gate_thr
        sel, pix, w = sel[gate], pix[gate], w[gate][:, None]
        col_s = vol.color[xa:xb].view(-1, 3)
        col_s[sel] = ((col_s[sel].to(torch.int32) * w + c_flat[pix])
                      // (w + 1)).to(torch.uint8)
        hist_s = vol.hist[xa:xb].view(-1, K)
        m = m_flat[pix]
        hist_s[sel, m] = hist_s[sel, m] + 1


def _frame_for_kernel(vol: TSDFState, depth, color, mask):
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


def _check_volume(vol: TSDFState) -> None:
    for t, dt in ((vol.diff, torch.float32), (vol.color, torch.uint8),
                  (vol.weight, torch.int32), (vol.hist, torch.int16)):
        if t.dtype != dt or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("volume tensors must be contiguous CUDA tensors "
                             "of the TSDFState dtypes")


def _kernel_scratch(vol: TSDFState, n_frames: int, H: int, W: int,
                    params, x0: int = 0) -> tuple:
    """What a launch of the fuse kernel needs beside the state: per frame
    the 22 kernel parameters (``fuse_params`` + ``brick_slacks``, these
    over the global x of an x-slab at ``x0``), the i32 scratch of the
    depth-tile pass and the i8 brick classes it writes."""
    X, Y, Z = vol.diff.shape
    if X * Y * Z * 3 >= 2 ** 31:
        raise ValueError(f"fuse kernel: a volume of {X}x{Y}x{Z} voxels "
                         "overflows its 32-bit voxel index")
    T = DEPTH_TILE
    tiles = torch.empty((n_frames, 2, -(-H // T), -(-W // T)),
                        dtype=torch.int32, device=vol.device)
    classes = torch.empty((n_frames,) + tuple(-(-n // b) for n, b in
                                              zip((X, Y, Z), BRICK)),
                          dtype=torch.int8, device=vol.device)
    full = [np.ascontiguousarray(np.concatenate(
        [np.asarray(p, np.float32), brick_slacks(p, (x0 + X, Y, Z))]),
        np.float32)
        for p in params]
    return full, tiles, classes


def _fuse_cuda(vol: TSDFState, depth, color, mask, params,
               x0: int = 0) -> torch.Tensor:
    """Launch the fuse kernel on one frame (``vol`` the x-slab at ``x0`` of
    the volume ``params`` describe). Returns the brick classes the kernel
    used, int8 [nbx, nby, nbz]."""
    X, Y, Z = vol.diff.shape
    K = vol.hist.shape[-1]
    H, W = depth.shape
    _check_volume(vol)
    depth, color, mask = _frame_for_kernel(vol, depth, color, mask)
    (p,), tiles, classes = _kernel_scratch(vol, 1, H, W, [params], x0)
    fn = kernels.lib("fuse").fuse_frame_cuda
    kernels.launches.add("fuse")
    err = fn(kernels.ptr(vol.diff), kernels.ptr(vol.color),
             kernels.ptr(vol.weight), kernels.ptr(vol.hist), X, Y, Z, K,
             kernels.ptr(depth), kernels.ptr(color), kernels.ptr(mask), H, W,
             p.ctypes.data_as(ctypes.c_void_p), kernels.ptr(tiles),
             kernels.ptr(classes), int(x0), kernels.stream_ptr(vol.device))
    kernels.check(err, "fuse kernel")
    return classes[0]


def fuse_frames2_plain(vol: TSDFState, depth1, color1, mask1, params1,
                       depth2, color2, mask2, params2) -> None:
    """Plain PyTorch version of the paired fuse kernel: the single-frame
    plain version twice, in place."""
    fuse_frame_plain(vol, depth1, color1, mask1, params1)
    fuse_frame_plain(vol, depth2, color2, mask2, params2)


def _fuse_pair_cuda(vol: TSDFState, depth1, color1, mask1, params1,
                    depth2, color2, mask2, params2) -> torch.Tensor:
    """Launch the paired fuse kernel. Returns the brick classes the kernel
    used for the two frames, int8 [2, nbx, nby, nbz]."""
    X, Y, Z = vol.diff.shape
    K = vol.hist.shape[-1]
    H, W = depth1.shape
    if depth2.shape != (H, W):
        raise ValueError("both frames of a pair must have one size")
    _check_volume(vol)
    depth1, color1, mask1 = _frame_for_kernel(vol, depth1, color1, mask1)
    depth2, color2, mask2 = _frame_for_kernel(vol, depth2, color2, mask2)
    (p1, p2), tiles, classes = _kernel_scratch(vol, 2, H, W,
                                               [params1, params2])
    fn = kernels.lib("fuse").fuse_frames2_cuda
    kernels.launches.add("fuse_pair")
    err = fn(kernels.ptr(vol.diff), kernels.ptr(vol.color),
             kernels.ptr(vol.weight), kernels.ptr(vol.hist), X, Y, Z, K,
             kernels.ptr(depth1), kernels.ptr(color1), kernels.ptr(mask1),
             p1.ctypes.data_as(ctypes.c_void_p),
             kernels.ptr(depth2), kernels.ptr(color2), kernels.ptr(mask2),
             p2.ctypes.data_as(ctypes.c_void_p), H, W, kernels.ptr(tiles),
             kernels.ptr(classes), kernels.stream_ptr(vol.device))
    kernels.check(err, "paired fuse kernel")
    return classes


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
    volume (parallel/sharding.py). Returns ``vol``."""
    params = fuse_params(vol, extrinsic2init, intrinsic, cfg)
    if on_cuda(vol.diff):
        _fuse_cuda(vol, depth, color, mask, params, x0)
    else:
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
    if on_cuda(vol.diff):
        _fuse_pair_cuda(vol, depth1, color1, mask1, p1,
                        depth2, color2, mask2, p2)
    else:
        fuse_frames2_plain(vol, depth1, color1, mask1, p1,
                           depth2, color2, mask2, p2)
    vol.n_obs += 2
    return vol


# ---------------------------------------------------------------------------
# The dense path (the JAX package's backend="xla")
# ---------------------------------------------------------------------------

def fuse_frame_dense(state: TSDFState, depth: torch.Tensor,
                     color: torch.Tensor, mask: torch.Tensor, extrinsic2init,
                     intrinsic, cfg: FusionConfig, x0: int = 0) -> TSDFState:
    """Fuse one frame into the dense ``state`` in place and count it
    (n_obs += 1): the JAX package's jnp ``fuse_frame`` (fusion/fuse.py:
    64-147) as torch code over the whole volume, in its arithmetic and
    order. That function is lowered by XLA, not a kernel, so this runs the
    same torch code on every device.

    Every voxel centre vol_start + i * voxel goes through extrinsic2init
    and the intrinsic; the nearest pixel by floor; voxels behind the camera
    (pz <= 0), outside the image, on zero depth or at diff <= -mu do not
    fuse; diff blends as a running mean of min(diff, mu) / mu; where that
    is below cfg.color_diff_gate the u8 color blends as a truncating
    integer mean and the mask id (clipped to K-1) is counted: a one-hot
    add to the histogram at its dtype, or in majority-vote mode the
    Boyer-Moore step of the id and its counter; then weight += 1.
    Arguments as ``fuse_frame``; ``x0``: ``state`` is the x-slab [x0, x0 +
    X) of a volume with its geometry, every voxel computed from its global
    x. Returns ``state``."""
    X, Y, Z = state.diff.shape
    H, W = depth.shape
    dev = state.device
    Kb = cfg.max_objects
    E = _host_f32(extrinsic2init)
    Km = _host_f32(intrinsic)
    # every constant in one upload; 0-dim tensors divide exactly on CUDA,
    # where dividing by a Python number is a reciprocal multiply
    c = torch.from_numpy(np.concatenate([
        E[:3].reshape(-1), Km[:3, :3].reshape(-1), state.vol_start,
        state.voxel, [state.mu, cfg.depth_scale, cfg.color_diff_gate]])
        .astype(np.float32)).to(dev)
    e = c[0:12].view(3, 4)
    k = c[12:21].view(3, 3)
    vs, vx = c[21:24], c[24:27]
    mu, dscale, gate_thr = c[27], c[28], c[29]
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    ys = (vs[1] + ar(Y) * vx[1])[None, :, None]
    zs = (vs[2] + ar(Z) * vx[2])[None, None, :]
    d_flat = depth.reshape(-1).to(dev).to(torch.int32)
    c_flat = color.reshape(-1, 3).to(dev).to(torch.int32)
    m_flat = mask.reshape(-1).to(dev).to(torch.int64)
    bins = torch.arange(Kb, device=dev)
    slab = max(1, (1 << 21) // (Y * Z))
    for xa in range(0, X, slab):
        xb = min(X, xa + slab)
        xs = (vs[0] + torch.arange(x0 + xa, x0 + xb, dtype=torch.float32,
                                   device=dev) * vx[0])[:, None, None]
        px, py, pz = (((e[r, 0] * xs + e[r, 1] * ys) + e[r, 2] * zs)
                      + e[r, 3] for r in range(3))
        sx, sy, sz = (((k[r, 0] * px + k[r, 1] * py) + k[r, 2] * pz)
                      for r in range(3))
        u = torch.floor(sx / sz)
        v = torch.floor(sy / sz)
        in_bounds = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (pz > 0)
        # clamp before the integer cast (far-off values are masked anyway)
        uc = u.clamp(0, W - 1).to(torch.int64)
        vc = v.clamp(0, H - 1).to(torch.int64)
        flat_idx = vc * W + uc
        d_raw = d_flat[flat_idx]
        diff_m = d_raw.to(torch.float32) / dscale - pz
        valid = in_bounds & (d_raw > 0) & (diff_m > -mu)
        diff_n = torch.minimum(diff_m, mu) / mu

        diff = state.diff[xa:xb]
        weight = state.weight[xa:xb]
        wt = weight.to(torch.float32)
        diff.copy_(torch.where(valid, (diff * wt + diff_n) / (wt + 1.0),
                               diff))
        gate = valid & (diff_n < gate_thr)

        col = state.color[xa:xb]
        w_i = weight[..., None]
        blended = ((col.to(torch.int32) * w_i + c_flat[flat_idx])
                   // (w_i + 1)).to(torch.uint8)
        col.copy_(torch.where(gate[..., None], blended, col))

        m_pix = m_flat[flat_idx].clamp(0, Kb - 1)
        if cfg.majority_vote:
            mv_id = state.mv_id[xa:xb]
            cnt = state.mv_cnt[xa:xb]
            m32 = m_pix.to(torch.int32)
            same = mv_id == m32
            new_cnt = torch.where(same, cnt + 1,
                                  torch.where(cnt > 0, cnt - 1,
                                              torch.ones_like(cnt)))
            new_id = torch.where(same | (cnt > 0), mv_id, m32)
            cnt.copy_(torch.where(gate, new_cnt, cnt))
            mv_id.copy_(torch.where(gate, new_id, mv_id))
        else:
            hist = state.hist[xa:xb]
            onehot = (m_pix[..., None] == bins) & gate[..., None]
            hist += onehot.to(hist.dtype)
        weight += valid.to(torch.int32)
    state.n_obs += 1
    return state
