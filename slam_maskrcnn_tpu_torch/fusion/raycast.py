"""TSDF raycasting: the exact ray-march probe and renderer.

Port of slam_maskrcnn_tpu/fusion/raycast.py, the JAX package's version of
the reference's two ray kernels (``back_proj_kernel``,
src/SfM_CUDA/tsdf.cu:72-135, and ``show_tsdf_kernel``,
src/SfM_CUDA/viewer.cu:17-86). Both share one ray marcher; only the
shading differs. The march advances every live ray of the pixel grid per
iteration with finished rays masked, as the JAX ``while_loop`` does; here
it is a Python loop that ends when no ray is alive (one host sync per
iteration) or at cfg.max_march_steps. The adaptive step rule (full voxel,
then voxel/4 once |f| < voxel/2, tsdf.cu:116-119) is kept per ray.

This is the oracle for fusion/splat.py; the main path renders by
splatting. It is also the dense ("xla") path's association probe. The
small products (the ray rotation, the norm) are written out elementwise
in a fixed order, so the CPU and the card compute them alike.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.fusion.fuse import _host_f32
from slam_maskrcnn_tpu_torch.fusion.splat import INSTANCE_PALETTE
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, TSDFState

__all__ = ["INSTANCE_PALETTE", "trilinear", "ray_march", "camera_rays",
           "back_project_probe", "orbit_camera", "render", "render_orbit",
           "grid_floor", "march_bounds", "march_start", "march_update",
           "probe_rays"]


def _t(a, dev) -> torch.Tensor:
    """An f32 tensor on ``dev``: a tensor already there as it is (no
    copy, no sync), anything else uploaded."""
    if (isinstance(a, torch.Tensor) and a.device == torch.device(dev)
            and a.dtype == torch.float32):
        return a
    return torch.tensor(_host_f32(a), device=dev)


def _rotate(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v [..., 3] @ M.T [3, 3] as elementwise products and sums in a fixed
    order (no matrix-multiply library, whose FMAs differ by device)."""
    return torch.stack([(v[..., 0] * M[r, 0] + v[..., 1] * M[r, 1])
                        + v[..., 2] * M[r, 2] for r in range(3)], dim=-1)


def _unit(d: torch.Tensor) -> torch.Tensor:
    """d / |d| over the last axis of 3, summed in a fixed order."""
    n = torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                   + d[..., 2] * d[..., 2])
    return d / n[..., None]


def grid_floor(pos: torch.Tensor, vol_start, voxel, dims):
    """(floor index [..., 3] int64, fraction [..., 3] f32) of world
    positions in a grid of ``dims`` voxels: ``trilinear``'s corner base.
    Positions far outside the grid are clamped before the integer cast
    (their corners clamp to the border anyway)."""
    dev = pos.device
    idx = (pos - _t(vol_start, dev)) / _t(voxel, dev)
    flf = torch.floor(idx)
    fr = idx - flf
    fl = flf.clamp(-2.0, float(max(dims)) + 1.0).to(torch.int64)
    return fl, fr


def trilinear(vol: torch.Tensor, vol_start, voxel, pos: torch.Tensor,
              unsigned: bool = False, x0: int = 0, dims=None,
              halo: torch.Tensor | None = None) -> torch.Tensor:
    """Trilinear sample of a volume at world positions.

    ``vol``: [X, Y, Z] or [X, Y, Z, C]; ``pos``: [..., 3]. Mirrors
    ``interp_tsdf_diff/color/cnt`` (utils.cu:99-170) with the corner
    indices clamped to the grid. ``unsigned``: the values are unsigned
    counts stored in the signed tensor of their width (the volume's
    histogram: u16 in int16, u32 in int32) and are read as such.

    An x-slab: ``vol`` holds the planes [x0, x0 + X) of a volume of
    ``dims`` voxels, ``halo`` [Y, Z(, C)] its plane x0 + X (None on the
    last slab). A sample whose clamped x corner base lies in the slab
    reads only those planes (its corners are that base and the next x),
    and equals the whole volume's sample bit for bit; any other sample is
    garbage for the caller to mask (``slab_owner``)."""
    shape = tuple(vol.shape[:3])
    dims = shape if dims is None else tuple(dims)
    chan = tuple(vol.shape[3:])
    fl, fr = grid_floor(pos, vol_start, voxel, dims)
    flat = vol.reshape((-1,) + chan)
    hflat = None if halo is None else halo.reshape((-1,) + chan)
    sy, sx = shape[2], shape[1] * shape[2]
    slab = dims != shape

    def corner(i, j, k):
        ci = (fl[..., 0] + i).clamp(0, dims[0] - 1)
        cj = (fl[..., 1] + j).clamp(0, dims[1] - 1)
        ck = (fl[..., 2] + k).clamp(0, dims[2] - 1)
        if slab:
            ci = ci - x0
            v = flat[ci.clamp(0, shape[0] - 1) * sx + cj * sy + ck]
            if hflat is not None:
                v = torch.where((ci == shape[0]).view(
                    ci.shape + (1,) * len(chan)), hflat[cj * sy + ck], v)
        else:
            v = flat[ci * sx + cj * sy + ck]
        if unsigned:
            v = v.to(torch.int64) & ((1 << 8 * flat.element_size()) - 1)
        return v.to(torch.float32)

    if chan:
        fx, fy, fz = fr[..., 0:1], fr[..., 1:2], fr[..., 2:3]
    else:
        fx, fy, fz = fr[..., 0], fr[..., 1], fr[..., 2]

    def mix(a, b, t):
        return (1.0 - t) * a + t * b

    low = mix(mix(corner(0, 0, 0), corner(1, 0, 0), fx),
              mix(corner(0, 1, 0), corner(1, 1, 0), fx), fy)
    high = mix(mix(corner(0, 0, 1), corner(1, 0, 1), fx),
               mix(corner(0, 1, 1), corner(1, 1, 1), fx), fy)
    return mix(low, high, fz)


def march_bounds(vol: TSDFState, o: torch.Tensor, d: torch.Tensor,
                 tmin_clip: float = 0.01, tmax_clip: float = 100.0):
    """(tnear, tfar) of rays against the volume's AABB (the slab test of
    tsdf.cu:90-101)."""
    dev = d.device
    vs, ve = _t(vol.vol_start, dev), _t(vol.vol_end, dev)
    inv_d = 1.0 / d
    tbot = inv_d * (vs - o)
    ttop = inv_d * (ve - o)
    tnear = torch.minimum(ttop, tbot).max(-1).values.clamp_min(tmin_clip)
    tfar = torch.maximum(ttop, tbot).min(-1).values.clamp_max(tmax_clip) \
        - 1e-6
    return tnear, tfar


def march_update(ray: dict, f_tt: torch.Tensor, active: torch.Tensor,
                 tfar: torch.Tensor, voxel0: float) -> None:
    """One march iteration, in place on the ray state ``ray`` (t, f_t,
    step, alive, hit, t_hit), for the rays in ``active`` given the SDF
    sample ``f_tt`` at their t: a sign change is a hit, refined linearly
    with the pre-update step; otherwise the step drops to voxel/4 near the
    surface and t advances (tsdf.cu:103-124)."""
    hit_now = active & (f_tt < 0.0)
    t_ref = ray["t"] + ray["step"] * f_tt / (ray["f_t"] - f_tt)
    ray["t_hit"] = torch.where(hit_now, t_ref, ray["t_hit"])
    cont = active & ~hit_now
    step = torch.where(cont & (f_tt < voxel0 / 2.0),
                       torch.full_like(ray["step"], voxel0 / 4.0),
                       ray["step"])
    ray["step"] = step
    ray["f_t"] = torch.where(cont, f_tt, ray["f_t"])
    ray["t"] = torch.where(cont, ray["t"] + step, ray["t"])
    ray["alive"] = torch.where(active, cont & (ray["t"] < tfar),
                               ray["alive"])
    ray["hit"] = ray["hit"] | hit_now


def march_start(t0: torch.Tensor, f0: torch.Tensor, tnear: torch.Tensor,
                tfar: torch.Tensor, voxel0: float) -> dict:
    """The ray state before the first iteration: only rays that intersect
    the AABB and start outside the surface (f > 0) march."""
    return dict(t=t0, f_t=f0, step=torch.full_like(t0, voxel0),
                alive=(tnear <= tfar) & (f0 > 0) & (t0 < tfar),
                hit=torch.zeros_like(t0, dtype=torch.bool),
                t_hit=torch.zeros_like(t0))


def ray_march(vol: TSDFState, origins: torch.Tensor, dirs: torch.Tensor,
              cfg: FusionConfig, tmin_clip: float = 0.01,
              tmax_clip: float = 100.0):
    """March rays against the SDF. origins/dirs: [..., 3] (origins
    broadcast). Returns (hit [...], t_hit [...]) with the reference's
    stepping: AABB slab test (tsdf.cu:90-101), start at tnear + 1e-6,
    full-voxel steps dropping to voxel/4 near the surface, linear
    zero-crossing refinement t += step * f_tt / (f_t - f_tt)
    (tsdf.cu:103-124)."""
    dev = vol.device
    d = dirs.to(torch.float32)
    o = origins.to(torch.float32).expand_as(d)
    tnear, tfar = march_bounds(vol, o, d, tmin_clip, tmax_clip)
    voxel0 = float(vol.voxel[0])
    vs, vx = _t(vol.vol_start, dev), _t(vol.voxel, dev)

    def sample(t):   # the geometry uploaded once, not once a march step
        return trilinear(vol.diff, vs, vx, o + t[..., None] * d)

    t0 = tnear + 1e-6
    ray = march_start(t0, sample(t0), tnear, tfar, voxel0)
    for _ in range(cfg.max_march_steps):
        if not bool(ray["alive"].any()):
            break
        march_update(ray, sample(ray["t"]), ray["alive"], tfar, voxel0)
    return ray["hit"], ray["t_hit"]


def camera_rays(intrinsic_inv, H: int, W: int,
                device="cuda") -> torch.Tensor:
    """Per-pixel camera-frame ray targets K^-1 @ [x, y, 1] -> [H, W, 3],
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    Ki = _t(intrinsic_inv, device)
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :, None]
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None, None]
    ones = torch.ones(H, W, 1, dtype=torch.float32, device=device)
    return (Ki[None, None, :3, 0] * xs + Ki[None, None, :3, 1] * ys
            + Ki[None, None, :3, 2] * ones)


def probe_rays(vol: TSDFState, extrinsic2init, intrinsic_inv, H: int,
               W: int):
    """The probe's rays from the current camera: origin [3] and unit
    directions [H, W, 3] in the volume's frame, on the volume's device."""
    dev = vol.device
    E = _t(extrinsic2init, dev)
    R_t = E[:3, :3].T
    o = -_rotate(E[:3, 3], R_t)
    targets = camera_rays(intrinsic_inv, H, W, dev)
    return o, _unit(_rotate(targets, R_t))


def back_project_probe(vol: TSDFState, extrinsic2init, intrinsic_inv,
                       H: int, W: int, cfg: FusionConfig):
    """What the fused model claims each pixel's instance is
    (= ``back_proj_kernel``, tsdf.cu:72-135): rays from the current camera;
    at the surface hit, the trilinearly sampled raw instance histogram
    ``probs`` [H, W, K]; ``box_mask`` flags bins whose interpolated count
    exceeds cfg.box_mask_thresh."""
    o, d = probe_rays(vol, extrinsic2init, intrinsic_inv, H, W)
    hit, t_hit = ray_march(vol, o, d, cfg)
    pos = o + t_hit[..., None] * d
    cnts = trilinear(vol.hist, vol.vol_start, vol.voxel, pos, unsigned=True)
    probs = torch.where(hit[..., None], cnts, torch.zeros_like(cnts))
    return probs, probs > cfg.box_mask_thresh


def orbit_camera(angle, dist):
    """Orbit extrinsic [4, 4] and camera center [3] of the reference viewer
    (viewer.cu:140-146), float32 numpy."""
    angle, dist = np.float32(angle), np.float32(dist)
    half = np.float32(0.5)
    ca, sa = np.cos(angle), np.sin(angle)
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0], rot[0, 2], rot[0, 3] = ca, -sa, dist * sa
    rot[2, 0], rot[2, 2], rot[2, 3] = sa, ca, dist - dist * ca
    c = np.array([(dist + half) * sa, 0.0,
                  (dist + half) - (dist + half) * ca], np.float32)
    return rot, c


def render(vol: TSDFState, s2w, center, H: int, W: int, cfg: FusionConfig,
           mode: str = "instance") -> torch.Tensor:
    """Raycast render (= ``show_tsdf_kernel``, viewer.cu:17-86).

    mode="instance": argmax of the trilinear instance histogram at the hit,
    colored by the fixed palette, background and instance 0 black
    (viewer.cu:69-83). mode="color": the trilinear volume color as stored.
    Returns uint8 [H, W, 3]."""
    dev = vol.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    S = _t(s2w, dev)
    c = _t(center, dev)
    target = torch.stack([S[r, 0] * xs + S[r, 1] * ys + S[r, 2] + S[r, 3]
                          for r in range(3)], dim=-1)
    d = _unit(target - c)
    hit, t_hit = ray_march(vol, c, d, cfg)
    pos = c + t_hit[..., None] * d
    if mode == "color":
        rgb = trilinear(vol.color.to(torch.float32), vol.vol_start,
                        vol.voxel, pos)
        return torch.where(hit[..., None], rgb,
                           torch.zeros_like(rgb)).to(torch.uint8)
    cnts = trilinear(vol.hist, vol.vol_start, vol.voxel, pos, unsigned=True)
    obj = torch.argmax(cnts, dim=-1)
    visible = hit & (obj > 0) & (cnts.max(dim=-1).values > 0)
    pal = torch.from_numpy(INSTANCE_PALETTE).to(dev)
    return torch.where(visible[..., None], pal[obj], torch.zeros_like(pal[:1]))


def render_orbit(vol: TSDFState, angle, dist, intrinsic_inv, H: int, W: int,
                 cfg: FusionConfig, mode: str = "instance") -> torch.Tensor:
    """= ``Viewer::show_tsdf`` (viewer.cu:137-166): orbit camera at
    ``angle`` / ``dist``, s2w = rot @ K^-1."""
    rot, c = orbit_camera(angle, dist)
    s2w = rot @ _host_f32(intrinsic_inv)
    return render(vol, s2w, c, H, W, cfg, mode)
