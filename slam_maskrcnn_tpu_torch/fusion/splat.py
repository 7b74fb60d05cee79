"""Association probe from the live depth map.

Port of ``depth_probe`` and ``_probe_decode`` from
slam_maskrcnn_tpu/fusion/splat.py (the role of the reference's
``back_proj_kernel``, tsdf.cu:72-135): each (strided) depth pixel
back-projects to its voxel, whose K-bin instance histogram is the pixel's
vote. The splat render and splat probe of that module are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.fusion.fuse import TSDFVolume, _host_f32
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig


def _probe_decode(vid: torch.Tensor, hist: torch.Tensor, thresh: float):
    """Voxel-id image [Hs, Ws] (-1 = none) -> (probs [Hs, Ws, K] raw counts
    f32, box_mask = probs > thresh)."""
    K = hist.shape[-1]
    have = vid >= 0
    rows = hist.view(-1, K)[vid.clamp_min(0)]
    rows = (rows.to(torch.int32) & 0xFFFF).float()   # u16 counts
    probs = torch.where(have[..., None], rows, torch.zeros_like(rows))
    return probs, probs > thresh


def depth_probe(vol: TSDFVolume, depth: torch.Tensor, extrinsic2init,
                intrinsic, cfg: FusionConfig):
    """Per-pixel histogram votes at each depth pixel's voxel. Returns
    (probs [Hs, Ws, K], box_mask [Hs, Ws, K]) at stride cfg.probe_stride;
    pass the equally strided mask to associate_instances."""
    s = cfg.probe_stride
    dev = vol.device
    X, Y, Z = vol.diff.shape
    f = lambda a: torch.tensor(float(a), dtype=torch.float32, device=dev)
    d_m = depth[::s, ::s].to(dev).to(torch.float32) / f(cfg.depth_scale)
    Hs, Ws = d_m.shape
    Kinv = np.linalg.inv(_host_f32(intrinsic)[:3, :3]).astype(np.float32)
    E = _host_f32(extrinsic2init)
    u = (torch.arange(Ws, dtype=torch.float32, device=dev) * s)[None, :]
    v = (torch.arange(Hs, dtype=torch.float32, device=dev) * s)[:, None]
    # camera-space point at the observed depth: p = d * K^-1 [u, v, 1]
    cx = (f(Kinv[0, 0]) * u + f(Kinv[0, 1]) * v + f(Kinv[0, 2])) * d_m
    cy = (f(Kinv[1, 0]) * u + f(Kinv[1, 1]) * v + f(Kinv[1, 2])) * d_m
    cz = (f(Kinv[2, 2]) + torch.zeros_like(u)) * d_m
    # first-camera frame: p = R^T (c - t)
    R, t = E[:3, :3], E[:3, 3]
    rel = (cx - f(t[0]), cy - f(t[1]), cz - f(t[2]))
    p = [f(R[0, j]) * rel[0] + f(R[1, j]) * rel[1] + f(R[2, j]) * rel[2]
         for j in range(3)]
    g = [torch.round((p[j] - f(vol.vol_start[j])) / f(vol.voxel[j]))
         .to(torch.int64) for j in range(3)]
    ok = ((d_m > 0) & (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y)
          & (g[2] >= 0) & (g[2] < Z))
    lin = ((g[0].clamp(0, X - 1) * Y + g[1].clamp(0, Y - 1)) * Z
           + g[2].clamp(0, Z - 1))
    vid = torch.where(ok, lin, torch.full_like(lin, -1))
    return _probe_decode(vid, vol.hist, cfg.box_mask_thresh)
