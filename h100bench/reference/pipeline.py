"""The per-frame fusion step, plain PyTorch: a frozen copy of the port's
``fusion/pipeline.py`` kernel path (``TSDF::parse_frame``, tsdf.cu:171-228,
418-488): frame 0 sizes the volume; frame 1 fuses without association;
from frame 2 on, probe -> association -> relabel -> fuse. The paired step
associates both frames against the pre-pair histogram, then fuses both.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference.associate import (apply_relabel,
                                           associate_instances)
from h100bench.reference.fuse import (fuse_frame, fuse_frames2,
                                      init_from_first_frame)
from h100bench.reference.splat import (depth_probe, probe_from_rows,
                                       splat_probe)
from h100bench.reference.state import FusionConfig, TSDFState


def _zero(vol: TSDFState) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=vol.device)


def _probe(vol: TSDFState, depth, extrinsic2init, intrinsic,
           cfg: FusionConfig, rows=None):
    """(probs, box_mask, mask stride, overflow) of the configured probe.
    ``rows``: a precomputed compacted shell for the splat probe."""
    H, W = depth.shape
    if cfg.probe_mode == "depth":
        probs, bm = depth_probe(vol, depth, extrinsic2init, intrinsic, cfg)
        return probs, bm, cfg.probe_stride, _zero(vol)
    if rows is not None:
        probs, bm, ovf, _ = probe_from_rows(rows, vol.hist, extrinsic2init,
                                            intrinsic, H, W, cfg)
    else:
        probs, bm, ovf, _ = splat_probe(vol, extrinsic2init, intrinsic, H, W,
                                        cfg)
    return probs, bm, 1, ovf


def fusion_step(vol: TSDFState, depth: torch.Tensor, color: torch.Tensor,
                mask: torch.Tensor, extrinsic2init, intrinsic,
                cfg: FusionConfig, mark=None, rows=None):
    """One frame: (probe + associate + relabel) + fuse, in place on ``vol``.
    Tensors on the volume's device. ``mark(stage)``, if given, is called
    after "associate" and "fuse". ``rows``: a compacted shell of ``vol``
    to probe (probe_mode="splat"), when the caller shares one with its
    render. Returns (vol, relabeled mask, misses)."""
    if vol.n_obs > 0:
        probs, bm, s, overflow = _probe(vol, depth, extrinsic2init,
                                        intrinsic, cfg, rows)
        relabel, num_objs = associate_instances(
            probs, bm, mask[::s, ::s], vol.n_obs, vol.num_objs, cfg)
    else:
        relabel = torch.arange(cfg.max_objects, device=vol.device)
        num_objs = mask.max().to(torch.int32) + 1
        overflow = _zero(vol)
    mask_g = apply_relabel(mask, relabel)
    vol.num_objs = num_objs
    if mark is not None:
        mark("associate")
    fuse_frame(vol, depth, color, mask_g, extrinsic2init, intrinsic, cfg)
    if mark is not None:
        mark("fuse")
    return vol, mask_g, overflow


def fusion_step_pair(vol: TSDFState, d1, c1, m1, e1, d2, c2, m2, e2,
                     intrinsic, cfg: FusionConfig, mark=None):
    """Two frames in one step: both associations, then one paired fuse
    pass (fusion/fuse.py ``fuse_frames2``), in place on ``vol``.

    Both frames' associations probe the pre-pair histogram: frame 2's
    votes are one frame stale against the reference's strictly sequential
    probe after every fuse (src/SfM_CUDA/kernel.cpp:76-99). Per-mask vote
    sums span thousands of pixels, so one frame of staleness flips an
    outcome only while an object's evidence is thin; num_objs chains
    through frame 1 (as a device tensor) so fresh ids never collide. With
    cfg.pair_probe_boost, frame 1's relabeled mask is added to frame 2's
    probe as a depth-gated one-hot vote (same pixel, |d1 - d2| <= mu): the
    votes frame 1's fuse would have left at the voxels frame 2 probes.
    Given the two relabeled masks, the paired fuse is bit-identical to two
    single fuses; the approximation is only this association order.

    Warm the volume with at least one sequential frame first: at
    n_obs == 0 frame 2 would associate against an empty histogram.

    Returns (vol, (mask_g1, mask_g2), misses)."""
    K = cfg.max_objects
    dev = vol.device
    if vol.n_obs > 0:
        probs1, bm1, s, ovf1 = _probe(vol, d1, e1, intrinsic, cfg)
        relabel1, num1 = associate_instances(
            probs1, bm1, m1[::s, ::s], vol.n_obs, vol.num_objs, cfg)
    else:
        relabel1 = torch.arange(K, device=dev)
        num1 = m1.max().to(torch.int32) + 1
        ovf1 = _zero(vol)
    mask_g1 = apply_relabel(m1, relabel1)

    # frame 2: the same (pre-pair) histogram, num_objs chained through 1
    probs2, bm2, s, ovf2 = _probe(vol, d2, e2, intrinsic, cfg)
    if cfg.pair_probe_boost:
        g1 = mask_g1[::s, ::s].to(torch.int64)
        d1s = d1[::s, ::s].to(torch.int32).to(torch.float32) / cfg.depth_scale
        d2s = d2[::s, ::s].to(torch.int32).to(torch.float32) / cfg.depth_scale
        near = (d1s > 0) & (d2s > 0) & ((d1s - d2s).abs() <= float(vol.mu))
        oh = ((g1[..., None] == torch.arange(K, device=dev))
              & near[..., None])
        probs2 = probs2 + oh.to(probs2.dtype)
        bm2 = bm2 | oh
    relabel2, num2 = associate_instances(probs2, bm2, m2[::s, ::s],
                                         vol.n_obs + 1, num1, cfg)
    mask_g2 = apply_relabel(m2, relabel2)
    vol.num_objs = num2
    if mark is not None:
        mark("associate")
    fuse_frames2(vol, d1, c1, mask_g1, e1, d2, c2, mask_g2, e2, intrinsic,
                 cfg)
    if mark is not None:
        mark("fuse")
    return vol, (mask_g1, mask_g2), ovf1 + ovf2


def _tensor(a, dev) -> torch.Tensor:
    """A frame array (numpy, or a tensor already staged) on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.asarray(a)).to(dev)


class SemanticFusion:
    """The port's ``SemanticFusion`` with backend "pallas" (the reference's
    ``TSDF`` class): the volume on ``device``, frames as numpy arrays or
    tensors. ``parse_frame`` returns the relabeled mask of a fused frame
    (None for frame 0, which only sizes the volume); the step's misses stay
    in ``last_misses``."""

    def __init__(self, intrinsic: np.ndarray, cfg: FusionConfig,
                 device="cuda"):
        self.device = torch.device(device)
        self.cfg = cfg
        K = np.asarray(intrinsic, np.float32)
        if K.shape == (3, 3):
            K4 = np.eye(4, dtype=np.float32)
            K4[:3, :3] = K
            K = K4
        self.intrinsic = K
        self.state: TSDFState | None = None
        self.init_extrinsic_inv: np.ndarray | None = None
        self.last_misses: torch.Tensor | None = None

    def parse_frame(self, depth, color, mask, extrinsic: np.ndarray,
                    mean_depth: float | None = None):
        if self.state is None or mean_depth is None:
            host_depth = (depth.cpu().numpy() if isinstance(depth,
                                                            torch.Tensor)
                          else np.asarray(depth))
        if mean_depth is None:
            valid = host_depth > 0
            mean_depth = float((host_depth[valid].astype(np.float64)
                                / self.cfg.depth_scale).mean())
        if self.state is None:
            self.state = init_from_first_frame(self.cfg, host_depth,
                                               self.intrinsic, mean_depth,
                                               self.device)
            self.init_extrinsic_inv = np.linalg.inv(
                np.asarray(extrinsic, np.float64)).astype(np.float32)
            return None
        e2i = (np.asarray(extrinsic, np.float32)
               @ self.init_extrinsic_inv).astype(np.float32)
        dev = self.device
        self.state, mask_g, self.last_misses = fusion_step(
            self.state, _tensor(depth, dev), _tensor(color, dev),
            _tensor(mask, dev), e2i, self.intrinsic, self.cfg)
        return mask_g
