"""Semantic fusion pipeline — the ``TSDF::parse_frame`` equivalent.

Port of slam_maskrcnn_tpu/fusion/pipeline.py (``fusion_step_blocked_impl``
with the depth probe). Control flow as ``parse_frame``/``launch_kernel``
(tsdf.cu:171-228, 418-488):
* frame 0: size the volume from the depth bounding rect, no fusion;
* frame 1 (n_obs == 0): no association, num_objs = max(mask) + 1; fuse;
* frame 2+: depth probe -> association -> relabel -> fuse.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.fusion.associate import (apply_relabel,
                                                      associate_instances)
from slam_maskrcnn_tpu_torch.fusion.fuse import (TSDFVolume, fuse_frame,
                                                 init_from_first_frame,
                                                 to_dense)
from slam_maskrcnn_tpu_torch.fusion.splat import depth_probe
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig


def fusion_step(vol: TSDFVolume, depth: torch.Tensor, color: torch.Tensor,
                mask: torch.Tensor, extrinsic2init, intrinsic,
                cfg: FusionConfig, mark=None):
    """One frame: (probe + associate + relabel) + fuse, in place on ``vol``.
    Tensors on the volume's device. ``mark(stage)``, if given, is called
    after "associate" and "fuse". Returns (vol, relabeled mask)."""
    if vol.n_obs > 0:
        probs, bm = depth_probe(vol, depth, extrinsic2init, intrinsic, cfg)
        s = cfg.probe_stride
        relabel, num_objs = associate_instances(
            probs, bm, mask[::s, ::s], vol.n_obs, vol.num_objs, cfg)
    else:
        relabel = torch.arange(cfg.max_objects, device=vol.device)
        num_objs = mask.max().to(torch.int32) + 1
    mask_g = apply_relabel(mask, relabel)
    vol.num_objs = num_objs
    if mark is not None:
        mark("associate")
    fuse_frame(vol, depth, color, mask_g, extrinsic2init, intrinsic, cfg)
    if mark is not None:
        mark("fuse")
    return vol, mask_g


class SemanticFusion:
    """Host-side owner of the volume (the reference's ``TSDF`` class +
    ``kernel.cpp`` glue). Frames are numpy arrays; the volume lives on
    ``device``."""

    def __init__(self, intrinsic: np.ndarray, cfg: FusionConfig | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or FusionConfig()
        K = np.asarray(intrinsic, np.float32)
        if K.shape == (3, 3):
            K4 = np.eye(4, dtype=np.float32)
            K4[:3, :3] = K
            K = K4
        self.intrinsic = K
        self.state: TSDFVolume | None = None
        self.init_extrinsic_inv: np.ndarray | None = None
        self.mean_depth: float | None = None

    def parse_frame(self, depth: np.ndarray, color: np.ndarray,
                    mask: np.ndarray, extrinsic: np.ndarray,
                    mean_depth: float | None = None):
        """Feed one frame. Returns the relabeled (global-id) mask tensor for
        frames that fuse, else None (frame 0 only initializes)."""
        if mean_depth is None:
            valid = depth > 0
            mean_depth = float((depth[valid].astype(np.float64)
                                / self.cfg.depth_scale).mean())
        if self.state is None:
            self.state = init_from_first_frame(self.cfg, depth,
                                               self.intrinsic, mean_depth,
                                               self.device)
            self.init_extrinsic_inv = np.linalg.inv(
                np.asarray(extrinsic, np.float64)).astype(np.float32)
            self.mean_depth = mean_depth
            return None
        e2i = (np.asarray(extrinsic, np.float32)
               @ self.init_extrinsic_inv).astype(np.float32)
        dev = self.device
        self.state, mask_g = fusion_step(
            self.state, torch.from_numpy(np.asarray(depth)).to(dev),
            torch.from_numpy(np.asarray(color)).to(dev),
            torch.from_numpy(np.asarray(mask)).to(dev), e2i,
            self.intrinsic, self.cfg)
        return mask_g

    def dense_state(self):
        """The volume as numpy arrays in the JAX TSDFState layout."""
        return to_dense(self.state)
