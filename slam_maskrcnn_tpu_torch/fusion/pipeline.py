"""Semantic fusion pipeline — the ``TSDF::parse_frame`` equivalent.

Port of slam_maskrcnn_tpu/fusion/pipeline.py, both of its backends:

* "pallas", the kernel path: ``fusion_step`` (``fusion_step_blocked_impl``),
  ``fusion_step_pair`` (``fusion_step_pair_blocked_impl``),
  ``fuse_sequence_blocked`` and ``fuse_pair_sequence``: the fuse kernel of
  fusion/fuse.py on a u16 histogram, the splat or depth probe;
* "xla", the dense path: ``fusion_step_dense`` (``fusion_step``) and
  ``fuse_sequence``: the torch ``fuse_frame_dense`` at cfg.hist_dtype
  (u32 by default, or majority-vote mode) and the exact trilinear
  ray-march probe of fusion/raycast.py.

Control flow as ``parse_frame``/``launch_kernel`` (tsdf.cu:171-228,
418-488):
* frame 0: size the volume from the depth bounding rect, no fusion;
* frame 1 (n_obs == 0): no association, num_objs = max(mask) + 1; fuse;
* frame 2+: probe (cfg.probe_mode: the stored surface splatted, or the
  live depth map back-projected) -> association -> relabel -> fuse.

Every step returns ``misses``, a 0-d int64 tensor on the volume's device:
the probe's budget overflow (surface the splat dropped; 0 for the depth
probe). The fuse kernel itself gathers every voxel's pixel and has nothing
to miss. The host waits on the device only where ``parse_frame`` reads
the miss count back (every ``miss_check_every`` frames) and where a host
array or constant is uploaded; each such site goes through
utils/profiling.py ``sync``.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.fusion.associate import (apply_relabel,
                                                      associate_instances)
from slam_maskrcnn_tpu_torch.fusion import state as _state
from slam_maskrcnn_tpu_torch.fusion.fuse import (fuse_frame,
                                                 fuse_frame_dense,
                                                 fuse_frames2,
                                                 init_from_first_frame,
                                                 to_dense)
from slam_maskrcnn_tpu_torch.fusion.raycast import back_project_probe
from slam_maskrcnn_tpu_torch.fusion.splat import (depth_probe,
                                                  probe_from_rows,
                                                  splat_probe)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, TSDFState
from slam_maskrcnn_tpu_torch.utils.profiling import span, sync, to_host


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
        with span("probe"):
            probs, bm, s, overflow = _probe(vol, depth, extrinsic2init,
                                            intrinsic, cfg, rows)
        with span("associate"):
            relabel, num_objs = associate_instances(
                probs, bm, mask[::s, ::s], vol.n_obs, vol.num_objs, cfg)
    else:
        with span("associate"):
            relabel = torch.arange(cfg.max_objects, device=vol.device)
            num_objs = mask.max().to(torch.int32) + 1
            overflow = _zero(vol)
    with span("relabel"):
        mask_g = apply_relabel(mask, relabel)
        vol.num_objs = num_objs
    if mark is not None:
        mark("associate")
    with span("fuse"):
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
        with span("probe"):
            probs1, bm1, s, ovf1 = _probe(vol, d1, e1, intrinsic, cfg)
        with span("associate"):
            relabel1, num1 = associate_instances(
                probs1, bm1, m1[::s, ::s], vol.n_obs, vol.num_objs, cfg)
    else:
        with span("associate"):
            relabel1 = torch.arange(K, device=dev)
            num1 = m1.max().to(torch.int32) + 1
            ovf1 = _zero(vol)
    with span("relabel"):
        mask_g1 = apply_relabel(m1, relabel1)

    # frame 2: the same (pre-pair) histogram, num_objs chained through 1
    with span("probe"):
        probs2, bm2, s, ovf2 = _probe(vol, d2, e2, intrinsic, cfg)
        if cfg.pair_probe_boost:
            g1 = mask_g1[::s, ::s].to(torch.int64)
            d1s = (d1[::s, ::s].to(torch.int32).to(torch.float32)
                   / cfg.depth_scale)
            d2s = (d2[::s, ::s].to(torch.int32).to(torch.float32)
                   / cfg.depth_scale)
            near = ((d1s > 0) & (d2s > 0)
                    & ((d1s - d2s).abs() <= float(vol.mu)))
            oh = ((g1[..., None] == torch.arange(K, device=dev))
                  & near[..., None])
            probs2 = probs2 + oh.to(probs2.dtype)
            bm2 = bm2 | oh
    with span("associate"):
        relabel2, num2 = associate_instances(probs2, bm2, m2[::s, ::s],
                                             vol.n_obs + 1, num1, cfg)
    with span("relabel"):
        mask_g2 = apply_relabel(m2, relabel2)
        vol.num_objs = num2
    if mark is not None:
        mark("associate")
    with span("fuse"):
        fuse_frames2(vol, d1, c1, mask_g1, e1, d2, c2, mask_g2, e2,
                     intrinsic, cfg)
    if mark is not None:
        mark("fuse")
    return vol, (mask_g1, mask_g2), ovf1 + ovf2


def fuse_pair_sequence(vol: TSDFState, depths, colors, masks,
                       extrinsics2init, intrinsic, cfg: FusionConfig):
    """A pre-staged frame stack ([N, ...], N even) fused two frames per
    step, in place. Warm the volume with one sequential frame first.
    Returns (vol, relabeled masks [N, H, W], misses [N // 2])."""
    N = depths.shape[0]
    if N % 2:
        raise ValueError(f"paired fusion needs an even frame count, got {N}")
    out, misses = [], []
    for i in range(0, N, 2):
        vol, (g1, g2), miss = fusion_step_pair(
            vol, depths[i], colors[i], masks[i], extrinsics2init[i],
            depths[i + 1], colors[i + 1], masks[i + 1],
            extrinsics2init[i + 1], intrinsic, cfg)
        out += [g1, g2]
        misses.append(miss)
    return vol, torch.stack(out), torch.stack(misses)


def fuse_sequence_blocked(vol: TSDFState, depths, colors, masks,
                          extrinsics2init, intrinsic, cfg: FusionConfig):
    """A pre-staged frame stack ([N, ...]) fused one kernel step per frame,
    in place (the JAX package's ``fuse_sequence_blocked``, pipeline.py:173,
    one ``lax.scan`` of ``fusion_step_blocked_impl``). Returns (vol,
    relabeled masks [N, H, W], misses [N])."""
    out, misses = [], []
    for i in range(depths.shape[0]):
        vol, g, miss = fusion_step(vol, depths[i], colors[i], masks[i],
                                   extrinsics2init[i], intrinsic, cfg)
        out.append(g)
        misses.append(miss)
    return vol, torch.stack(out), torch.stack(misses)


def fusion_step_dense(state: TSDFState, depth: torch.Tensor,
                      color: torch.Tensor, mask: torch.Tensor,
                      extrinsic2init, intrinsic, intrinsic_inv,
                      cfg: FusionConfig):
    """One frame of the dense path, in place on ``state`` (the JAX
    package's ``fusion_step``, pipeline.py:35-66): from the second fused
    frame on, the trilinear back-projection probe of the stored histogram
    (fusion/raycast.py), association and relabel; then
    ``fuse_frame_dense``. Returns (state, relabeled mask)."""
    H, W = depth.shape
    if state.n_obs > 0:
        probs, bm = back_project_probe(state, extrinsic2init, intrinsic_inv,
                                       H, W, cfg)
        relabel, num_objs = associate_instances(probs, bm, mask, state.n_obs,
                                                state.num_objs, cfg)
    else:
        relabel = torch.arange(cfg.max_objects, device=state.device)
        num_objs = mask.max().to(torch.int32) + 1
    mask_g = apply_relabel(mask, relabel)
    state.num_objs = num_objs
    fuse_frame_dense(state, depth, color, mask_g, extrinsic2init, intrinsic,
                     cfg)
    return state, mask_g


def fuse_sequence(state: TSDFState, depths, colors, masks,
                  extrinsics2init, intrinsic, intrinsic_inv,
                  cfg: FusionConfig):
    """A pre-staged frame stack ([N, ...]) through ``fusion_step_dense``,
    in place (the JAX package's ``fuse_sequence``, pipeline.py:364).
    Returns (state, relabeled masks [N, H, W])."""
    out = []
    for i in range(depths.shape[0]):
        state, g = fusion_step_dense(state, depths[i], colors[i], masks[i],
                                     extrinsics2init[i], intrinsic,
                                     intrinsic_inv, cfg)
        out.append(g)
    return state, torch.stack(out)


def _tensor(a, dev) -> torch.Tensor:
    """A frame array (numpy, or a tensor already staged) on ``dev``. An
    array in host memory is a blocking upload."""
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(dev)
    with sync("upload"):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.from_numpy(np.asarray(a)).to(dev)


class SemanticFusion:
    """Host-side owner of the volume (the reference's ``TSDF`` class +
    ``kernel.cpp`` glue). Frames are numpy arrays or tensors already on
    ``device``; the volume lives on ``device``.

    backend: "xla" (the JAX package's default: the dense torch fuse at
    cfg.hist_dtype and the exact trilinear probe) or "pallas" (the fuse
    kernel on a u16 histogram and the splat or depth probe). Majority-vote
    mode keeps no histogram for the probe to read (the JAX package's
    ``fusion_step`` fails to trace there too), so it raises here: fuse such
    a volume with fusion/fuse.py ``fuse_frame_dense``.

    miss_check_every ("pallas" only): read the step's miss count (budget
    overflow of the splat probe: surface it did not see) back every N fused
    frames, a device -> host sync, so not every frame. Misses found go to
    ``on_miss(frame_idx, misses)`` if given, else ``warnings.warn``, and
    add up in ``total_misses``. 0 disables."""

    def __init__(self, intrinsic: np.ndarray, cfg: FusionConfig | None = None,
                 backend: str = "xla", device="cuda",
                 miss_check_every: int = 8, on_miss=None):
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend {backend!r}: 'xla' or 'pallas'")
        self.device = resolve_device(device)
        self.backend = backend
        self.cfg = cfg or FusionConfig()
        if self.cfg.majority_vote:
            raise ValueError(
                "SemanticFusion associates through the instance histogram, "
                "which majority-vote mode does not keep; fuse with "
                "fusion.fuse.fuse_frame_dense instead")
        K = np.asarray(intrinsic, np.float32)
        if K.shape == (3, 3):
            K4 = np.eye(4, dtype=np.float32)
            K4[:3, :3] = K
            K = K4
        self.intrinsic = K
        self.intrinsic_inv = np.linalg.inv(K).astype(np.float32)
        self.miss_check_every = miss_check_every
        self.on_miss = on_miss
        self.total_misses = 0
        self._frame_idx = 0
        self.state: TSDFState | None = None
        self.init_extrinsic_inv: np.ndarray | None = None
        self.mean_depth: float | None = None
        self.last_misses: torch.Tensor | None = None

    def parse_frame(self, depth, color, mask, extrinsic: np.ndarray,
                    mean_depth: float | None = None):
        """Feed one frame. Returns the relabeled (global-id) mask tensor for
        frames that fuse, else None (frame 0 only initializes). The step's
        miss count stays in ``last_misses`` (a device tensor)."""
        with span("parse_frame"):
            return self._parse_frame(depth, color, mask, extrinsic,
                                     mean_depth)

    def _parse_frame(self, depth, color, mask, extrinsic, mean_depth):
        if self.state is None or mean_depth is None:
            host_depth = (to_host("depth", depth).numpy()
                          if isinstance(depth, torch.Tensor)
                          else np.asarray(depth))
        if mean_depth is None:
            valid = host_depth > 0
            mean_depth = float((host_depth[valid].astype(np.float64)
                                / self.cfg.depth_scale).mean())
        if self.state is None:
            with span("init"):
                init = (init_from_first_frame if self.backend == "pallas"
                        else _state.init_from_first_frame)
                self.state = init(self.cfg, host_depth, self.intrinsic,
                                  mean_depth, self.device)
                self.init_extrinsic_inv = np.linalg.inv(
                    np.asarray(extrinsic, np.float64)).astype(np.float32)
                self.mean_depth = mean_depth
            return None
        e2i = (np.asarray(extrinsic, np.float32)
               @ self.init_extrinsic_inv).astype(np.float32)
        dev = self.device
        with span("upload"):
            depth, color, mask = (_tensor(depth, dev), _tensor(color, dev),
                                  _tensor(mask, dev))
        if self.backend == "xla":
            self.state, mask_g = fusion_step_dense(
                self.state, depth, color, mask, e2i, self.intrinsic,
                self.intrinsic_inv, self.cfg)
            return mask_g
        self.state, mask_g, self.last_misses = fusion_step(
            self.state, depth, color, mask, e2i, self.intrinsic, self.cfg)
        self._frame_idx += 1
        if (self.miss_check_every
                and self._frame_idx % self.miss_check_every == 0):
            with sync("misses"):  # every Nth frame only
                m = int(self.last_misses)
            if m > 0:
                self.total_misses += m
                if self.on_miss is not None:
                    self.on_miss(self._frame_idx, m)
                else:
                    import warnings
                    warnings.warn(
                        f"the splat probe dropped {m} surface voxels at "
                        f"frame {self._frame_idx}; raise the splat budgets "
                        "(FusionConfig.splat_max_*) for exact association")
        return mask_g

    def dense_state(self):
        """The volume as numpy arrays in the JAX TSDFState layout, either
        backend."""
        return to_dense(self.state)
