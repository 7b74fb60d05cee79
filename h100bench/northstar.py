"""What the north-star drivers (``drivers/chunk.py``, ``drivers/step.py``)
share: the port's ``NorthStar`` built from a configuration with the
harness's weights, the label images its detect produced (read by
wrapping the runner's public ``detect`` / ``detect_batched`` while the
judged frames and those before them run), and the plain reference that
replays them.

The reference runs in two parts, as the port's stages meet at the label
images:

* the detector: the reference graph (``reference/mask_rcnn.py``, the
  same weights) on the judged frames, at the batch the port ran them,
  against the port's label images (``label_mismatch``);
* the fusion: from the first frame, every frame the port fused before and
  through the judged frames, fed the port's own label images (so that a
  difference in the detector does not carry into the fusion's numbers):
  the relabeled masks, the renders and the state after them.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch

from h100bench import judge, traffic, weights
from h100bench.reference import backbone as ref_backbone
from h100bench.reference import fuse as ref_fuse
from h100bench.reference import north_star as ref_ns
from h100bench.reference import state as ref_state


def fusion_cfg(config: dict, cell: dict, cfg_cls):
    """A FusionConfig (the port's or the reference's class) of the
    configuration's fusion section with the cell's overrides."""
    f = dict(config["fusion"], **cell.get("fusion", {}))
    f["vol_dim"] = tuple(f["vol_dim"])
    f["hist_dtype"] = getattr(np, f["hist_dtype"])
    return cfg_cls(**f)


def port_model(config: dict, state_dict: dict, dev):
    """The port's MaskRCNN for the configuration, built on ``dev`` and
    loaded with the harness's weights."""
    from slam_maskrcnn_tpu_torch.models.config import Config
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    attrs = {k: (np.array(v) if isinstance(v, list) else v)
             for k, v in config["detector"].items() if k != "IMAGE_SHAPE"}
    cfg = type("BenchConfig", (Config,), attrs)()
    with torch.device(dev):
        model = MaskRCNN("inference", cfg, device=dev)
    model.module.load_state_dict(state_dict, strict=True)
    model.initialized = True
    return model


class Program:
    """The port's runner, its volume, the orbit's frames, and the label
    images of the calls made while ``capturing``."""

    def __init__(self, config: dict, cell: dict, seed: int, dev):
        from slam_maskrcnn_tpu_torch.fusion.fuse import init_from_first_frame
        from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
        from slam_maskrcnn_tpu_torch.samples.north_star import NorthStar

        cam = config["camera"]
        self.H, self.W = cam["height"], cam["width"]
        self.K = traffic.intrinsic(cam)
        self.seq = traffic.sequence(cell["traffic"], cam, seed, dev)
        n = len(self.seq)
        self.angles = (2 * np.pi * np.arange(n) / n).astype(np.float32)
        self.dist = self.seq.mean_depth
        self.cfg = fusion_cfg(config, cell, FusionConfig)
        ref = reference_runner(config, cell, seed, dev, self.seq)
        self.model = port_model(config, ref.model.module.state_dict(), dev)
        del ref
        self.ns = NorthStar(self.model, self.K, self.cfg, self.H, self.W,
                            render_mode=cell["render"])
        self.state = init_from_first_frame(
            self.cfg, self.seq.depth[0].cpu().numpy(), self.K,
            self.seq.mean_depth, device=dev)
        self.labels = []                   # label images [n, H, W] a call
        self.capturing = True
        self._pos = 1                      # frame 0 sizes the volume
        for name in ("detect", "detect_batched"):
            setattr(self.ns, name, self._capture(getattr(self.ns, name)))

    def _capture(self, fn):
        def wrapped(colors, mark=None):
            out = fn(colors, mark)
            if self.capturing:
                self.labels.append(out if out.dim() == 3 else out[None])
            return out
        return wrapped

    def stop_capture(self) -> None:
        """Drop the wrappers: the calls after the judged frames run the
        runner's own methods."""
        self.capturing = False
        for name in ("detect", "detect_batched"):
            delattr(self.ns, name)

    def frames(self, n: int):
        """The next ``n`` frames of the orbit (index, depth, color, e2i,
        angle), cycling."""
        i = self._pos
        self._pos = (i + n) % len(self.seq)
        idx = np.arange(i, i + n) % len(self.seq)
        if idx[-1] == i + n - 1:
            sl = slice(i, i + n)
            return idx, self.seq.depth[sl], self.seq.color[sl], \
                self.seq.e2i[sl], self.angles[sl]
        return idx, traffic.take(self.seq.depth, idx), \
            traffic.take(self.seq.color, idx), self.seq.e2i[idx], \
            self.angles[idx]

    def release(self) -> None:
        """Free the volume and the model (the judgement runs after)."""
        self.state = self.ns = self.model = None

    def all_labels(self) -> torch.Tensor:
        return torch.cat(self.labels)


def reference_runner(config: dict, cell: dict, seed: int, dev, seq=None):
    """The reference's NorthStar (``reference/north_star.py``); with
    ``seq`` (the traffic), also the reference graph with the harness's
    weights: drawn from the seed, calibrated on four of the orbit's
    frames (``calibration_colors``)."""
    det = config["detector"]
    cfg_obj = types.SimpleNamespace(
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in det.items()})
    model = types.SimpleNamespace(module=None, config=cfg_obj,
                                  device=torch.device(dev))
    cam = config["camera"]
    cfg = fusion_cfg(config, cell, ref_state.FusionConfig)
    ref = ref_ns.NorthStar(model, traffic.intrinsic(cam), cfg,
                           cam["height"], cam["width"],
                           render_mode=cell["render"])
    if seq is not None:
        model.module = reference_module(config, seed, dev, ref,
                                        calibration_colors(seq))
    return ref


def calibration_colors(seq) -> torch.Tensor:
    """The traffic's frames the weights are calibrated on [4, H, W, 3]."""
    return traffic.take(seq.color, weights.calibration_frames(len(seq)))


def reference_module(config: dict, seed: int, dev, runner, colors):
    """The reference graph with the harness's weights: drawn from the
    seed, calibrated on ``colors`` (``calibration_colors``) molded by
    ``runner`` (a reference NorthStar for the configuration's camera)."""
    det = config["detector"]
    module = weights.reference_module(det, dev).to(dev)
    weights.draw(module, seed, config["weights"])
    weights.calibrate(module, ref_ns._mold(colors, runner.geom,
                                           runner.mean_pixel),
                      runner.anchors, runner.nwin.expand(len(colors), -1),
                      config["weights"], det["BBOX_STD_DEV"])
    return module


def reference_labels(config, cell, seed, dev, seq, colors: torch.Tensor,
                     batch: int, quant=None) -> torch.Tensor:
    """The reference detector's label images of ``colors`` [N, H, W, 3],
    ``batch`` frames to a graph run, its layers' inputs and weights
    rounded through ``quant`` (the precision control) when given."""
    ref = reference_runner(config, cell, seed, dev, seq)
    ref_backbone.QUANT = quant
    try:
        with torch.no_grad():
            return torch.cat([ref.detect_batched(colors[i:i + batch])
                              for i in range(0, colors.shape[0], batch)])
    finally:
        ref_backbone.QUANT = None


def replay(config, cell, seed, dev, seq, fused, labels, pair: bool):
    """The reference's fusion over the frames the port fused: the volume
    sized from frame 0, then each group of ``fused`` (frame index arrays,
    in order) as the port ran it: the first group one frame through
    ``step``'s path, each later group a paired chunk (``pair``) or one
    frame; ``labels`` [N, H, W] the label images of all fused frames in
    order. Returns the relabeled masks and renders of every fused frame,
    in order, and the final volume."""
    ref = reference_runner(config, cell, seed, dev)
    state = ref_fuse.init_from_first_frame(
        ref.cfg, seq.depth[0].cpu().numpy(), ref.intrinsic, seq.mean_depth,
        device=dev)
    n = len(seq)
    angles = (2 * np.pi * np.arange(n) / n).astype(np.float32)
    at, masks_all, renders_all = 0, [], []
    with torch.no_grad():
        for g, idx in enumerate(fused):
            lab = labels[at:at + len(idx)]
            at += len(idx)
            if pair and g > 0:
                state, renders, masks_g, _ = ref._run(
                    state, traffic.take(seq.depth, idx),
                    traffic.take(seq.color, idx), seq.e2i[idx],
                    angles[idx], seq.mean_depth, lab, True, None)
            else:
                i = idx[0]
                state, r, mg, _ = ref._frame(
                    state, lab[0], seq.depth[i], seq.color[i], seq.e2i[i],
                    angles[i], seq.mean_depth, None)
                renders, masks_g = r[None], mg[None]
            masks_all.append(masks_g)
            renders_all.append(renders)
    return torch.cat(masks_all), torch.cat(renders_all), state


def detector_numbers(prog_labels: torch.Tensor, ref_labels: torch.Tensor,
                     limits: dict) -> dict:
    inst = prog_labels.flatten(1).amax(1).float()
    print(f"instances a judged frame: mean {float(inst.mean()):.2f}, "
          f"min {int(inst.min())}, max {int(inst.max())}", file=sys.stderr)
    return {"label_mismatch": (judge.label_mismatch(prog_labels,
                                                    ref_labels),
                               limits["label_mismatch"])}


def control_numbers(config: dict, cell: dict, seed: int, dev, fused,
                    pair: bool, batch: int, n_last: int) -> dict:
    """The precision control of a north-star cell: the reference in the
    port's place one precision below the configuration's, its graph's
    layer inputs and weights rounded through float8 (e4m3, below
    bfloat16) and its TSDF update in bfloat16 (below float32), over the
    frames ``fused`` (groups as ``replay`` takes them; the last ``n_last``
    frames are the judged ones), against the reference fed the same label images.
    Returns the numbers the cell compares for it."""
    seq = traffic.sequence(cell["traffic"], config["camera"], seed, dev)
    frames = np.concatenate(fused)
    colors = traffic.take(seq.color, frames)
    ref_l = reference_labels(config, cell, seed, dev, seq, colors, batch)
    ctl_l = reference_labels(config, cell, seed, dev, seq, colors, batch,
                             quant=torch.float8_e4m3fn)
    out = detector_numbers(ctl_l[-n_last:], ref_l[-n_last:], cell["limits"])
    xs = judge.pick(seed, config["fusion"]["vol_dim"][0], judge.PLANES, 2)
    sides = []
    for dtype in (torch.float32, torch.bfloat16):
        ref_fuse.FUSE_DTYPE = dtype
        try:
            m, r, st = replay(config, cell, seed, dev, seq, fused, ctl_l,
                              pair)
        finally:
            ref_fuse.FUSE_DTYPE = torch.float32
        sides.append(dict(masks_g=m[-n_last:], renders=r[-n_last:],
                          planes=judge.planes(st, xs)))
        del st
    out.update(fusion_numbers(sides[1], sides[0], cell["limits"]))
    return out


def fusion_numbers(prog: dict, ref: dict, limits: dict) -> dict:
    """The judged frames' relabeled masks, their renders (where the cell
    renders: its limits name ``render_mismatch``), and the state's kept
    planes, each against its limit."""
    out = {"mask_g_mismatch": judge.share_differing(prog["masks_g"],
                                                    ref["masks_g"])}
    if "render_mismatch" in limits:
        out["render_mismatch"] = judge.share_differing(prog["renders"],
                                                       ref["renders"])
    out.update(judge.state_numbers(prog["planes"], ref["planes"]))
    return {k: (v, limits[k]) for k, v in out.items()}
