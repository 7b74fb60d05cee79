"""Driver form ``stage2``: ``SemanticFusion.parse_frame`` with backend
"pallas", as ``samples/fusion_demo.py`` calls it: one host frame a call
(depth u16, colour u8, the sequence's local-id mask u8, the world->camera
extrinsic, all numpy, and the depth at which frame 0 sizes the volume),
fused into the volume on the card.

Set-up: the orbit's frames made on the card and read back to the host
once (the stage decodes its PNGs before the loop in the reference's
driver; here they are made, not read), frame 0 (sizes the volume), then
``warm_frames`` frames, which build and warm every kernel and shape the
window uses. A window call is one frame.

Judged: the ``judge_frames`` window frames from call ``j`` on (``j``
drawn from the seed below the cell's ``judge_calls``): the reference's
``SemanticFusion`` replays every frame from frame 0 with the same host
inputs, and their relabeled masks and the state's kept planes after the
last are compared. A frame fails when its probe reports misses.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import judge, northstar, traffic
from h100bench.reference import fuse as ref_fuse
from h100bench.reference import pipeline as ref_pipeline
from h100bench.reference import state as ref_state


def replay(config, cell, K, dev, inputs, xs):
    """The reference's SemanticFusion over ``inputs`` (parse_frame's
    arguments, frame 0 first). Returns (relabeled masks of the fused
    frames, the state's planes ``xs``)."""
    cfg = northstar.fusion_cfg(config, cell, ref_state.FusionConfig)
    ref = ref_pipeline.SemanticFusion(K, cfg, device=dev)
    with torch.no_grad():
        masks_g = [ref.parse_frame(*a) for a in inputs][1:]
    return torch.stack(masks_g), judge.planes(ref.state, xs)


def numbers(prog: dict, ref_masks, ref_planes, limits: dict) -> dict:
    out = {"mask_g_mismatch": judge.share_differing(prog["masks_g"],
                                                    ref_masks)}
    out.update(judge.state_numbers(prog["planes"], ref_planes))
    return {k: (v, limits[k]) for k, v in out.items()}


def control_numbers(config, cell, seed, dev, n: int) -> dict:
    """The precision control: the reference with its per-voxel fuse
    arithmetic in bfloat16 (the step below the configuration's float32)
    in the port's place over the orbit's first ``n`` + 1 frames, against
    the reference in float32."""
    drv = Driver.__new__(Driver)
    drv._host_frames(config, cell, seed, dev)
    inputs = [drv._inputs(k) for k in range(n + 1)]
    xs = judge.pick(seed, config["fusion"]["vol_dim"][0], judge.PLANES, 2)
    ref = replay(config, cell, drv.K, dev, inputs, xs)
    ref_fuse.FUSE_DTYPE = torch.bfloat16
    try:
        masks, planes = replay(config, cell, drv.K, dev, inputs, xs)
    finally:
        ref_fuse.FUSE_DTYPE = torch.float32
    return numbers(dict(masks_g=masks, planes=planes), *ref,
                   cell["limits"])


class Driver:
    fuse_per_launch = 1
    detect_batch = None

    def __init__(self, config, cell, seed, dev, trace):
        from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
        from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig

        self.config, self.cell, self.seed, self.dev = config, cell, seed, dev
        self._host_frames(config, cell, seed, dev)
        self.sf = SemanticFusion(self.K, northstar.fusion_cfg(
            config, cell, FusionConfig), backend="pallas", device=dev)
        self.j = int(judge.pick(seed, cell["judge_calls"], 1, 1)[0])
        self.n_judged = cell["judge_frames"]
        self.xs = judge.pick(seed, config["fusion"]["vol_dim"][0],
                             judge.PLANES, 2)
        self._pos = 0
        self.fed = []
        for _ in range(1 + cell["warm_frames"]):
            self._frame()
        # the harness's own operations in the window, once here, so that
        # no kernel of theirs loads inside it
        judge.planes(self.sf.state, self.xs)
        (self.sf.last_misses > 0).sum()
        st = self.sf.state
        self.geometry = dict(vol_start=st.vol_start, voxel=st.voxel,
                             mu=float(st.mu))
        self.call_frames, self.bad = [], None
        self.out = dict(masks_g=[])

    def _host_frames(self, config, cell, seed, dev):
        cam = config["camera"]
        self.seq = seq = traffic.sequence(cell["traffic"], cam, seed, dev)
        self.host = dict(depth=seq.depth.cpu().numpy(),
                         color=seq.color.cpu().numpy(),
                         mask=seq.mask.cpu().numpy())
        self.K = traffic.intrinsic(cam)

    def _inputs(self, k: int):
        h = self.host
        return (h["depth"][k], h["color"][k], h["mask"][k],
                self.seq.extrinsic[k], self.seq.mean_depth)

    def _frame(self):
        k = self._pos
        self._pos = (k + 1) % len(self.seq)
        self.fed.append(k)
        return k, self.sf.parse_frame(*self._inputs(k))

    def call(self, mark=None) -> int:
        k, mask_g = self._frame()
        bad = (self.sf.last_misses > 0).sum()
        self.bad = bad if self.bad is None else self.bad + bad
        self.call_frames.append(np.array([k]))
        i = len(self.call_frames) - 1
        if self.j <= i < self.j + self.n_judged:
            self.out["masks_g"].append(mask_g)
        if i == self.j + self.n_judged - 1:
            self.out = dict(masks_g=torch.stack(self.out["masks_g"]),
                            planes=judge.planes(self.sf.state, self.xs))
            self.n_fed = len(self.fed)
        return 1

    def judged(self) -> bool:
        """Whether the judged outputs are held."""
        return "planes" in self.out

    def release(self) -> None:
        self.sf = None

    def judge(self):
        inputs = [self._inputs(k) for k in self.fed[:self.n_fed]]
        masks, planes = replay(self.config, self.cell, self.K, self.dev,
                               inputs, self.xs)
        out = numbers(self.out, masks[-self.n_judged:], planes,
                      self.cell["limits"])
        return out, int(self.bad), len(self.call_frames)
