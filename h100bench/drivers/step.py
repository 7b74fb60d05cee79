"""Driver form ``step``: ``NorthStar.step``, one orbit frame a call (detect
at batch 1, label, probe, associate, fuse; the cell's render mode).

Set-up: the orbit's frames, the model with the harness's weights, the
volume sized from frame 0, then ``warm_frames`` steps, which build and
warm every kernel and shape the window uses. A window call is one frame.

Judged: the ``judge_frames`` window frames from call ``j`` on (``j``
drawn from the seed below the cell's ``judge_calls``): their label
images against the reference detector at batch 1, and, replaying every
frame fused through them with the port's label images, their relabeled
masks, renders and the state's kept planes after the last. A frame fails
when it reports misses (splat budget overflow).
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import judge, northstar, traffic


class Driver:
    fuse_per_launch = 1
    detect_batch = 1

    def __init__(self, config, cell, seed, dev, trace):
        self.config, self.cell, self.seed, self.dev = config, cell, seed, dev
        self.p = p = northstar.Program(config, cell, seed, dev)
        self.seq = p.seq
        self.j = int(judge.pick(seed, cell["judge_calls"], 1, 1)[0])
        self.n_judged = cell["judge_frames"]
        self.xs = judge.pick(seed, p.cfg.vol_dim[0], judge.PLANES, 2)
        self.fused = []
        for _ in range(cell["warm_frames"]):
            _, _, _, miss = self._step()
        # the harness's own operations in the window, once here, so that
        # no kernel of theirs loads inside it
        judge.planes(p.state, self.xs)
        (miss > 0).sum()
        self.geometry = dict(vol_start=p.state.vol_start,
                             voxel=p.state.voxel, mu=float(p.state.mu))
        self.call_frames, self.bad = [], None
        self.out = dict(masks_g=[], renders=[])

    def _step(self, mark=None):
        p = self.p
        idx, d, c, e, a = p.frames(1)
        p.state, render, mask_g, miss = p.ns.step(p.state, d[0], c[0], e[0],
                                                  a[0], p.dist, mark=mark)
        if p.capturing:
            self.fused.append(idx)
        return idx, render, mask_g, miss

    def call(self, mark=None) -> int:
        idx, render, mask_g, miss = self._step(mark)
        bad = (miss > 0).sum()
        self.bad = bad if self.bad is None else self.bad + bad
        self.call_frames.append(idx)
        k = len(self.call_frames) - 1
        if self.j <= k < self.j + self.n_judged:
            self.out["masks_g"].append(mask_g)
            self.out["renders"].append(render)
        if k == self.j + self.n_judged - 1:
            self.out = dict(masks_g=torch.stack(self.out["masks_g"]),
                            renders=torch.stack(self.out["renders"]),
                            planes=judge.planes(self.p.state, self.xs))
            self.p.stop_capture()
        return 1

    def judged(self) -> bool:
        """Whether the judged outputs are held."""
        return "planes" in self.out

    def release(self) -> None:
        self.labels = self.p.all_labels()
        self.p.release()

    def judge(self):
        cfg, cell, seed, dev, seq = (self.config, self.cell, self.seed,
                                     self.dev, self.seq)
        limits = cell["limits"]
        judged = np.concatenate(self.fused[-self.n_judged:])
        ref_l = northstar.reference_labels(
            cfg, cell, seed, dev, seq, traffic.take(seq.color, judged), 1)
        out = northstar.detector_numbers(self.labels[-self.n_judged:],
                                         ref_l, limits)
        del ref_l

        k = self.n_judged
        masks_g, renders, state = northstar.replay(
            cfg, cell, seed, dev, seq, self.fused, self.labels, False)
        ref_out = dict(masks_g=masks_g[-k:], renders=renders[-k:],
                       planes=judge.planes(state, self.xs))
        out.update(northstar.fusion_numbers(self.out, ref_out, limits))
        return out, int(self.bad), len(self.call_frames)
