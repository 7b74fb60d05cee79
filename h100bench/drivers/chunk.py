"""Driver form ``chunk``: ``NorthStar.run_chunk_paired`` over chunks of
consecutive orbit frames staged on the device (batched detect, the
paired fuse, the in-loop render).

Set-up: the orbit's frames, the model with the harness's weights, the
volume sized from frame 0, frame 1 through ``step`` (the paired chunk
needs a warmed volume), then one chunk, which builds and warms every
kernel and shape the window uses. A window call is one chunk.

Judged: the window's call ``j`` (drawn from the seed below the cell's
``judge_calls``): its frames' label images against the reference
detector at the chunk's batch, and, replaying every frame fused through
call ``j`` with the port's label images, its relabeled masks, renders
and the state's kept planes after it. A frame fails when its pair's
render or probe reports misses (splat budget overflow).
"""

from __future__ import annotations

from h100bench import judge, northstar, traffic


class Driver:
    fuse_per_launch = 2

    def __init__(self, config, cell, seed, dev, trace):
        self.config, self.cell, self.seed, self.dev = config, cell, seed, dev
        self.p = p = northstar.Program(config, cell, seed, dev)
        self.n = cell["traffic"]["chunk"]
        self.detect_batch = self.n
        self.seq = p.seq
        self.j = int(judge.pick(seed, cell["judge_calls"], 1, 1)[0])
        self.xs = judge.pick(seed, p.cfg.vol_dim[0], judge.PLANES, 2)
        idx, d, c, e, a = p.frames(1)
        p.state, *_ = p.ns.step(p.state, d[0], c[0], e[0], a[0], p.dist)
        self.fused = [idx]                          # frames, in fuse order
        _, _, _, misses = self._chunk()
        # the harness's own operations in the window, once here, so that
        # no kernel of theirs loads inside it
        judge.planes(p.state, self.xs)
        (misses > 0).sum()
        self.geometry = dict(vol_start=p.state.vol_start,
                             voxel=p.state.voxel, mu=float(p.state.mu))
        self.call_frames, self.bad, self.out = [], None, None

    def _chunk(self, mark=None):
        p = self.p
        idx, d, c, e, a = p.frames(self.n)
        p.state, renders, masks_g, misses = p.ns.run_chunk_paired(
            p.state, d, c, e, a, p.dist, mark=mark)
        if p.capturing:
            self.fused.append(idx)
        return idx, renders, masks_g, misses

    def call(self, mark=None) -> int:
        idx, renders, masks_g, misses = self._chunk(mark)
        bad = 2 * (misses > 0).sum()
        self.bad = bad if self.bad is None else self.bad + bad
        self.call_frames.append(idx)
        if len(self.call_frames) == self.j + 1:
            self.out = dict(masks_g=masks_g, renders=renders,
                            planes=judge.planes(self.p.state, self.xs))
            self.p.stop_capture()
        return self.n

    def judged(self) -> bool:
        """Whether the judged outputs are held."""
        return self.out is not None

    def release(self) -> None:
        self.labels = self.p.all_labels()
        self.p.release()

    def judge(self):
        cfg, cell, seed, dev, seq = (self.config, self.cell, self.seed,
                                     self.dev, self.seq)
        limits = cell["limits"]
        n_before = sum(len(i) for i in self.fused[:-1])
        ref_l = northstar.reference_labels(
            cfg, cell, seed, dev, seq, traffic.take(seq.color,
                                                    self.fused[-1]), self.n)
        out = northstar.detector_numbers(self.labels[n_before:], ref_l,
                                         limits)
        del ref_l

        masks_g, renders, state = northstar.replay(
            cfg, cell, seed, dev, seq, self.fused, self.labels, True)
        ref_out = dict(masks_g=masks_g[-self.n:], renders=renders[-self.n:],
                       planes=judge.planes(state, self.xs))
        out.update(northstar.fusion_numbers(self.out, ref_out, limits))
        attempted = self.n * len(self.call_frames)
        return out, int(self.bad), attempted
