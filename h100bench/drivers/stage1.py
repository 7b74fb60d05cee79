"""Driver form ``stage1``: ``models/mask_ops.batch_mask_process`` (the
reference's ``mask_process.py``) over folders of 480 x 640 ``rgb/*.png``
frames with no depth folder: each frame read with ``imread``, detected
(square molding), label-encoded on the host and written as a mask PNG.

Set-up: ``frames`` distinct frames spread over the orbit, written as PNG
files (the harness's own encoder) into ``frames_per_call`` frames a
folder under a fresh temporary directory in TMPDIR, the model with the
harness's weights, and one warm folder. A window call is one folder, its
masks written into a folder of their own; a frame counts when
``batch_mask_process`` returns, every mask of its folder written. The
harness's timer, passed as ``timer=`` (one a call), takes the stages
"read", "detect" and "write" on the host clock (each ends in a host
read-back).

Judged: the masks of window call ``j`` (drawn from the seed below the
cell's ``judge_calls``), read back from their PNG files, against the
reference's ``mask_detect`` of the same frames' pixels. The temporary
directory is removed after the judgement.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from h100bench import judge, northstar, png, traffic
from h100bench.reference import backbone as ref_backbone
from h100bench.reference import detect as ref_detect


def reference_masks(config, cell, seed, dev, calib, frames,
                    quant=None) -> torch.Tensor:
    """The reference's ``mask_detect`` label images of ``frames`` (RGB u8
    numpy [N, H, W, 3]), its graph's layer inputs and weights rounded
    through ``quant`` (the precision control) when given."""
    runner = northstar.reference_runner(config, dict(cell, render="none"),
                                        seed, dev)
    module = northstar.reference_module(config, seed, dev, runner, calib)
    det = ref_detect.HostDetector(module, runner.model.config, dev)
    ref_backbone.QUANT = quant
    try:
        with torch.no_grad():
            return torch.stack([torch.from_numpy(
                ref_detect.mask_detect(det, fr)) for fr in frames])
    finally:
        ref_backbone.QUANT = None


def control_numbers(config, cell, seed, dev) -> dict:
    """The precision control: the reference with its graph's layer inputs
    and weights rounded through float8 (e4m3, below the configuration's
    bfloat16) in the port's place over the frames of the folder a run
    judges, against the reference."""
    rgb, calib = _frames(config, cell, seed, dev)
    per = cell["traffic"]["frames_per_call"]
    j = int(judge.pick(seed, cell["judge_calls"], 1, 1)[0])
    f = j % (len(rgb) // per)
    frames = rgb[f * per:(f + 1) * per].numpy()
    ref = reference_masks(config, cell, seed, dev, calib, frames)
    ctl = reference_masks(config, cell, seed, dev, calib, frames,
                          torch.float8_e4m3fn)
    return northstar.detector_numbers(ctl, ref, cell["limits"])


def _frames(config, cell, seed, dev):
    """The cell's frames (RGB u8 [N, H, W, 3] on the host), spread over
    the orbit, and the frames the weights are calibrated on (BGR, on
    ``dev``)."""
    t = cell["traffic"]
    seq = traffic.sequence(t, config["camera"], seed, dev)
    idx = np.linspace(0, len(seq), t["frames"], endpoint=False)
    rgb = seq.color[torch.as_tensor(idx.astype(np.int64),
                                    device=dev)].flip(-1).cpu()
    return rgb, northstar.calibration_colors(seq)


class Timer:
    """``batch_mask_process``'s timer: host seconds per stage."""

    def __init__(self):
        self.s = {}

    @contextlib.contextmanager
    def __call__(self, stage, sync=None):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.s[stage] = self.s.get(stage, 0.0) + time.perf_counter() - t


class Driver:
    fuse_per_launch = None
    detect_batch = 1

    def __init__(self, config, cell, seed, dev, trace):
        from slam_maskrcnn_tpu_torch.models import mask_ops

        self.config, self.cell, self.seed, self.dev = config, cell, seed, dev
        self.process = mask_ops.batch_mask_process
        t = cell["traffic"]
        self.rgb, self.calib = _frames(config, cell, seed, dev)
        self.per = t["frames_per_call"]
        self.tmp = tempfile.mkdtemp(prefix="h100bench-stage1-")
        self.folders = []
        for f in range(t["frames"] // self.per):
            d = os.path.join(self.tmp, f"f{f}", "rgb")
            os.makedirs(d)
            for i in range(self.per):
                with open(os.path.join(d, f"{i:04d}.png"), "wb") as fh:
                    fh.write(png.encode_rgb(
                        self.rgb[f * self.per + i].numpy()))
            self.folders.append(os.path.dirname(d))
        runner = northstar.reference_runner(
            config, dict(cell, render="none"), seed, dev)
        module = northstar.reference_module(config, seed, dev, runner,
                                            self.calib)
        self.model = northstar.port_model(config, module.state_dict(), dev)
        del module, runner
        self.j = int(judge.pick(seed, cell["judge_calls"], 1, 1)[0])
        self.calls = 0
        self._folder(0, "warm")
        self.timers = []                   # one a call

    def _folder(self, f, tag, timer=None):
        src = self.folders[f % len(self.folders)]
        return self.process(self.model, os.path.join(src, "rgb"),
                            os.path.join(self.tmp, f"mask_{tag}"),
                            verbose=False, timer=timer)

    def call(self, mark=None) -> int:
        k = self.calls
        self.calls += 1
        self.timers.append(Timer())
        return self._folder(k, str(k), self.timers[-1])

    def stage_s(self, stage: str, n_calls: int) -> float | None:
        """Host seconds of ``stage`` over the first ``n_calls`` calls."""
        s = [t.s[stage] for t in self.timers[:n_calls] if stage in t.s]
        return sum(s) if s else None

    def judged(self) -> bool:
        return self.calls > self.j

    def release(self) -> None:
        self.model = None

    def judge(self):
        try:
            d = os.path.join(self.tmp, f"mask_{self.j}")
            f = self.j % len(self.folders)
            prog = torch.stack([torch.from_numpy(png.decode_gray8(
                open(os.path.join(d, n), "rb").read()))
                for n in sorted(os.listdir(d))])
            frames = self.rgb[f * self.per:(f + 1) * self.per].numpy()
            ref = reference_masks(self.config, self.cell, self.seed,
                                  self.dev, self.calib, frames)
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        out = northstar.detector_numbers(prog, ref, self.cell["limits"])
        return out, 0, self.calls * self.per
