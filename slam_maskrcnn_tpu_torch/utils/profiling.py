"""Stage timers, a profiler trace and the reference's ``log()``.

Port of slam_maskrcnn_tpu/utils/profiling.py:

* ``StageTimer`` accumulates time per named stage. On a CUDA device it
  records a pair of CUDA events around the stage on the current stream
  and reads them only when the totals are asked for, so timing adds no
  host sync; on the CPU it reads the host clock.
* ``trace(log_dir)`` wraps ``torch.profiler`` (CPU and, where there is a
  card, CUDA activity) and writes a Chrome trace, ``trace.json``, to
  ``log_dir`` (perfetto reads it).
* ``log_tensor`` is the reference's ``log()`` (model.py:48-59): a text and
  the array's shape, min, max and dtype.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class StageTimer:
    """Accumulating per-stage timer on ``device`` (the card by default):

        timer = StageTimer()
        with timer("fuse"):
            ...
        print(timer.report())

    On the CPU, ``sync`` (a tensor or a list of them) is read back before
    the clock stops, as the JAX timer forces readback; CUDA events need
    no such readback."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._pending: list = []

    @contextlib.contextmanager
    def __call__(self, stage: str, sync=None):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending.append((stage, start, end))
                self.counts[stage] += 1
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                for x in sync if isinstance(sync, (list, tuple)) else [sync]:
                    if isinstance(x, torch.Tensor):
                        x.sum().item()
            self._totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    @property
    def totals(self) -> dict:
        """Seconds per stage (waits for the recorded CUDA events)."""
        if self._pending:
            self._pending[-1][2].synchronize()
            for stage, start, end in self._pending:
                self._totals[stage] += start.elapsed_time(end) / 1000.0
            self._pending = []
        return dict(self._totals)

    def report(self) -> str:
        totals = self.totals
        lines = []
        for k in sorted(totals, key=totals.get, reverse=True):
            n = self.counts[k]
            lines.append(f"{k:24s} {totals[k] * 1000:9.1f} ms total  "
                         f"{totals[k] / n * 1000:8.2f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(REPO, "build", "trace")):
    """A ``torch.profiler`` trace of the block, written to
    ``log_dir/trace.json`` (Chrome trace format) when it ends. Yields the
    profiler (``key_averages()`` and the rest)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def log_tensor(text: str, array=None):
    """= the reference's log() (model.py:48-59): ``text``, then the array's
    shape, min, max and dtype (a tensor is read as numpy)."""
    if array is not None:
        if isinstance(array, torch.Tensor):
            array = array.detach().cpu().numpy()
        a = np.asarray(array)
        text = text.ljust(25)
        text += (f"shape: {str(a.shape):20}  "
                 f"min: {a.min():10.5f}  max: {a.max():10.5f}  {a.dtype}"
                 if a.size else f"shape: {str(a.shape):20}  empty")
    print(text)
