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

The port's own spans and counters (not in the JAX package): ``span(name)``
marks a layer of the program, ``sync(site)`` a host read-back or a
blocking upload (and counts it). They record only while a
``torch.profiler`` session records (``torch.autograd``'s profiler switch):
without one, both return one shared null context, so they stamp nothing
and keep nothing. While a session records, each span takes host stamps on the profiler's
clock (Unix-epoch nanoseconds, the base of the trace's events), its parent
and the id of the call it belongs to (every span under one root span
shares its root's call), and enters ``record_function`` under its name, so
that a trace with CPU activity (``trace()``) shows the port's layers.
Spans add no device work: no event, no sync, no launch. The records of the
newest session are ``last_session()``; ``idle_gaps`` names the device's
idle gaps of a trace by the innermost span that holds each. One counter
store holds every counter: ``sync.*`` while a session records, and
``launch.*`` always (``count``; ``kernels.launches`` is its view).
"""

from __future__ import annotations

import contextlib
import os
import threading
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


# ---------------------------------------------------------------- spans

_enabled = torch._C._autograd._profiler_enabled
_record_function = torch._C._profiler._RecordFunctionFast

NULL = contextlib.nullcontext()     # what span and sync give, unprofiled


class Span:
    """One span of a session: ``name``, host stamps ``start_ns`` and
    ``end_ns`` (Unix-epoch nanoseconds, as the profiler's trace), ``index``
    (its place in the session's spans), ``parent`` (its parent's index, or
    None for a root), ``call`` (the id of its root's call) and ``frame``
    (the frame of a chunk it belongs to, or None)."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "call",
                 "frame", "_rf", "_stack")

    def __enter__(self):
        self._rf = _record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        self._stack.pop()
        if not self._stack:
            _REC.local.frame = None
        return False


class Session:
    """The spans (in the order they opened) and counters that one profiler
    session recorded; ``calls`` the root spans opened so far."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.calls = 0


class _Recorder:
    """The spans and counters. ``counts`` is the counter store (totals
    since import); ``last`` the newest session, which the first record
    after a profiler started begins (``started``, set by
    torch.autograd.profiler's start hook, chained below)."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.last: Session | None = None
        self.started = True
        self.local = threading.local()

    def begin(self) -> Session:
        self.last = Session()
        self.started = False
        return self.last

    def session(self) -> Session:
        return self.begin() if self.started else self.last

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
            self.local.frame = None
        return st

    def open(self, name: str) -> Span:
        ses = self.session()
        st = self.stack()
        s = Span()
        s.name, s.end_ns, s._stack = name, None, st
        s.index = len(ses.spans)
        if st:
            s.parent, s.call = st[-1].index, st[-1].call
        else:
            ses.calls += 1
            s.parent, s.call = None, ses.calls
            self.local.frame = None
        s.frame = self.local.frame
        ses.spans.append(s)
        st.append(s)
        return s

    def add(self, name: str, on: bool) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1
        if on:
            c = self.session().counters
            c[name] = c.get(name, 0) + 1


_REC = _Recorder()


def _chain_start_hook() -> None:
    """Begin a session at every profiler start: torch.autograd.profiler
    calls ``_run_on_profiler_start`` as a session starts."""
    import torch.autograd.profiler as ap

    hook = ap._run_on_profiler_start
    if getattr(hook, "_port_spans", False):
        return

    def on_start():
        hook()
        _REC.started = True

    on_start._port_spans = True
    ap._run_on_profiler_start = on_start


_chain_start_hook()


def span(name: str):
    """A context that records the layer ``name`` while a profiler session
    records; the shared null context otherwise."""
    if not _enabled():
        return NULL
    return _REC.open(name)


def sync(site: str):
    """``span`` for a host read-back or a blocking upload at ``site``: the
    span ``sync:<site>``, and one more on the counter ``sync.<site>``.
    Around exactly the operation that waits, so it changes no result and
    adds no sync."""
    if not _enabled():
        return NULL
    _REC.add("sync." + site, True)
    return _REC.open("sync:" + site)


def to_host(site: str, t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()`` through ``sync(site)``."""
    with sync(site):
        return t.cpu()


def count(name: str) -> None:
    """One more on the counter ``name``, always (the session's too, while
    one records)."""
    _REC.add(name, _enabled())


def counters(prefix: str = "") -> dict:
    """The store's counters whose name starts with ``prefix`` (totals)."""
    return {k: v for k, v in _REC.counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str) -> None:
    """Zero the store's counters whose name starts with ``prefix``."""
    for k in _REC.counts:
        if k.startswith(prefix):
            _REC.counts[k] = 0


def frame(i: int) -> None:
    """Give the spans this thread opens from here until its root span
    closes the frame index ``i`` (a frame of a chunk)."""
    if _enabled():
        _REC.stack()
        _REC.local.frame = i


def last_session() -> Session | None:
    """The spans and counters of the newest profiler session (None before
    the first)."""
    return _REC.last


def current_span() -> str | None:
    """The name of this thread's innermost open span, if any."""
    st = getattr(_REC.local, "stack", None)
    return st[-1].name if st else None


def _trace_start_ns(prof) -> int:
    return prof.profiler.kineto_results.trace_start_ns()


def idle_gaps(prof, session: Session | None, n: int = 10) -> list:
    """The ``n`` longest idle gaps of the device in a finished profiler
    trace (between the union of its kernel, copy and set intervals), the
    longest first: [[name, seconds, start (seconds into the trace)]],
    each named by the innermost span of ``session`` that holds the gap's
    midpoint, or "outside the program"."""
    from torch.autograd import DeviceType

    busy = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy.append([e.time_range.start, e.time_range.end])
    busy.sort()
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])
                   if a1 > b0), key=lambda g: g[0] - g[1])[:n]
    base = _trace_start_ns(prof)
    spans = [] if session is None else sorted(
        (((s.start_ns - base) * 1e-3, (s.end_ns - base) * 1e-3, s.name)
         for s in session.spans if s.end_ns is not None),
        key=lambda s: (s[0], -s[1]))
    # the spans nest, so a sweep over the midpoints in time order keeps
    # the spans open at each on a stack, the innermost on top (a parent
    # sorts before a child that starts with it)
    names, stack, j = {}, [], 0
    for mid in sorted((a + b) / 2 for a, b in gaps):
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        names[mid] = stack[-1][2] if stack else "outside the program"
    return [[names[(a + b) / 2], (b - a) * 1e-6, a * 1e-6] for a, b in gaps]


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(REPO, "build", "trace"),
          n_gaps: int = 10):
    """A ``torch.profiler`` trace of the block, written to
    ``log_dir/trace.json`` (Chrome trace format) when it ends, with the
    port's spans in it, and beside it ``idle_gaps.txt``: the ``n_gaps``
    longest idle gaps of the device, each named by the port's span that
    holds it (``idle_gaps``). Yields the profiler (``key_averages()`` and
    the rest)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        session = _REC.begin()
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "idle_gaps.txt"), "w") as f:
        f.write("gap ms      at s        span\n")
        for name, secs, at in idle_gaps(prof, session, n_gaps):
            f.write(f"{secs * 1e3:9.3f}  {at:9.6f}  {name}\n")


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
