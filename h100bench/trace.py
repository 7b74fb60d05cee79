"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over
calls made after the window, reduced to the device's busy time (the
union of its kernel, copy and set intervals, so overlapping work counts
once), the device time of each kernel by name, and the breakdown the
result line carries: the device operations that took most time, and the
longest idle gaps of the device, each named by the CUDA runtime call the
host was in (or, outside any, by the device operation that followed),
leaving out those the profiler's own buffer requests made.

On the card the profiler records device activity only (kernels, copies
and the runtime calls that launched them): recording every host
operation as well slowed the host-bound cells to about half their pace.
"""

from __future__ import annotations

N_TOP = 10
NAME_CHARS = 96
# the profiler's own stall while CUPTI hands it a fresh record buffer: a
# gap under it is the trace's cost, not the program's, and is not listed
PROFILER_STALL = "Activity Buffer Request"


def start(on_card: bool):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, window_s: float) -> dict:
    """busy_s, window_s, per-kernel device seconds ({name: [seconds of
    each launch]}) and the breakdown of one traced stretch."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((r.start, r.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((r.start, r.end, e.name))
    busy = _union((a, b) for a, b, _ in dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    kernels, total = {}, {}
    for a, b, name in dev:
        kernels.setdefault(name, []).append((b - a) * 1e-6)
        total[name] = total.get(name, 0.0) + (b - a) * 1e-6
    starts = sorted((a, name) for a, _, name in dev)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps:
        if len(named) == N_TOP:
            break
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid < h[1]]
        if any(h[2] == PROFILER_STALL for h in inner):
            continue
        if inner:
            name = min(inner, key=lambda h: h[1] - h[0])[2]
        else:
            nxt = next((n for s, n in starts if s >= b), "the end")
            name = "host, then " + nxt
        named.append([name[:NAME_CHARS], (b - a) * 1e-6])
    top = sorted(total.items(), key=lambda kv: -kv[1])[:N_TOP]
    return dict(busy_s=busy_s, window_s=window_s, kernels=kernels,
                breakdown=dict(device_ops=[[k[:NAME_CHARS], v]
                                           for k, v in top],
                               idle_gaps=named))
