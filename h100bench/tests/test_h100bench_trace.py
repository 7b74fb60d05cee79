"""trace.reduce on a hand-made event list: busy time is the union of the
device intervals (overlaps count once), each idle gap is named by the
runtime call the host was in, or else by the device operation after it,
a gap under the profiler's own buffer request is left out, and the
device operations are ranked by their summed time."""

import types

from torch.autograd import DeviceType

from h100bench import trace


def _ev(kind, start_us, end_us, name):
    return types.SimpleNamespace(
        device_type=kind, name=name,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_reduce_unions_and_names_gaps():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_ev(cuda, 0, 100, "a"), _ev(cuda, 50, 150, "b"),
              _ev(cuda, 400, 500, "a"), _ev(cuda, 1500, 1600, "c"),
              _ev(cuda, 2000, 2100, "a"), _ev(cpu, 200, 350, "cudaMemcpyAsync"),
              _ev(cpu, 1650, 1950, trace.PROFILER_STALL)]
    prof = types.SimpleNamespace(events=lambda: events)
    out = trace.reduce(prof, 0.002)
    assert abs(out["busy_s"] - 450e-6) < 1e-12
    assert out["window_s"] == 0.002
    assert [round(v, 12) for v in out["kernels"]["a"]] == [1e-4] * 3
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "host, then c" and abs(gaps[0][1] - 1e-3) < 1e-12
    assert gaps[1][0] == "cudaMemcpyAsync" and len(gaps) == 2
    ops = out["breakdown"]["device_ops"]
    assert [k for k, _ in ops] == ["a", "b", "c"]
