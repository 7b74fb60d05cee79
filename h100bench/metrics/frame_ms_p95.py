"""The 95th percentile over the window's calls of one frame's latency:
from the call to its outputs ready on the device (CUDA events recorded
by the harness at the call's start and after it returns). Cells whose
calls carry one frame each."""

import statistics


def read(record):
    ms = [t / n for n, t in record["call_ms"]]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=100)[94]
