#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its driver form (``drivers/<driver>.py``) and
its traffic. The metrics are the ones ``BENCHMARK.json`` (at the root of
the checkout) gives the cell: its end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``, each read by
``metrics/<metric>.py`` from the run's record. Nothing here names a cell,
a configuration or a metric: adding one is adding files.

A run: set-up (the driver builds the program, makes its inputs and
weights from the seed on the card and warms every shape it will use),
then a closed loop of the driver's calls for ``--seconds`` (each call is
issued when the previous one has finished on the device), then the
judgement (the driver's plain reference against what the window
produced), then one JSON line on standard output. With ``--trace 1`` the
window's calls carry stage marks, and once it has closed the driver makes
``trace_calls`` more calls under ``torch.profiler``.

It exits non-zero and prints no result without a CUDA card (or with
fewer cards than the cell asks for), and when the process holds JAX or
the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.time()        # set-up is counted from here

import argparse
import gc
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names no run may hold (compared whole: the port's
# package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_maskrcnn_tpu")


def load_module(path: str, name: str):
    """Import a harness file by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of ``bench`` that this cell reports."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


class StageClock:
    """CUDA events at a call's stage marks: ``ms()`` sums the time between
    consecutive marks under the later mark's name (the call's start is
    the first mark)."""

    def __init__(self, torch):
        self._torch = torch
        self.events = []
        self.mark("start")

    def mark(self, name):
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def ms(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class HostClock(StageClock):
    """StageClock on the host clock, for a run without a card (tests)."""

    def mark(self, name):
        self.events.append((name, time.perf_counter()))

    def ms(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + (b - a) * 1e3
        return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        root: str = ROOT, device: str = "cuda") -> dict:
    """One run of a cell. Returns the result object (the last line)."""
    import torch
    from h100bench import trace as tracing

    bench = read_json(root, "BENCHMARK.json")
    cell = read_json(root, "h100bench", "workloads", workload + ".json")
    config = read_json(root, "h100bench", "configs", cell["config"] + ".json")
    drv_mod = load_module(os.path.join(root, "h100bench", "drivers",
                                       cell["driver"] + ".py"),
                          "h100bench_driver_" + cell["driver"])
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    clock = (lambda: StageClock(torch)) if on_card else \
        (lambda: HostClock(torch))

    # one host thread for torch's own CPU work, so that its pool does not
    # contend with the host thread that drives the card
    torch.set_num_threads(1)
    drv = drv_mod.Driver(config, cell, seed, device, trace)
    sync()
    setup_s = time.time() - T0
    # set-up's objects leave the collector's generations: the window's
    # collections scan only what the window makes
    gc.collect()
    gc.freeze()

    # the window: a closed loop of calls, with --trace 1 each call's
    # stage marks taken by CUDA events
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    calls = []
    t_start = time.perf_counter()
    while True:
        c = clock()
        n = drv.call(c.mark if trace else None)
        c.mark("end")
        sync()
        calls.append((n, c))
        # the window closes after --seconds, and not before the driver
        # holds the outputs it judges
        if time.perf_counter() - t_start >= seconds and drv.judged():
            break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    record = dict(
        config=config, cell=cell, seed=seed, setup_s=setup_s,
        window_s=window_s, frames=sum(n for n, _ in calls),
        call_ms=[(n, sum(c.ms().values())) for n, c in calls],
        peak_bytes=peak, driver=drv)
    if trace:
        stage_ms = {}
        for n, c in calls:
            for k, v in c.ms().items():
                stage_ms[k] = stage_ms.get(k, 0.0) + v
        record.update(stage_ms=stage_ms, stage_frames=record["frames"])
        # the traced stretch: ``trace_calls`` more calls after the window
        # has closed, under the profiler (device activity only, so that
        # the host runs at nearly its untraced pace)
        prof = tracing.start(on_card)
        frames_traced = 0
        t0 = time.perf_counter()
        for _ in range(cell["trace_calls"]):
            frames_traced += drv.call(None)
            sync()
        t_trace = time.perf_counter() - t0
        prof.stop()
        record.update(trace_first=len(calls), trace_frames=frames_traced,
                      trace=tracing.reduce(prof, t_trace))
        print(f"traced stretch: {frames_traced / t_trace!r} frames/s, "
              f"window: {record['frames'] / window_s!r} frames/s",
              file=sys.stderr)

    drv.release()                          # the program's state is freed
    if on_card:
        torch.cuda.empty_cache()
    compared, failed, attempted = drv.judge()
    correct = failed == 0 and all(v <= lim for v, lim in compared.values())

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        reader = load_module(os.path.join(root, "h100bench", "metrics",
                                          m["name"] + ".py"),
                             "h100bench_metric_" + m["name"].replace(".",
                                                                     "_"))
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell.get("chips", 1), memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=dev)
    if trace and record["trace"] is not None:
        t = record["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = t["breakdown"]
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    cell = read_json(HERE, "workloads", args.workload + ".json")
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.get("chips", 1):
        print(f"needs {cell.get('chips', 1)} CUDA card(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    held = forbidden_modules()
    if held:
        print(f"the run holds {held}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
