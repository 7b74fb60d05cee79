#!/usr/bin/env python3
"""Where the port's host time and syncs go, cell by cell, on the card.

    python3 tools/torch_spans_card.py [--cells CELL ...] [--gaps CELL ...]

For each benchmark cell it builds the cell's driver as
``h100bench/run.py`` does (seed 7, full size; the JAX package is not
imported), then:

1. sites: two calls under ``torch.cuda.set_sync_debug_mode("warn")`` and a
   device-only profiler, every synchronising operation listed by the
   program's source line that issued it and the innermost span it ran
   in; one outside a ``sync:*`` span is a read-back the recorder misses;
2. pace: ``trace_calls`` calls with no profiler (frames/s);
3. stretch: ``trace_calls`` calls under the harness's profiler
   (``h100bench/trace.py`` ``start``: device activity only), as the
   traced stretch of a ``--trace 1`` run: frames/s, spans a frame, each
   span's host self time a frame (its time less its children's), the
   share of the stretch's host seconds that the calls' root spans cover,
   the syncs the profiler saw (``cudaStreamSynchronize``,
   ``cudaDeviceSynchronize``, ``cudaMemcpy``) against the program's
   ``sync.*`` counters plus the harness's one ``synchronize()`` a call,
   the launch calls a frame the profiler saw (``LAUNCH_CALLS``: torch's
   and the hand kernels' ``cudaLaunchKernel``, a graph's
   ``cudaGraphLaunch``), and the device's idle time a frame by the
   innermost span that holds each gap (every gap of the stretch, through
   ``idle_gaps``);
4. gaps (cells named by ``--gaps``): ``trace_calls`` calls under
   ``utils.profiling.trace`` (CPU and CUDA activity), and the ten longest
   idle gaps of the device named by ``idle_gaps``.

It also times the null path of ``span`` (no profiler) on this host. The
lines go to standard output and build/spans_card.json. A frame of the
training cell is a training image.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import threading
import time
import timeit
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

CELLS = ("ns512.step", "ref256.stage2", "ns512.chunk16", "ref256.stage1",
         "coco1024.train_all")
PKG = os.sep + "slam_maskrcnn_tpu_torch" + os.sep
OUT = os.path.join(ROOT, "build")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def build(cell: str, seed: int = 7):
    """The cell's driver, built and warmed as the harness builds it."""
    import torch

    from h100bench import run

    spec = run.read_json(ROOT, "h100bench", "workloads", cell + ".json")
    config = run.read_json(ROOT, "h100bench", "configs",
                           spec["config"] + ".json")
    mod = run.load_module(os.path.join(ROOT, "h100bench", "drivers",
                                       spec["driver"] + ".py"),
                          "h100bench_driver_" + spec["driver"])
    torch.set_num_threads(1)
    drv = mod.Driver(config, spec, seed, "cuda", True)
    torch.cuda.synchronize()
    gc.collect()              # as the harness does before its window
    gc.freeze()
    return drv, spec


def calls(drv, n: int) -> int:
    import torch

    frames = 0
    for _ in range(n):
        frames += drv.call(None)
        torch.cuda.synchronize()
    return frames


def sites(drv) -> dict:
    """Synchronising operations of two driver calls under a device-only
    profiler, by the program's innermost source lines and span."""
    import torch

    from h100bench import trace as tracing
    from slam_maskrcnn_tpu_torch.utils import profiling

    found = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        # the mode's own notice, given once when it is first turned on,
        # names no operation
        if ("synchronizing" not in str(message)
                or str(message).startswith("Synchronization debug mode")):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if PKG in f.filename]
        # outside the program: the innermost frames and the thread (the
        # autograd engine runs a card's backward on a thread of its own)
        where = (" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                             for f in reversed((own or stack)[-3:]))
                 + ("" if own else " (outside the program, thread "
                    f"{threading.current_thread().name}: {message})"))
        key = (where, profiling.current_span() or "")
        found[key] = found.get(key, 0) + 1

    prof = tracing.start(True)
    old = warnings.showwarning
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                frames = 0
                for _ in range(2):
                    frames += drv.call(None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        warnings.showwarning = old
        torch.cuda.synchronize()
        prof.stop()
    rows = sorted(([w, s, n / frames] for (w, s), n in found.items()),
                  key=lambda r: -r[2])
    return dict(a_frame=sum(r[2] for r in rows),
                unwrapped=[r for r in rows if not r[1].startswith("sync:")],
                rows=rows)


def self_ms(session, frames: int) -> dict:
    """Each span name's host self time a frame (ms), and its count."""
    child = [0] * len(session.spans)
    for s in session.spans:
        if s.parent is not None:
            child[s.parent] += s.end_ns - s.start_ns
    out = {}
    for s, c in zip(session.spans, child):
        ms, n = out.get(s.name, (0.0, 0))
        out[s.name] = (ms + (s.end_ns - s.start_ns - c) * 1e-6, n + 1)
    return {k: [ms / frames, n / frames] for k, (ms, n) in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def stretch(drv, spec) -> dict:
    from torch.autograd import DeviceType

    from h100bench import trace as tracing
    from slam_maskrcnn_tpu_torch.utils import profiling

    n = spec["trace_calls"]
    t0 = time.perf_counter()
    frames = calls(drv, n)
    untraced = frames / (time.perf_counter() - t0)

    prof = tracing.start(True)
    t0 = time.perf_counter()
    frames = calls(drv, n)
    t_trace = time.perf_counter() - t0
    prof.stop()
    ses = profiling.last_session()
    roots = [s for s in ses.spans if s.parent is None]
    seen, launched = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in SYNC_CALLS:
            seen[e.name] = seen.get(e.name, 0) + 1
        elif e.name in LAUNCH_CALLS:
            launched[e.name] = launched.get(e.name, 0) + 1
    syncs = {k: v for k, v in ses.counters.items() if k.startswith("sync.")}
    idle = {}
    for name, secs, _ in profiling.idle_gaps(prof, ses, sys.maxsize):
        idle[name] = idle.get(name, 0.0) + secs * 1e3 / frames
    del prof
    return dict(
        calls=n, frames=frames, untraced_fps=untraced,
        traced_fps=frames / t_trace,
        spans_a_frame=len(ses.spans) / frames,
        root_names=sorted({s.name for s in roots}),
        root_cover=sum(s.end_ns - s.start_ns for s in roots) * 1e-9
        / t_trace,
        calls_ids=len({s.call for s in ses.spans}),
        self_ms=self_ms(ses, frames),
        profiler_syncs=seen, program_syncs=sum(syncs.values()),
        launches_a_frame={k: v / frames for k, v in sorted(launched.items())},
        harness_syncs=n,
        sync_sites={k: v / frames for k, v in sorted(syncs.items())},
        idle_ms=dict(sorted(idle.items(), key=lambda kv: -kv[1])))


def gaps(drv, spec, cell: str) -> list:
    from slam_maskrcnn_tpu_torch.utils import profiling

    log_dir = tempfile.mkdtemp(prefix="spans-trace-")
    with profiling.trace(log_dir):
        calls(drv, spec["trace_calls"])
    with open(os.path.join(log_dir, "idle_gaps.txt")) as f:
        table = f.read()
    print(f"-- {cell}: idle gaps (CPU+CUDA trace)\n{table}", flush=True)
    return table.splitlines()


def null_span_ns() -> float:
    from slam_maskrcnn_tpu_torch.utils.profiling import span

    def use():
        with span("x"):
            pass

    def bare():
        pass

    n = 1_000_000
    return (timeit.timeit(use, number=n) - timeit.timeit(bare, number=n)) \
        / n * 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--gaps", nargs="*", default=["ns512.step",
                                                  "ref256.stage2"])
    args = ap.parse_args(argv)
    import torch
    import torch.autograd.profiler as ap_

    os.makedirs(OUT, exist_ok=True)
    info = dict(torch=torch.__version__, card=torch.cuda.get_device_name(0),
                null_span_ns=null_span_ns(),
                start_hook_chained=getattr(ap_._run_on_profiler_start,
                                           "_port_spans", False))
    print(json.dumps(info), flush=True)
    results = {}
    for cell in args.cells:
        drv, spec = build(cell)
        r = dict(sites=sites(drv))
        r.update(stretch(drv, spec))
        if cell in args.gaps:
            r["gaps"] = gaps(drv, spec, cell)
        results[cell] = r
        drv.release()
        del drv
        torch.cuda.empty_cache()
        print(f"== {cell}", flush=True)
        for k, v in r.items():
            if k not in ("gaps", "self_ms", "sites"):
                print(f"  {k}: {v}", flush=True)
        print(f"  syncs seen a frame {r['sites']['a_frame']}; unwrapped:",
              flush=True)
        for row in r["sites"]["unwrapped"]:
            print(f"    {row}", flush=True)
        print("  host self ms a frame, spans a frame:", flush=True)
        for k, (ms, n) in r["self_ms"].items():
            print(f"    {k:24s} {ms:9.4f} {n:7.2f}", flush=True)
    with open(os.path.join(OUT, "spans_card.json"), "w") as f:
        json.dump(dict(info=info, results=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
