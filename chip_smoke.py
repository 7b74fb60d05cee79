#!/usr/bin/env python3
"""Drive the PyTorch port (slam_maskrcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from csrc/ (nvcc, sm_90a) and prints the build
   time.
2. Main path: the north-star step (NorthStar.step: detect -> label ->
   depth probe -> associate -> fuse) at full width: ResNet-101 FPN Mask
   R-CNN with 81 classes and seeded random weights, rect molding to
   768x1024, a 512^3 volume with a K=32 u16 histogram, 480x640 RGB-D
   frames. Prints per-stage milliseconds (CUDA events), frames per second,
   peak memory, and each kernel's launches, which must be 2 (NMS), 2
   (ROIAlign) and 1 (fuse) per frame.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (inputs captured from the main path, plus seeded
   inputs where the main path's are degenerate) and times both.
4. Stage 2 with the synthetic ground-truth masks at 512^3 (association
   with several ids), and the same at 64^3 on the CPU (plain versions) vs
   the GPU (kernels), which must agree bit for bit.

Prints the card's name and power limit, one {"kernels": [...]} line, and
as the last line {"ok": true, "device": {...}}. Any failed check raises,
so the exit code is not 0. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np

H, W = 480, 640
VOL = (512, 512, 512)
N_FRAMES = 8
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float):
    t_b = n_bytes / H100_BYTES_PER_S * 1e3
    t_f = n_flops / H100_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


class Recorder:
    """Keeps a copy of the first inputs each kernel wrapper sees per
    shape key on the main path (for the kernel-vs-plain phase)."""

    def __init__(self):
        import slam_maskrcnn_tpu_torch.ops.nms as nms_mod
        import slam_maskrcnn_tpu_torch.ops.roi_align as roi_mod
        self.seen = {}
        orig_nms, orig_roi = nms_mod._nms_cuda, roi_mod._roi_align_cuda

        def nms(boxes, scores, max_output, thr, sthr):
            key = ("nms", max_output)
            if key not in self.seen:
                self.seen[key] = (boxes.clone(), scores.clone(), max_output,
                                  thr, sthr)
            return orig_nms(boxes, scores, max_output, thr, sthr)

        def roi(features, boxes, pool, image_shape):
            key = ("roi_align", pool)
            if key not in self.seen:
                self.seen[key] = (tuple(f.contiguous().clone()
                                        for f in features),
                                  boxes.clone(), pool, image_shape)
            return orig_roi(features, boxes, pool, image_shape)

        nms_mod._nms_cuda, roi_mod._roi_align_cuda = nms, roi


def main_path(dev):
    """Phase 2: the full-width north-star step. Returns (state, frames,
    stage ms, fps, peak GiB, launches, config objects)."""
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                        make_sequence)
    from slam_maskrcnn_tpu_torch.fusion.fuse import init_from_first_frame
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)
    from slam_maskrcnn_tpu_torch.models.config import Config
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.samples.north_star import NorthStar

    class NSConfig(Config):          # bench.py NSConfig
        NAME = "north_star"
        BACKBONE = "resnet101"
        NUM_CLASSES = 81
        IMAGES_PER_GPU = 1
        GPU_COUNT = 1
        DETECTION_MAX_INSTANCES = 32
        IMAGE_RESIZE_MODE = "rect"
        IMAGE_RECT_SHAPE = (768, 1024)

    K4 = make_intrinsic(520.9, 521.0, 325.1, 249.7)
    cfg = FusionConfig(vol_dim=VOL, probe_mode="depth", probe_stride=2)
    t0 = time.time()
    model = MaskRCNN("inference", NSConfig(), device=dev)
    model.init_params(0)
    frames = make_sequence(default_scene(), K4, H, W, n_frames=4)
    state = init_from_first_frame(cfg, frames[0]["depth"], K4,
                                  frames[0]["mean_depth"], device=dev)
    E0i = np.linalg.inv(frames[0]["extrinsic"]).astype(np.float32)
    staged = [(torch.from_numpy(fr["depth"]).to(dev),
               torch.from_numpy(fr["color"]).to(dev),
               (fr["extrinsic"] @ E0i).astype(np.float32))
              for fr in frames[1:]]
    ns = NorthStar(model, K4, cfg, H, W)
    log(f"[main] setup {time.time() - t0:.1f} s (model "
        f"{sum(p.numel() for p in model.module.parameters()) / 1e6:.1f} M "
        f"params, volume {VOL})")

    rec = Recorder()
    # warm-up frame (first fuse: no association), outside the counted run
    state, mask_g, _ = ns.step(state, *staged[0])
    torch.cuda.synchronize()

    stages = ("detect", "label", "associate", "fuse")
    ms = {s: 0.0 for s in stages}
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.reset()
    t0 = time.time()
    misses = 0
    for i in range(N_FRAMES):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        state, mask_g, miss = ns.step(state, *staged[(i + 1) % 3], mark=mark)
        misses += miss
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            ms[name] += a.elapsed_time(b) / N_FRAMES
    wall = time.time() - t0
    launches = dict(kernels.launches.counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fps = N_FRAMES / wall

    log("[main] per-stage ms: " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in ms.items()))
    log(f"[main] {N_FRAMES} frames in {wall:.3f} s = {fps:.2f} fps, peak "
        f"memory {peak:.2f} GiB, launches {launches}, misses {misses}")
    check(launches == {"nms": 2 * N_FRAMES, "roi_align": 2 * N_FRAMES,
                       "fuse": N_FRAMES}, f"launch counts {launches}")
    check(mask_g.shape == (H, W) and mask_g.dtype == torch.uint8, "mask_g")
    check(state.n_obs == N_FRAMES + 1 and misses == 0, "n_obs / misses")
    check(bool(torch.isfinite(state.diff).all()), "finite diff")
    fused = int((state.weight > 0).sum())
    check(fused > 1_000_000, f"fused voxels {fused}")
    log(f"[main] fused voxels {fused}, num_objs {int(state.num_objs)}")
    profile_steps(ns, state, staged)
    return state, frames, staged, ms, fps, peak, launches, rec, cfg, K4


def profile_steps(ns, state, staged, n_steps: int = 2):
    """torch.profiler over a few more steps (after the counted run): the
    device's busy share of the wall time, and the top ops by device and by
    host self time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(n_steps):
            ns.step(state, *staged[i % 3])
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    rows = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device rows are the kernels and copies themselves (an op's row
    # repeats its kernels' time)
    on_dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in on_dev)
    n_launch = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
    log(f"[profile] {n_steps} steps: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
        f"{n_launch / n_steps:.0f} cudaLaunchKernel per step")
    for key, title, pool in ((dev_us, "device", on_dev),
                             (lambda e: e.self_cpu_time_total, "host", rows)):
        top = sorted(pool, key=key, reverse=True)[:12]
        log(f"[profile] top by {title} self time (ms over {n_steps} steps, "
            f"calls):")
        for e in top:
            log(f"[profile]   {key(e) / 1e3:9.3f}  {e.count:6d}  {e.key[:90]}")


def kernel_phase(dev, state, staged, rec, cfg, K4):
    """Phase 3: each kernel vs its plain version at the main path's shapes,
    and their times. Returns the kernels JSON rows (without launches)."""
    import torch
    from slam_maskrcnn_tpu_torch.fusion import fuse as fz
    from slam_maskrcnn_tpu_torch.ops import nms as nm
    from slam_maskrcnn_tpu_torch.ops import roi_align as ra

    rows = {}

    # ---- K2 NMS: proposals (6000 -> 1000, IoU 0.7) and detections
    # (1000 class-offset boxes -> 32, IoU 0.3); the main path's own inputs
    # and seeded ones with exact ties
    g = torch.Generator(device="cpu").manual_seed(0)
    yx = torch.rand(6000, 2, generator=g) * 0.9
    hw = torch.rand(6000, 2, generator=g) * 0.3 + 0.01
    sb = torch.cat([yx, yx + hw], 1)
    ss = torch.rand(6000, generator=g)
    ss[::7] = 0.5                                         # exact ties
    cls = torch.randint(1, 81, (1000,), generator=g).float()[:, None] * 2.0
    cases = [("main path proposals", rec.seen[("nms", 1000)]),
             ("main path detections", rec.seen[("nms", 32)]),
             ("seeded 6000 -> 1000",
              (sb[None].to(dev), ss[None].to(dev), 1000, 0.7,
               float("-inf"))),
             ("seeded class-offset 1000 -> 32",
              ((sb[:1000] + cls)[None].to(dev), ss[None, :1000].to(dev),
               32, 0.3, -5e8))]
    err = 0
    for name, (b, s, cap, thr, sthr) in cases:
        ki, kv = nm._nms_cuda(b, s, cap, thr, sthr)
        pi, pv = nm.non_max_suppression_plain(b[0], s[0], cap, thr, sthr)
        torch.cuda.synchronize()
        check(torch.equal(kv[0], pv) and torch.equal(ki[0], pi),
              f"nms {name}: kernel != plain")
        err = max(err, int((ki[0] - pi).abs().max()))
        log(f"[nms] {name}: n={s.shape[1]} cap={cap} selected "
            f"{int(kv.sum())} -- indices equal")
    b, s, cap, thr, sthr = rec.seen[("nms", 1000)]
    n = s.shape[1]
    t_k = cuda_time_ms(lambda: nm._nms_cuda(b, s, cap, thr, sthr), 20)
    t_p = cuda_time_ms(
        lambda: nm.non_max_suppression_plain(b[0], s[0], cap, thr, sthr), 2)
    sel = int(nm._nms_cuda(b, s, cap, thr, sthr)[1].sum())
    # bytes: boxes + scores in, (index, valid) out; operations: one IoU
    # (~12 flops) per box per selection this input made
    bms, by = bound_ms(n * 20 + cap * 5, (sel + 1) * n * 12)
    rows["nms"] = dict(name="nms", route="cuda",
                       source="slam_maskrcnn_tpu_torch/csrc/nms.cu",
                       replaces="slam_maskrcnn_tpu/ops/pallas/nms_kernel.py:35",
                       max_abs_err=float(err), ms=t_k, plain_ms=t_p,
                       bound_ms=bms, bound_by=by, library_ms=None)
    log(f"[nms] proposals: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
        f"{bms:.5f} ms ({by}), {sel} selections")

    # ---- K3 PyramidROIAlign: 1000 boxes at pool 7 and 32 at pool 14 on
    # the main path's bf16 pyramid; also fed f32 features
    err = 0.0
    for pool in (7, 14):
        feats, boxes, p, shape = rec.seen[("roi_align", pool)]
        for f in (feats, tuple(x.float() for x in feats)):
            k = ra._roi_align_cuda(f, boxes, p, shape)
            pl = ra.pyramid_roi_align_plain(f, boxes, p, shape)
            torch.cuda.synchronize()
            e = float((k - pl).abs().max())
            check(e <= 1e-4, f"roi_align pool {pool} {f[0].dtype}: err {e}")
            err = max(err, e)
            log(f"[roi_align] pool {pool} {f[0].dtype} n={boxes.shape[0]}: "
                f"max |kernel - plain| {e:.3e}")
    feats, boxes, p, shape = rec.seen[("roi_align", 7)]
    t_k = cuda_time_ms(lambda: ra._roi_align_cuda(feats, boxes, p, shape), 20)
    t_p = cuda_time_ms(
        lambda: ra.pyramid_roi_align_plain(feats, boxes, p, shape), 3)
    C = feats[0].shape[-1]
    n_out = boxes.shape[0] * p * p * C
    in_bytes = sum(f.numel() * f.element_size() for f in feats)
    # bytes: every level read once + boxes + f32 output; operations: 4
    # corner reads blended with ~11 flops per output element
    bms, by = bound_ms(in_bytes + boxes.numel() * 4 + n_out * 4, n_out * 11)
    rows["roi_align"] = dict(
        name="roi_align", route="cuda",
        source="slam_maskrcnn_tpu_torch/csrc/roi_align.cu",
        replaces="slam_maskrcnn_tpu/ops/pallas/roi_align_kernel.py:61",
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=by,
        library_ms=None)
    log(f"[roi_align] pool 7 x {boxes.shape[0]}: kernel {t_k:.3f} ms, plain "
        f"{t_p:.3f} ms, bound {bms:.5f} ms ({by})")

    # ---- K1 fuse at 512^3 on the main path's state, next frame + a mask
    depth, color, e2i = staged[0]
    mask = (depth.to(torch.int32) > 0).to(torch.uint8) * 3
    params = fz.fuse_params(state, e2i, K4, cfg)
    w0 = state.weight.clone()
    h0 = state.hist.sum(dtype=torch.int64)
    other = fz.TSDFVolume(**{k: (v.clone() if torch.is_tensor(v) else v)
                             for k, v in vars(state).items()})
    fz._fuse_cuda(state, depth, color, mask, params)
    fz.fuse_frame_plain(other, depth, color, mask, params)
    torch.cuda.synchronize()
    for f in ("weight", "color", "hist"):
        check(torch.equal(getattr(state, f), getattr(other, f)),
              f"fuse {f}: kernel != plain")
    err = float((state.diff - other.diff).abs().max())
    check(err <= 2e-6, f"fuse diff err {err}")
    n_valid = int((state.weight - w0).sum())
    n_gated = int(state.hist.sum(dtype=torch.int64) - h0)
    check(n_valid > 1_000_000 and n_gated > 0, "fuse fixture fuses")
    log(f"[fuse] 512^3: weight/color/hist equal, max |diff| {err:.3e}, "
        f"{n_valid} valid and {n_gated} gated voxels")
    del w0
    t_k = cuda_time_ms(lambda: fz._fuse_cuda(state, depth, color, mask,
                                             params), 10)
    t_p = cuda_time_ms(lambda: fz.fuse_frame_plain(other, depth, color, mask,
                                                   params), 2)
    del other
    torch.cuda.empty_cache()
    # bytes this frame needs: the frame (depth 2 + color 3 + mask 1 B per
    # pixel) once, diff and weight read+written for valid voxels, color (3)
    # and one histogram bin (2) read+written for gated ones; operations:
    # the projection (~20 flops) of every voxel
    nvox = VOL[0] * VOL[1] * VOL[2]
    bms, by = bound_ms(H * W * 6 + n_valid * 16 + n_gated * 10, nvox * 20)
    rows["fuse"] = dict(name="fuse", route="cuda",
                        source="slam_maskrcnn_tpu_torch/csrc/fuse.cu",
                        replaces="slam_maskrcnn_tpu/ops/pallas/"
                                 "fuse_kernel.py:550",
                        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bms,
                        bound_by=by, library_ms=None)
    log(f"[fuse] kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
        f"{bms:.5f} ms ({by})")
    return rows


def stage2_phase(dev):
    """Phase 4: SemanticFusion on ground-truth masks, 512^3 on the GPU, and
    64^3 CPU (plain) vs GPU (kernels), which must agree bit for bit."""
    import torch
    from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                        make_sequence)
    from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)

    K4 = make_intrinsic(520.9, 521.0, 325.1, 249.7)
    frames = make_sequence(default_scene(), K4, H, W, n_frames=6)
    sf = SemanticFusion(K4, FusionConfig(vol_dim=VOL, probe_stride=2),
                        device=dev)
    t0 = time.time()
    for fr in frames:
        mg = sf.parse_frame(fr["depth"], fr["color"], fr["mask"],
                            fr["extrinsic"], fr["mean_depth"])
    torch.cuda.synchronize()
    ids = sorted(np.unique(mg.cpu().numpy()).tolist())
    log(f"[stage2] 512^3, {len(frames)} frames in {time.time() - t0:.2f} s: "
        f"ids {ids}, num_objs {int(sf.state.num_objs)}")
    check(ids == [0, 1, 2] and int(sf.state.num_objs) == 3,
          "stage-2 association keeps the two sphere ids")
    del sf
    torch.cuda.empty_cache()

    Ks = make_intrinsic(100.0, 100.0, 64.0, 48.0)
    small = make_sequence(default_scene(), Ks, 96, 128, n_frames=5)
    outs = []
    for d in ("cpu", dev):
        sf = SemanticFusion(Ks, FusionConfig(vol_dim=(64,) * 3,
                                             probe_stride=2), device=d)
        masks = [sf.parse_frame(fr["depth"], fr["color"], fr["mask"],
                                fr["extrinsic"], fr["mean_depth"])
                 for fr in small]
        outs.append((sf.dense_state(), [m.cpu() for m in masks[1:]]))
    (a, ma), (b, mb) = outs
    for f in ("diff", "color", "weight", "hist"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"64^3 CPU vs GPU {f}")
    check(all(torch.equal(x, y) for x, y in zip(ma, mb)), "64^3 masks")
    check(a.num_objs == b.num_objs == 3, "64^3 num_objs")
    log("[stage2] 64^3: CPU plain == GPU kernels (diff, color, weight, "
        "hist, masks)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from slam_maskrcnn_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    t0 = time.time()
    kernels.build_all(verbose=True)
    for name in kernels.SOURCES:
        kernels.lib(name)
    log(f"[build] {len(kernels.SOURCES)} kernels in {time.time() - t0:.1f} s")

    (state, frames, staged, ms, fps, peak, launches, rec, cfg,
     K4) = main_path(dev)
    rows = kernel_phase(dev, state, staged, rec, cfg, K4)
    del state
    torch.cuda.empty_cache()
    stage2_phase(dev)

    for k in rows:
        rows[k]["launches"] = launches[k]
    log(json.dumps({"north_star": {"stage_ms": ms, "fps": fps,
                                   "peak_gib": peak, "frames": N_FRAMES,
                                   "card": smi}}))
    log(json.dumps({"kernels": [rows[k] for k in ("fuse", "nms",
                                                  "roi_align")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
