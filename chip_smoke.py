#!/usr/bin/env python3
"""Drive the PyTorch port (slam_maskrcnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from csrc/ (nvcc, sm_90a, one process per
   source) and prints the build time and every kernel's registers,
   spills and shared memory from the -Xptxas=-v log.
2. Main path, per-frame form: the north-star step (NorthStar.step: detect
   -> label -> depth probe -> associate -> fuse, render mode "none") at
   full width: ResNet-101 FPN Mask R-CNN with 81 classes and seeded random
   weights, rect molding to 768x1024, a 512^3 volume with a K=32 u16
   histogram, 480x640 RGB-D frames. Prints per-stage milliseconds (CUDA
   events), frames per second, peak memory, and each kernel's launches,
   which must be 2 (NMS), 2 (ROIAlign) and 1 (fuse) per frame.
3. Main path, chunk form: NorthStar.run_chunk_paired over 16 frames with
   the in-loop render (mode "instance", candidates refreshed every 4
   frames) on the same model and volume: one batched detect (2 NMS and 2
   ROIAlign launches for the 16 frames), 8 launches of the paired fuse
   kernel, 16 renders. Prints the same metrics with the
   candidate refresh and the render as stages, checks the launch counts,
   the state, the misses and a color-mode view of the final volume, and
   holds run_chunk_paired against run_chunk_batched at 64^3.
4. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (inputs captured from the main path, plus seeded
   inputs where the main path's are degenerate) and times both; the NMS
   and ROIAlign kernels at the per-frame form's batch of 1 and at the
   chunk's batch of 16, every image of a batch compared (ROIAlign at pool 7
   and 14, on bf16 features and their f32 upcast); the paired fuse kernel
   also against two launches of the single one, the sorted NMS kernel also
   against the argmax kernel's selection. Both NMS kernels also run the
   seeded edge cases of ``nms_edge_cases`` (sizes 1 to 8192, ties, IoUs on
   the threshold, a batch). ROIAlign and the sorted NMS kernel are timed
   on the device with their launches queued behind a spin kernel
   (``device_ms``), since their wrappers' host time may exceed the
   kernel's; their rows also carry the time through the wrapper. The
   fuse kernels' brick classes (skip / free / full) are held against
   ``brick_classes_plain`` and their shares printed; at 128^3 both fuse
   kernels also run seeded poses the main path does not reach (camera
   inside the volume, looking away, grazing, depth with holes).
5. Stage 2 with the synthetic ground-truth masks at 512^3 (association
   with several ids, then an instance render that must show both
   spheres), and the same at 64^3 on the CPU (plain versions) vs the GPU
   (kernels): state, masks, renders and probe must agree bit for bit.
6. The trained detector and the two-stage pipeline (``pipeline_phase``),
   training (``train_phase``) and the samples (``samples_phase``: nucleus
   training with the Augmenter and its detect to submit.csv, mini-COCO,
   balloon training and splash, the tracker's template match; the NMS and
   ROIAlign kernels held at those paths' shapes), each described in its
   function.
7. The multi-rank paths (``sharded_phase``): two gloo ranks on the one
   card, spawned by parallel/sharding.py ``launch``: the fuse kernel on an
   x-slab at a nonzero offset against its plain version, the
   volume-sharded fuse at 512^3 bit-equal to one rank (and the fuse
   kernel launched on every rank's slab), its render within 1% of one
   rank's, the dense ("xla") step sharded at 256^3 (u32) sha256-equal to
   one rank's, the data-parallel training step equal to one rank's.
8. sfm/ on the card (``sfm_phase``): PatchMatch held against its CPU run
   and timed at 480 x 640; the two-view SfM (SIFT, matching, RANSAC,
   rectification with the warps, SGBM) on a 480 x 640 synthetic pair
   against its CPU run, with stage times.
9. JPEG and MJPEG-AVI I/O, the captions and the demo (``viz_phase``): a
   seeded JPEG corpus made by the port's encoder, decoded on the card
   bit-equal to the CPU; ``samples/demo.main`` at full COCO width on
   three of them; captions on the trained shapes detector's detections;
   the balloon splash of an MJPEG AVI, each described in the function.

Prints the card's name and power limit, one {"kernels": [...]} line (a
row's "launches" is the total of "launches_by_path", the counts of the two
forms of the main path, each counted from 0; the NMS and ROIAlign rows'
times are at the chunk's batch, with the batch-1 times beside them; the
ROIAlign row's main times are the pool-7 head's, the pool-14 head's under
"pool14"), and
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
N_FRAMES = 8                    # per-frame form
N_CHUNK = 16                    # chunk form
PIPE_VOL = 256                  # the drivers' default volume
PIPE_FRAMES = 8                 # the synthetic TUM sequence
PIPE_K = (520.9, 521.0, 325.1, 249.7)   # fx, fy, cx, cy (kernel.cpp:39)
XLA_VOL = 256                   # the dense backend's timed volume
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


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds a call of ``fn``: the calls are queued behind a
    spin kernel, so they run back to back whatever the host's time per
    call (a wrapper's ~0.1 ms hides a kernel faster than that from
    ``cuda_time_ms``). Raises if the host took longer to queue them than
    the spin lasted."""
    import torch
    fn()
    start, end, spin0 = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    torch.cuda.synchronize()
    spin0.record()
    torch.cuda._sleep(50_000_000)        # ~25-30 ms at the H100's clocks
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(spin0.elapsed_time(start) > host_ms,
          f"device_ms: queueing took {host_ms:.3f} ms, longer than the spin")
    return start.elapsed_time(end) / reps


def ptxas_lines(log: str):
    """(kernel, registers, spill bytes, stack bytes, shared bytes) of every
    entry function in an nvcc -Xptxas=-v log."""
    import re
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        stack = re.search(r"(\d+) bytes stack frame", part)
        smem = re.search(r"(\d+) bytes smem", part)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else -1,
                    int(stack.group(1)) if stack else -1,
                    int(smem.group(1)) if smem else 0))
    return out


def bound_ms(n_bytes: float, n_flops: float):
    t_b = n_bytes / H100_BYTES_PER_S * 1e3
    t_f = n_flops / H100_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def match_detections(rois_a, cls_a, sc_a, rois_b, cls_b, sc_b,
                     iou_thr=0.9):
    """Greedy same-class box matching of detection set a against b (as
    tools/parity_gate.py holds the TPU's detections to the CPU's): each of
    a's boxes takes the unused b box of its class with the highest IoU
    above ``iou_thr``. Returns (matched, mean |score a - score b|)."""
    used, mads = set(), []
    for i in range(len(rois_a)):
        best, best_iou = -1, iou_thr
        for j in range(len(rois_b)):
            if j in used or cls_a[i] != cls_b[j]:
                continue
            ya1, xa1, ya2, xa2 = (float(v) for v in rois_a[i])
            yb1, xb1, yb2, xb2 = (float(v) for v in rois_b[j])
            inter = (max(0.0, min(ya2, yb2) - max(ya1, yb1))
                     * max(0.0, min(xa2, xb2) - max(xa1, xb1)))
            union = ((ya2 - ya1) * (xa2 - xa1) + (yb2 - yb1) * (xb2 - xb1)
                     - inter)
            iou = inter / union if union > 0 else 0.0
            if iou > best_iou:
                best, best_iou = j, iou
        if best >= 0:
            used.add(best)
            mads.append(abs(float(sc_a[i]) - float(sc_b[best])))
    return len(mads), float(np.mean(mads)) if mads else 0.0


def nms_edge_cases():
    """Seeded edge cases of greedy NMS, numpy only: a list of (name, boxes
    f32 [B, n, 4], scores f32 [B, n], max_output, iou_threshold,
    score_threshold). The argmax kernel is held to its plain version on
    them on the card, and the plain version to the JAX package on the CPU
    (tests/test_torch_ops.py)."""
    rng = np.random.default_rng(20)
    ninf = float("-inf")

    def rand(n, batch=1):
        yx = rng.uniform(0.0, 0.9, (batch, n, 2))
        hw = rng.uniform(0.01, 0.3, (batch, n, 2))
        return (np.concatenate([yx, yx + hw], -1).astype(np.float32),
                rng.uniform(0, 1, (batch, n)).astype(np.float32))

    cases = []
    for n, cap in ((1, 4), (31, 8), (33, 8), (1025, 12), (6000, 12),
                   (8192, 12)):
        cases.append((f"n={n}", *rand(n), cap, 0.5, ninf))
    cases.append(("max_output above n", *rand(20), 32, 0.7, ninf))
    b, s = rand(50)
    cases.append(("all scores under the threshold", b, s, 8, 0.5, 2.0))
    b, s = rand(40)
    cases.append(("all boxes the same", np.broadcast_to(
        b[:, :1], b.shape).copy(), s, 8, 0.5, ninf))
    b, s = rand(200)
    cases.append(("exact score ties", b, np.full_like(s, 0.5), 16, 0.3,
                  ninf))
    b, s = rand(1500)
    s[0, rng.choice(1500, 700, replace=False)] = 0.25
    s[0, 1024:1040] = s[0, :16]          # ties across a thread's two boxes
    cases.append(("tied blocks, 1500 boxes", b, s, 24, 0.6, ninf))
    # pairs (A, B) apart from one another, A scored above B, with
    # inter / union placed on the threshold and a few ulp to either side:
    # A = [y, 0, y + 1, 1] and B = [y, 0, y + 1, x] overlap by exactly x of
    # a union (1 + x) - x
    for t in (0.5, 0.25, 0.7, 0.3):
        t32 = np.float32(t)
        xs = [t32]
        for _ in range(4):
            xs = [np.nextafter(xs[0], np.float32(0))] + xs \
                + [np.nextafter(xs[-1], np.float32(1))]
        boxes, scores = [], []
        for k, x in enumerate(xs):
            off = np.float32(2.0 * k)
            boxes += [[off, 0, off + 1, 1], [off, 0, off + 1, x]]
            scores += [1.0 - 0.01 * k, 0.5 - 0.01 * k]
        # thin boxes at other scales, where the union is not 1
        for k, (h, w) in enumerate(((3.0, 0.125), (0.3, 7.0), (1e-3, 1e-3))):
            off = np.float32(100.0 + 10.0 * k)
            boxes += [[off, 0, off + h, w], [off, 0, off + h,
                                             w * float(t32)]]
            scores += [0.4 - 0.01 * k, 0.2 - 0.01 * k]
        cases.append((f"IoUs on the threshold {t}",
                      np.asarray(boxes, np.float32)[None],
                      np.asarray(scores, np.float32)[None], len(boxes),
                      float(t), ninf))
    cases.append(("batch of 4", *rand(300, batch=4), 20, 0.4, 0.1))
    return cases


def seeded_poses(vol_start, vol_end, e_default):
    """Camera poses (extrinsic2init, float32 [4, 4]) that the main path does
    not reach: inside the volume, looking away from it, and grazing it so
    that the frustum's faces cut through bricks at an angle."""
    centre = 0.5 * (np.asarray(vol_start, np.float64)
                    + np.asarray(vol_end, np.float64))

    def rot_y(deg):
        a = np.deg2rad(deg)
        R = np.eye(4)
        R[0, 0], R[0, 2], R[2, 0], R[2, 2] = (np.cos(a), np.sin(a),
                                              -np.sin(a), np.cos(a))
        return R

    inside = np.eye(4)
    inside[:3, 3] = -centre
    to_c, back = np.eye(4), np.eye(4)
    to_c[:3, 3] = -centre
    back[:3, 3] = centre + np.array([0.1, 0.0, -0.2])
    poses = {"inside": inside,
             "away": rot_y(180.0) @ np.asarray(e_default, np.float64),
             "grazing": back @ rot_y(55.0) @ to_c}
    return {k: v.astype(np.float32) for k, v in poses.items()}


class Recorder:
    """Keeps a copy of the first inputs each kernel wrapper sees per
    shape key on the main path (for the kernel-vs-plain phase). The NMS
    and ROIAlign keys hold the batch size: the per-frame form launches
    them at batch 1, the chunk form at the chunk's batch. The ROIAlign
    pyramids wait in host memory (``roi_inputs`` brings them back), so
    that the chunk's (0.5 GB a head) do not count in the main path's peak
    device memory."""

    def __init__(self):
        import slam_maskrcnn_tpu_torch.ops.nms as nms_mod
        import slam_maskrcnn_tpu_torch.ops.roi_align as roi_mod
        self.seen = {}
        orig_nms, orig_roi = nms_mod._nms_cuda, roi_mod._roi_align_cuda

        def nms(boxes, scores, max_output, thr, sthr):
            key = ("nms", max_output, scores.shape[0])
            if key not in self.seen:
                self.seen[key] = (boxes.clone(), scores.clone(), max_output,
                                  thr, sthr)
            return orig_nms(boxes, scores, max_output, thr, sthr)

        def roi(features, boxes, pool, image_shape):
            key = ("roi_align", pool, boxes.shape[0])
            if key not in self.seen:
                self.seen[key] = (tuple(f.to("cpu") for f in features),
                                  boxes.clone(), pool, image_shape)
            return orig_roi(features, boxes, pool, image_shape)

        nms_mod._nms_cuda, roi_mod._roi_align_cuda = nms, roi

    def roi_inputs(self, pool, batch):
        """(features, boxes, pool, image_shape) of the first ROIAlign launch
        at this pool size and batch, the features back on the boxes'
        device."""
        feats, boxes, p, shape = self.seen[("roi_align", pool, batch)]
        return tuple(f.to(boxes.device) for f in feats), boxes, p, shape


class StageClock:
    """CUDA events at the stage marks of a step or a chunk; ``ms()`` sums
    the time between consecutive marks under the later mark's name."""

    def __init__(self):
        import torch
        self._event = lambda: torch.cuda.Event(enable_timing=True)
        self.events = [("start", self._event())]
        self.events[0][1].record()

    def mark(self, name):
        ev = self._event()
        ev.record()
        self.events.append((name, ev))

    def ms(self):
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


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
    ns = NorthStar(model, K4, cfg, H, W, render_mode="none")
    dist = float(frames[0]["mean_depth"])
    log(f"[main] setup {time.time() - t0:.1f} s (model "
        f"{sum(p.numel() for p in model.module.parameters()) / 1e6:.1f} M "
        f"params, volume {VOL})")

    rec = Recorder()
    # warm-up frame (first fuse: no association), outside the counted run
    state, _, mask_g, _ = ns.step(state, *staged[0], 0.0, dist)
    torch.cuda.synchronize()

    stages = ("detect", "label", "associate", "fuse")
    ms = {s: 0.0 for s in stages}
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.reset()
    t0 = time.time()
    misses = 0
    for i in range(N_FRAMES):
        clock = StageClock()
        state, _, mask_g, miss = ns.step(state, *staged[(i + 1) % 3],
                                         0.01 * i, dist, mark=clock.mark)
        torch.cuda.synchronize()
        misses += int(miss)
        for name, t in clock.ms().items():
            ms[name] += t / N_FRAMES
    wall = time.time() - t0
    launches = dict(kernels.launches.counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fps = N_FRAMES / wall

    log("[main] per-stage ms: " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in ms.items()))
    log(f"[main] {N_FRAMES} frames in {wall:.3f} s = {fps:.2f} fps, peak "
        f"memory {peak:.2f} GiB, launches {launches}, misses {misses}")
    check(launches == {"nms": 2 * N_FRAMES, "roi_align": 2 * N_FRAMES,
                       "fuse": N_FRAMES, "fuse_pair": 0, "nms_sorted": 0},
          f"launch counts {launches}")
    check(mask_g.shape == (H, W) and mask_g.dtype == torch.uint8, "mask_g")
    check(state.n_obs == N_FRAMES + 1 and misses == 0, "n_obs / misses")
    check(bool(torch.isfinite(state.diff).all()), "finite diff")
    fused = int((state.weight > 0).sum())
    check(fused > 1_000_000, f"fused voxels {fused}")
    log(f"[main] fused voxels {fused}, num_objs {int(state.num_objs)}")
    profile_run(lambda: [ns.step(state, *staged[i % 3], 0.0, dist)
                         for i in range(2)], 2, "step")
    return (state, frames, staged, ms, fps, peak, launches, rec, cfg, K4,
            model, dist)


def chunk_path(dev, model, state, staged, K4, dist):
    """Phase 3: the paired chunk with the in-loop render at full width, on
    the per-frame phase's model and (warmed) volume. Returns (state, stage
    ms per frame, fps, peak GiB, launches, cfg)."""
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.fusion.fuse import init_state
    from slam_maskrcnn_tpu_torch.fusion.splat import OrbitRenderer
    from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
    from slam_maskrcnn_tpu_torch.samples.north_star import NorthStar

    # the bench's north-star configuration (bench.py:235-258)
    cfg = FusionConfig(vol_dim=VOL, splat_max_blocks=8192,
                       splat_max_surface=1024 * 1024, splat_max_rows=49152,
                       splat_row_cap=20, probe_mode="depth", probe_stride=2,
                       shell_refresh_every=4)
    ns = NorthStar(model, K4, cfg, H, W, render_mode="instance")
    depths = torch.stack([staged[i % 3][0] for i in range(N_CHUNK)])
    colors = torch.stack([staged[i % 3][1] for i in range(N_CHUNK)])
    es = np.stack([staged[i % 3][2] for i in range(N_CHUNK)])
    angles = np.arange(N_CHUNK, dtype=np.float32) * np.float32(0.01)

    state, *_ = ns.run_chunk_paired(state, depths, colors, es, angles, dist)
    torch.cuda.synchronize()
    n_obs0 = state.n_obs
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.reset()
    clock = StageClock()
    t0 = time.time()
    state, renders, masks_g, misses = ns.run_chunk_paired(
        state, depths, colors, es, angles, dist, mark=clock.mark)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launches.counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fps = N_CHUNK / wall
    ms = {k: v / N_CHUNK for k, v in clock.ms().items()}
    n_miss = int(misses.sum())
    log("[chunk] per-stage ms per frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    log(f"[chunk] {N_CHUNK} frames in {wall:.3f} s = {fps:.2f} fps, peak "
        f"memory {peak:.2f} GiB, launches {launches}, misses {n_miss}")
    # one batched detect: one NMS launch for the proposals and one for the
    # detections of all frames, one ROIAlign launch per head for all
    # frames; one paired fuse per two frames
    check(launches == {"nms": 2, "roi_align": 2, "fuse": 0,
                       "fuse_pair": N_CHUNK // 2, "nms_sorted": 0},
          f"chunk launch counts {launches}")
    check(state.n_obs == n_obs0 + N_CHUNK and n_miss == 0,
          f"chunk n_obs {state.n_obs} / misses {n_miss}")
    check(renders.shape == (N_CHUNK, H, W, 3) and renders.dtype
          == torch.uint8 and masks_g.shape == (N_CHUNK, H, W)
          and misses.shape == (N_CHUNK // 2,), "chunk output shapes")
    check(bool(torch.isfinite(state.diff).all()), "finite diff after chunk")

    # what the render's budgets dropped or clipped at this state
    from slam_maskrcnn_tpu_torch.fusion.splat import (_compact_shell,
                                                      pinhole_of_orbit,
                                                      select_candidates,
                                                      splat_render_orbit)
    rows = _compact_shell(state, cfg.splat_max_blocks, cfg.splat_max_rows,
                          cfg.splat_shell_band)
    codes, ovf, clip = select_candidates(
        rows, *pinhole_of_orbit(0.0, dist, K4), cfg.splat_row_cap)
    log(f"[chunk] shell rows {int(rows['n_rows'])} of {cfg.splat_max_rows}, "
        f"candidates {int((codes >= 0).sum())} of {codes.numel()}, overflow "
        f"{int(ovf)}, clip {int(clip)}; instance render lights "
        f"{float((renders.amax(-1) > 0).float().mean()):.4f} of the pixels "
        f"(random weights)")
    check(int(ovf) == 0, "shell budgets overflow")
    del rows, codes
    # random weights light little in instance mode: prove the render on
    # the final volume in color mode. The scene fills the view (0.97 of
    # the pixels measured at this state): a render that lost part of its
    # surface to a budget or to the enumeration order falls under 0.9. The
    # cached renderer must equal the uncached render.
    orb = OrbitRenderer(state, K4, H, W, cfg, mode="color")
    view = orb.render(0.05, dist)
    cover = float((view.amax(-1) > 0).float().mean())
    log(f"[chunk] color-mode orbit view covers {cover:.4f} of the pixels")
    check(view.shape == (H, W, 3) and cover > 0.9,
          f"color view coverage {cover}")
    check(torch.equal(view, splat_render_orbit(state, 0.05, dist, K4, H, W,
                                               cfg, mode="color")),
          "OrbitRenderer.render != splat_render_orbit")
    del orb, view
    profile_run(lambda: ns.run_chunk_paired(state, depths, colors, es, angles,
                                            dist), N_CHUNK, "chunk frame")

    # paired against batched on clones of one warmed 64^3 volume: state
    # and masks equal, pair-second renders equal (as the CPU test states)
    small = FusionConfig(vol_dim=(64,) * 3, probe_mode="depth",
                         probe_stride=2, shell_refresh_every=2)
    ns_s = NorthStar(model, K4, small, H, W, render_mode="color")
    v0 = init_state(small, state.vol_start, state.vol_end, device=dev)
    v0, *_ = ns_s.step(v0, *staged[0], 0.0, dist)
    four = (depths[1:5], colors[1:5], es[1:5], angles[1:5], dist)
    vb, rb, mb, _ = ns_s.run_chunk_batched(v0.clone(), *four)
    vp, rp, mp, _ = ns_s.run_chunk_paired(v0.clone(), *four)
    for f in ("diff", "weight", "color", "hist"):
        check(torch.equal(getattr(vb, f), getattr(vp, f)),
              f"64^3 paired vs batched {f}")
    check(torch.equal(mb, mp), "64^3 paired vs batched masks")
    check(torch.equal(rb[1], rp[1]) and torch.equal(rb[3], rp[3])
          and bool(rp[1].any()), "64^3 pair-second renders")
    log("[chunk] 64^3: run_chunk_paired == run_chunk_batched (state, masks, "
        "pair-second renders)")
    return state, ms, fps, peak, launches, cfg


def profile_run(fn, n_frames: int, unit: str):
    """torch.profiler over one more call of ``fn`` (after the counted run),
    which covers ``n_frames`` frames: the device's busy share of the wall
    time, launches per frame, and the top ops by device and by host self
    time. Returns the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_steps = n_frames
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
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
    n_sync = sum(e.count for e in rows if e.key == "cudaStreamSynchronize")
    log(f"[profile] {n_steps} x {unit}: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
        f"{n_launch / n_steps:.0f} cudaLaunchKernel and "
        f"{n_sync / n_steps:.1f} cudaStreamSynchronize per {unit}")
    for key, title, pool in ((dev_us, "device", on_dev),
                             (lambda e: e.self_cpu_time_total, "host", rows)):
        top = sorted(pool, key=key, reverse=True)[:12]
        log(f"[profile] top by {title} self time (ms over {n_steps} x "
            f"{unit}, calls):")
        for e in top:
            log(f"[profile]   {key(e) / 1e3:9.3f}  {e.count:6d}  {e.key[:90]}")
    return busy / wall_us


def roi_read_bytes(feats, boxes, pool, image_shape) -> int:
    """Bytes of the distinct feature cells that PyramidROIAlign reads for
    these rois (the corners of every sample inside its level), over all
    images: what a kernel must read at least once."""
    import torch
    from slam_maskrcnn_tpu_torch.ops import roi_align as ra
    total = 0
    for b in range(boxes.shape[0]):
        lvl = ra.roi_level(boxes[b], image_shape)
        for li, f in enumerate(feats):
            bx = boxes[b][lvl == li + 2]
            H, W = f.shape[1:3]
            corners, inside = [], []
            for lo, hi, size in ((bx[:, 0], bx[:, 2], H),
                                 (bx[:, 1], bx[:, 3], W)):
                s = ra.sample_grid(lo, hi, size, pool)
                i0 = torch.floor(s).clamp(-2, size + 1).long()
                corners.append(torch.stack([i0.clamp(0, size - 1),
                                            (i0 + 1).clamp(0, size - 1)], -1))
                inside.append((s >= 0) & (s <= size - 1))
            (ys, xs), (vy, vx) = corners, inside
            cell = (ys[:, :, None, :, None] * W
                    + xs[:, None, :, None, :])            # [R, P, P, 2, 2]
            ok = (vy[:, :, None] & vx[:, None, :])[..., None, None]
            seen = torch.zeros(H * W, dtype=torch.bool, device=boxes.device)
            seen[cell[ok.expand_as(cell)]] = True
            total += int(seen.sum()) * f.shape[-1] * f.element_size()
    return total


def kernel_phase(dev, state, staged, rec, cfg, K4):
    """Phase 4: each kernel vs its plain version at the main path's shapes,
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
    sb4 = torch.stack([sb.roll(37 * i, 0) for i in range(4)])
    ss4 = torch.stack([ss.roll(11 * i, 0) for i in range(4)])
    cases = [("step proposals", rec.seen[("nms", 1000, 1)]),
             ("step detections", rec.seen[("nms", 32, 1)]),
             ("chunk proposals", rec.seen[("nms", 1000, N_CHUNK)]),
             ("chunk detections", rec.seen[("nms", 32, N_CHUNK)]),
             ("seeded 6000 -> 1000",
              (sb[None].to(dev), ss[None].to(dev), 1000, 0.7,
               float("-inf"))),
             ("seeded batch of 4, 6000 -> 1000",
              (sb4.to(dev), ss4.to(dev), 1000, 0.7, float("-inf"))),
             ("seeded class-offset 1000 -> 32",
              ((sb[:1000] + cls)[None].to(dev), ss[None, :1000].to(dev),
               32, 0.3, -5e8))]
    err = 0
    for name, (b, s, cap, thr, sthr) in cases:
        ki, kv = nm._nms_cuda(b, s, cap, thr, sthr)
        for i in range(s.shape[0]):          # every image of the batch
            pi, pv = nm.non_max_suppression_plain(b[i], s[i], cap, thr, sthr)
            check(torch.equal(kv[i], pv) and torch.equal(ki[i], pi),
                  f"nms {name}, image {i}: kernel != plain")
            err = max(err, int((ki[i] - pi).abs().max()))
        log(f"[nms] {name}: batch {s.shape[0]} n={s.shape[1]} cap={cap} "
            f"selected {kv.sum(1).tolist()} -- indices equal in every image")

    # the shared edge cases (also run through the plain version and the
    # JAX package by the CPU tests), and the size the kernel refuses
    for name, b, s, cap, thr, sthr in nms_edge_cases():
        b, s = torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev)
        ki, kv = nm._nms_cuda(b, s, cap, thr, sthr)
        for i in range(s.shape[0]):
            pi, pv = nm.non_max_suppression_plain(b[i], s[i], cap, thr, sthr)
            check(torch.equal(kv[i], pv) and torch.equal(ki[i], pi),
                  f"nms edge case {name!r}, image {i}: kernel != plain")
        log(f"[nms] edge case {name!r}: batch {s.shape[0]} n={s.shape[1]} "
            f"cap={cap} selected {kv.sum(1).tolist()} -- equal")
    try:
        nm._nms_cuda(torch.zeros(1, 8193, 4, device=dev),
                     torch.zeros(1, 8193, device=dev), 4, 0.5, float("-inf"))
    except ValueError as e:
        log(f"[nms] n=8193 raises: {e}")
    else:
        raise AssertionError("nms kernel took 8193 boxes")

    def time_nms(args):
        """(kernel ms, plain ms, bound ms, bound by, selections) of one
        K2 launch on a captured batch."""
        b, s, cap, thr, sthr = args
        B, n = s.shape
        t_k = cuda_time_ms(lambda: nm._nms_cuda(b, s, cap, thr, sthr), 20)
        t_p = cuda_time_ms(lambda: [nm.non_max_suppression_plain(
            b[i], s[i], cap, thr, sthr) for i in range(B)], 1, warmup=0)
        sel = nm._nms_cuda(b, s, cap, thr, sthr)[1].sum(1)
        # bytes: boxes + scores in, (index, valid) out; operations: one IoU
        # (~12 flops) per box per selection this input made
        bms, by = bound_ms(B * (n * 20 + cap * 5),
                           int((sel + 1).sum()) * n * 12)
        return t_k, t_p, bms, by, sel.tolist()

    # the row's times are at the chunk's batch (what run_chunk_paired
    # launches); the per-frame form's batch-1 launch stands beside them
    t_k, t_p, bms, by, sel = time_nms(rec.seen[("nms", 1000, N_CHUNK)])
    t_k1, t_p1, bms1, by1, sel1 = time_nms(rec.seen[("nms", 1000, 1)])
    rows["nms"] = dict(name="nms", route="cuda",
                       source="slam_maskrcnn_tpu_torch/csrc/nms.cu",
                       replaces="slam_maskrcnn_tpu/ops/pallas/nms_kernel.py:35",
                       max_abs_err=float(err), ms=t_k, plain_ms=t_p,
                       bound_ms=bms, bound_by=by, library_ms=None,
                       batch=N_CHUNK, batch1_ms=t_k1, batch1_plain_ms=t_p1,
                       batch1_bound_ms=bms1)
    log(f"[nms] proposals at batch {N_CHUNK}: kernel {t_k:.3f} ms, plain "
        f"{t_p:.3f} ms, bound {bms:.5f} ms ({by}), selections {sel}")
    log(f"[nms] proposals at batch 1: kernel {t_k1:.3f} ms, plain "
        f"{t_p1:.3f} ms, bound {bms1:.5f} ms ({by1}), selections {sel1}")

    # ---- K4 sorted NMS: the suppression mask against its plain version
    # in every image, and the variant's selection against K2's, on the
    # same cases
    def sort_boxes(b, s, sthr):
        live = torch.where(s > sthr, s, torch.full_like(s, nm.NEG_INF))
        _, order = torch.sort(live, dim=1, descending=True, stable=True)
        return torch.gather(b, 1, order[..., None].expand(-1, -1, 4)
                            ).contiguous()

    err = 0
    for name, (b, s, cap, thr, sthr) in cases:
        bs = sort_boxes(b, s, sthr)
        k_sup = nm._nms_sorted_cuda(bs, thr)
        for i in range(s.shape[0]):
            p_sup = nm.nms_sorted_suppression_plain(bs[i], thr)
            check(torch.equal(k_sup[i], p_sup),
                  f"nms_sorted {name}, image {i}: kernel != plain")
            err = max(err, int((k_sup[i].int() - p_sup.int()).abs().max()))
        si, sv = nm.non_max_suppression(b, s, cap, thr, sthr,
                                        variant="sorted")
        ai, av = nm._nms_cuda(b, s, cap, thr, sthr)
        check(torch.equal(si, ai) and torch.equal(sv, av),
              f"nms_sorted {name}: selection != argmax kernel's")
        log(f"[nms_sorted] {name}: batch {s.shape[0]} n={s.shape[1]} "
            f"suppressed {k_sup.sum(1).tolist()} -- mask equal in every "
            f"image, selection equal to argmax")

    # the shared edge cases: the mask against its plain version in every
    # image, the selection against the argmax kernel's (ties, IoUs on the
    # threshold and a few ulp beside it, which the kernels decide by a band)
    for name, b, s, cap, thr, sthr in nms_edge_cases():
        b, s = torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev)
        bs = sort_boxes(b, s, sthr)
        k_sup = nm._nms_sorted_cuda(bs, thr)
        for i in range(s.shape[0]):
            check(torch.equal(k_sup[i], nm.nms_sorted_suppression_plain(
                bs[i], thr)), f"nms_sorted edge case {name!r}, image {i}: "
                              f"kernel != plain")
        si, sv = nm.non_max_suppression(b, s, cap, thr, sthr,
                                        variant="sorted")
        ai, av = nm._nms_cuda(b, s, cap, thr, sthr)
        check(torch.equal(si, ai) and torch.equal(sv, av),
              f"nms_sorted edge case {name!r}: selection != argmax kernel's")
        log(f"[nms_sorted] edge case {name!r}: batch {s.shape[0]} "
            f"n={s.shape[1]} suppressed {k_sup.sum(1).tolist()} -- mask "
            f"equal, selection equal to argmax")

    def time_nms_sorted(args):
        b, s, cap, thr, sthr = args
        B, n = s.shape
        bs = sort_boxes(b, s, sthr)
        t_k = device_ms(lambda: nm._nms_sorted_cuda(bs, thr))
        t_w = cuda_time_ms(lambda: nm._nms_sorted_cuda(bs, thr), 20)
        t_p = cuda_time_ms(lambda: [nm.nms_sorted_suppression_plain(
            bs[i], thr) for i in range(B)], 1, warmup=0)
        t_var = cuda_time_ms(lambda: nm.non_max_suppression(
            b, s, cap, thr, sthr, variant="sorted"), 20)
        # bytes: sorted boxes in, the mask out; operations: one IoU (~12
        # flops) for each pair i < j
        bms, by = bound_ms(B * (n * 16 + n), B * n * (n - 1) / 2 * 12)
        return t_k, t_w, t_p, t_var, bms, by

    t_k4, t_w4, t_p4, t_var, bms, by = time_nms_sorted(
        rec.seen[("nms", 1000, N_CHUNK)])
    t_k41, t_w41, t_p41, t_var1, bms1, by1 = time_nms_sorted(
        rec.seen[("nms", 1000, 1)])
    rows["nms_sorted"] = dict(
        name="nms_sorted", route="cuda",
        source="slam_maskrcnn_tpu_torch/csrc/nms_sorted.cu",
        replaces="slam_maskrcnn_tpu/ops/pallas/nms_kernel.py:82",
        max_abs_err=float(err), ms=t_k4, plain_ms=t_p4, bound_ms=bms,
        bound_by=by, library_ms=None, batch=N_CHUNK, batch1_ms=t_k41,
        batch1_plain_ms=t_p41, batch1_bound_ms=bms1, wrapper_ms=t_w4,
        batch1_wrapper_ms=t_w41)
    log(f"[nms_sorted] proposals at batch {N_CHUNK}: kernel {t_k4:.4f} ms "
        f"(device; {t_w4:.4f} through the wrapper), plain {t_p4:.3f} ms, "
        f"bound {bms:.5f} ms ({by}); the whole variant (sort, kernel, cut) "
        f"{t_var:.3f} ms against {t_k:.3f} ms of the argmax kernel")
    log(f"[nms_sorted] proposals at batch 1: kernel {t_k41:.4f} ms (device; "
        f"{t_w41:.4f} through the wrapper), plain {t_p41:.3f} ms, bound "
        f"{bms1:.5f} ms ({by1}); the whole variant {t_var1:.3f} ms against "
        f"{t_k1:.3f} ms of the argmax kernel")

    # ---- K3 PyramidROIAlign: 1000 boxes at pool 7 and 32 at pool 14, at
    # batch 1 (the step) and the chunk's batch (one launch per head), on
    # the main path's bf16 pyramids and on their f32 upcast: every image
    # against the plain version
    err = 0.0
    for pool in (7, 14):
        for batch in (1, N_CHUNK):
            feats, boxes, p, shape = rec.roi_inputs(pool, batch)
            for f in (feats, tuple(x.float() for x in feats)):
                k = ra._roi_align_cuda(f, boxes, p, shape)
                pl = ra.pyramid_roi_align_plain(f, boxes, p, shape)
                torch.cuda.synchronize()
                per = [float((k[i] - pl[i]).abs().max())
                       for i in range(batch)]
                n_ne = int((k != pl).sum())
                check(max(per) <= 1e-4, f"roi_align pool {pool} batch "
                      f"{batch} {f[0].dtype}: errors {per}")
                err = max(err, max(per))
                log(f"[roi_align] pool {pool} batch {batch} {f[0].dtype} "
                    f"n={boxes.shape[1]}: max |kernel - plain| {max(per):.3e} "
                    f"over {batch} images, {n_ne} of {k.numel()} elements "
                    f"differ")
            del k, pl

    def time_roi(pool, batch):
        """(kernel ms, through-the-wrapper ms, plain ms, bound ms, bound by)
        of one launch on a captured batch."""
        feats, boxes, p, shape = rec.roi_inputs(pool, batch)
        t_k = device_ms(lambda: ra._roi_align_cuda(feats, boxes, p, shape))
        t_w = cuda_time_ms(lambda: ra._roi_align_cuda(feats, boxes, p,
                                                      shape), 20)
        t_p = cuda_time_ms(lambda: ra.pyramid_roi_align_plain(
            feats, boxes, p, shape), 2)
        n_out = boxes.shape[0] * boxes.shape[1] * p * p * feats[0].shape[-1]
        # bytes: the feature cells this run's rois read (each once) + boxes
        # + the f32 output; operations: ~11 flops per output element
        bms, by = bound_ms(roi_read_bytes(feats, boxes, p, shape)
                           + boxes.numel() * 4 + n_out * 4, n_out * 11)
        return t_k, t_w, t_p, bms, by

    times = {(pool, batch): time_roi(pool, batch)
             for pool in (7, 14) for batch in (1, N_CHUNK)}
    for (pool, batch), (t_k, t_w, t_p, bms, by) in times.items():
        log(f"[roi_align] pool {pool} batch {batch}: kernel {t_k:.4f} ms "
            f"(device; {t_w:.4f} through the wrapper), plain {t_p:.3f} ms, "
            f"bound {bms:.5f} ms ({by})")
    (t_k, t_w, t_p, bms, by), (t_k1, t_w1, t_p1, bms1, _) = (
        times[(7, N_CHUNK)], times[(7, 1)])
    rows["roi_align"] = dict(
        name="roi_align", route="cuda",
        source="slam_maskrcnn_tpu_torch/csrc/roi_align.cu",
        replaces="slam_maskrcnn_tpu/ops/pallas/roi_align_kernel.py:61",
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=by,
        library_ms=None, batch=N_CHUNK, batch1_ms=t_k1, batch1_plain_ms=t_p1,
        batch1_bound_ms=bms1, wrapper_ms=t_w, batch1_wrapper_ms=t_w1,
        pool14={f"batch{b}": dict(zip(("ms", "wrapper_ms", "plain_ms",
                                        "bound_ms", "bound_by"),
                                       times[(14, b)]))
                for b in (1, N_CHUNK)})
    del times

    # ---- K1 fuse and K1-pair at 512^3 on the main path's state: the next
    # frames with a mask. Checks first (three copies of the volume), then
    # times.
    (depth, color, e2i), (depth2, color2, e2i2) = staged[0], staged[1]
    mask = (depth.to(torch.int32) > 0).to(torch.uint8) * 3
    mask2 = (depth2.to(torch.int32) > 0).to(torch.uint8) * 5
    params = fz.fuse_params(state, e2i, K4, cfg)
    params2 = fz.fuse_params(state, e2i2, K4, cfg)
    nvox = VOL[0] * VOL[1] * VOL[2]

    def changes(vol, w0, h0):
        """(voxels updated, gated updates) since the snapshot."""
        return (int((vol.weight != w0).sum()),
                int(vol.hist.sum(dtype=torch.int64) - h0))

    def class_shares(vol, cls_kernel, frames_params, tag):
        """The kernel's brick classes (one set per frame) against
        brick_classes_plain, and the share of bricks and of voxels per
        class. Returns the plain classes."""
        dims = vol.diff.shape
        size = [torch.clamp(torch.arange(0, n, b, device=dev) + b, max=n)
                - torch.arange(0, n, b, device=dev)
                for n, b in zip(dims, fz.BRICK)]
        vox = (size[0][:, None, None] * size[1][None, :, None]
               * size[2][None, None, :])
        out = []
        for k, (d, p) in enumerate(frames_params):
            cls = fz.brick_classes_plain(vol, p, *fz.depth_tiles_plain(d),
                                         *d.shape)
            check(torch.equal(cls, cls_kernel[k]),
                  f"{tag} frame {k}: the kernel's brick classes != plain "
                  f"({int((cls != cls_kernel[k]).sum())} bricks)")
            share = {name: (float((cls == c).float().mean()),
                            float(vox[cls == c].sum() / vox.sum()))
                     for name, c in (("skip", fz.SKIP), ("free", fz.FREE),
                                     ("full", fz.FULL))}
            log(f"[{tag}] frame {k}: " + ", ".join(
                f"{n} {b:.4f} of the bricks / {v:.4f} of the voxels"
                for n, (b, v) in share.items())
                + f" ({cls.numel()} bricks; classes equal to plain)")
            out.append((cls, share))
        return out

    w0, h0 = state.weight.clone(), state.hist.sum(dtype=torch.int64)
    other = state.clone()
    cls_k = fz._fuse_cuda(state, depth, color, mask, params)
    fz.fuse_frame_plain(other, depth, color, mask, params)
    torch.cuda.synchronize()
    (_, share1), = class_shares(other, cls_k[None], [(depth, params)], "fuse")
    check(all(b > 0 for b, _ in share1.values()),
          f"fuse: a brick class is empty on the main path's frame: {share1}")
    for f in ("weight", "color", "hist"):
        check(torch.equal(getattr(state, f), getattr(other, f)),
              f"fuse {f}: kernel != plain")
    err = float((state.diff - other.diff).abs().max())
    check(err <= 2e-6, f"fuse diff err {err}")
    n_valid, n_gated = changes(state, w0, h0)
    check(n_valid > 1_000_000 and n_gated > 0, "fuse fixture fuses")
    log(f"[fuse] 512^3: weight/color/hist equal, max |diff| {err:.3e}, "
        f"{n_valid} valid and {n_gated} gated voxels")

    # the pair on `state`, two single launches on `twice`, the plain
    # version twice on `other`
    w0.copy_(state.weight)
    h0 = state.hist.sum(dtype=torch.int64)
    twice = state.clone()
    pair_args = (depth2, color2, mask2, params2, depth, color, mask, params)
    cls_k = fz._fuse_pair_cuda(state, *pair_args)
    for _, share in class_shares(other, cls_k, [(depth2, params2),
                                                (depth, params)],
                                 "fuse_pair"):
        check(all(b > 0 for b, _ in share.values()),
              f"fuse_pair: a brick class is empty: {share}")
    fz._fuse_cuda(twice, *pair_args[:4])
    fz._fuse_cuda(twice, *pair_args[4:])
    fz.fuse_frames2_plain(other, *pair_args)
    torch.cuda.synchronize()
    for f in ("diff", "weight", "color", "hist"):
        check(torch.equal(getattr(state, f), getattr(twice, f)),
              f"fuse_pair {f}: pair != two single launches")
    for f in ("weight", "color", "hist"):
        check(torch.equal(getattr(state, f), getattr(other, f)),
              f"fuse_pair {f}: kernel != plain")
    err2 = float((state.diff - other.diff).abs().max())
    check(err2 <= 2e-6, f"fuse_pair diff err {err2}")
    n_valid2, n_gated2 = changes(state, w0, h0)
    n_twice = int(((state.weight - w0) == 2).sum())
    check(n_valid2 > 1_000_000 and n_twice > 100_000,
          "pair fixture: voxels seen by both frames")
    log(f"[fuse_pair] 512^3: bit-equal to two single launches (diff too); "
        f"weight/color/hist equal to plain, max |diff| {err2:.3e}; "
        f"{n_valid2} voxels updated ({n_twice} by both frames), {n_gated2} "
        f"gated updates")
    del w0, twice
    torch.cuda.empty_cache()

    # ---- 128^3, poses the main path does not reach, and a depth image
    # with holes inside otherwise free tiles: kernel against plain, the
    # kernel's classes against the plain classes, the pair against two
    # single launches
    from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
    cfg_s = FusionConfig(vol_dim=(128,) * 3)
    warm = fz.init_state(cfg_s, state.vol_start, state.vol_end, device=dev)
    fz.fuse_frame_plain(warm, depth2, color2, mask2,
                        fz.fuse_params(warm, e2i2, K4, cfg_s))
    holes = depth.cpu().numpy().copy()
    rng = np.random.default_rng(5)
    holes[rng.integers(0, H, 40), rng.integers(0, W, 40)] = 0
    holes[H // 2:H // 2 + 4, W // 2:W // 2 + W // 5] = 0
    holes = torch.from_numpy(holes).to(dev)
    seeded = [(name, depth, e) for name, e in seeded_poses(
        state.vol_start, state.vol_end, e2i).items()]
    seeded.append(("holes", holes, e2i))
    for name, d, e in seeded:
        p = fz.fuse_params(warm, e, K4, cfg_s)
        p2 = fz.fuse_params(warm, e2i2, K4, cfg_s)
        a, b, c, t2 = (warm.clone() for _ in range(4))
        cls_k = fz._fuse_cuda(a, d, color, mask, p)
        fz.fuse_frame_plain(b, d, color, mask, p)
        (cls, share), = class_shares(b, cls_k[None], [(d, p)],
                                     f"fuse 128^3 {name}")
        for f in ("weight", "color", "hist"):
            check(torch.equal(getattr(a, f), getattr(b, f)),
                  f"fuse 128^3 {name} {f}: kernel != plain")
        e_s = float((a.diff - b.diff).abs().max())
        check(e_s <= 2e-6, f"fuse 128^3 {name} diff err {e_s}")
        n_upd = int((a.weight != warm.weight).sum())
        if name == "away":
            check(n_upd == 0 and share["skip"][0] == 1.0
                  and torch.equal(a.diff, warm.diff),
                  "looking away: the state must not change")
        else:
            check(n_upd > 0, f"fuse 128^3 {name}: nothing fused")
        # the pair (this pose, then the main path's next frame)
        fz._fuse_pair_cuda(c, d, color, mask, p, depth2, color2, mask2, p2)
        fz._fuse_cuda(t2, d, color, mask, p)
        fz._fuse_cuda(t2, depth2, color2, mask2, p2)
        fz.fuse_frame_plain(b, depth2, color2, mask2, p2)
        torch.cuda.synchronize()
        for f in ("diff", "weight", "color", "hist"):
            check(torch.equal(getattr(c, f), getattr(t2, f)),
                  f"fuse_pair 128^3 {name} {f}: pair != two single launches")
        for f in ("weight", "color", "hist"):
            check(torch.equal(getattr(c, f), getattr(b, f)),
                  f"fuse_pair 128^3 {name} {f}: kernel != plain")
        e_p = float((c.diff - b.diff).abs().max())
        check(e_p <= 2e-6, f"fuse_pair 128^3 {name} diff err {e_p}")
        err, err2 = max(err, e_s), max(err2, e_p)
        log(f"[fuse] 128^3 {name}: kernel == plain (max |diff| {e_s:.3e}, "
            f"{n_upd} voxels updated); pair == two singles bit for bit, "
            f"== plain (max |diff| {e_p:.3e})")
    del warm, a, b, c, t2

    def two_singles():
        fz._fuse_cuda(state, *pair_args[:4])
        fz._fuse_cuda(state, *pair_args[4:])

    t_k = cuda_time_ms(lambda: fz._fuse_cuda(state, depth, color, mask,
                                             params), 10)
    t_pair = cuda_time_ms(lambda: fz._fuse_pair_cuda(state, *pair_args), 10)
    t_two = cuda_time_ms(two_singles, 10)
    t_pair_b = cuda_time_ms(lambda: fz._fuse_pair_cuda(state, *pair_args), 10)
    t_p = cuda_time_ms(lambda: fz.fuse_frame_plain(other, depth, color, mask,
                                                   params), 2)
    t_pp = cuda_time_ms(lambda: fz.fuse_frames2_plain(other, *pair_args), 2)
    del other
    torch.cuda.empty_cache()
    # bytes a frame needs: the frame (depth 2 + color 3 + mask 1 B per
    # pixel) once, diff and weight read+written for valid voxels, color (3)
    # and one histogram bin (2) read+written for gated ones; operations:
    # the projection (~20 flops) of every voxel. The pair: both frames,
    # diff and weight once for a voxel valid in either frame, color and
    # bin per gated update, two projections.
    bms, by = bound_ms(H * W * 6 + n_valid * 16 + n_gated * 10, nvox * 20)
    rows["fuse"] = dict(name="fuse", route="cuda",
                        source="slam_maskrcnn_tpu_torch/csrc/fuse.cu",
                        replaces="slam_maskrcnn_tpu/ops/pallas/"
                                 "fuse_kernel.py:550",
                        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bms,
                        bound_by=by, library_ms=None)
    log(f"[fuse] kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
        f"{bms:.5f} ms ({by})")
    bms, by = bound_ms(2 * H * W * 6 + n_valid2 * 16 + n_gated2 * 10,
                       nvox * 40)
    rows["fuse_pair"] = dict(name="fuse_pair", route="cuda",
                             source="slam_maskrcnn_tpu_torch/csrc/fuse.cu",
                             replaces="slam_maskrcnn_tpu/ops/pallas/"
                                      "fuse_kernel.py:2266",
                             max_abs_err=err2, ms=t_pair, plain_ms=t_pp,
                             bound_ms=bms, bound_by=by, library_ms=None)
    log(f"[fuse_pair] kernel {t_pair:.3f} ms (again {t_pair_b:.3f}), two "
        f"single launches {t_two:.3f} ms, plain {t_pp:.3f} ms, bound "
        f"{bms:.5f} ms ({by})")
    return rows


def stage2_phase(dev):
    """Phase 5: SemanticFusion on ground-truth masks, 512^3 on the GPU with
    an instance render, and 64^3 CPU (plain) vs GPU (kernels): state,
    masks, renders and the splat probe must agree bit for bit."""
    import torch
    from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                        make_sequence)
    from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
    from slam_maskrcnn_tpu_torch.fusion.splat import (INSTANCE_PALETTE,
                                                      splat_probe,
                                                      splat_render_orbit)
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)

    K4 = make_intrinsic(520.9, 521.0, 325.1, 249.7)
    frames = make_sequence(default_scene(), K4, H, W, n_frames=6)
    cfg = FusionConfig(vol_dim=VOL, splat_max_blocks=8192,
                       splat_max_surface=1024 * 1024, splat_max_rows=49152,
                       splat_row_cap=20, probe_mode="depth", probe_stride=2)
    sf = SemanticFusion(K4, cfg, backend="pallas", device=dev)
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
    # the instance render must show both spheres in their palette colors
    img = splat_render_orbit(sf.state, 0.05, frames[0]["mean_depth"], K4, H,
                             W, cfg, mode="instance")
    torch.cuda.synchronize()
    share = [float((img == torch.from_numpy(INSTANCE_PALETTE[i]).to(dev))
                   .all(-1).float().mean()) for i in (1, 2)]
    log(f"[stage2] 512^3 instance render: palette 1 on {share[0]:.4f}, "
        f"palette 2 on {share[1]:.4f} of the pixels")
    check(min(share) > 0.01, f"both spheres in the instance render: {share}")
    del sf, img
    torch.cuda.empty_cache()

    # 64^3 with the default configuration (splat probe, exact compaction)
    Ks = make_intrinsic(100.0, 100.0, 64.0, 48.0)
    small = make_sequence(default_scene(), Ks, 96, 128, n_frames=5)
    cfg_s = FusionConfig(vol_dim=(64,) * 3)
    e2i = np.eye(4, dtype=np.float32)
    outs = []
    for d in ("cpu", dev):
        sf = SemanticFusion(Ks, cfg_s, backend="pallas", device=d)
        masks = [sf.parse_frame(fr["depth"], fr["color"], fr["mask"],
                                fr["extrinsic"], fr["mean_depth"])
                 for fr in small]
        views = [splat_render_orbit(sf.state, 0.1, small[0]["mean_depth"],
                                    Ks, 96, 128, cfg_s, mode=m).cpu()
                 for m in ("instance", "color")]
        probs = splat_probe(sf.state, e2i, Ks, 96, 128, cfg_s)[0].cpu()
        outs.append((sf.dense_state(), [m.cpu() for m in masks[1:]], views,
                     probs))
    (a, ma, va, pa), (b, mb, vb, pb) = outs
    for f in ("diff", "color", "weight", "hist"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"64^3 CPU vs GPU {f}")
    check(all(torch.equal(x, y) for x, y in zip(ma, mb)), "64^3 masks")
    check(a.num_objs == b.num_objs == 3, "64^3 num_objs")
    check(all(torch.equal(x, y) for x, y in zip(va, vb))
          and bool(va[0].any()) and bool(va[1].any()), "64^3 renders")
    check(torch.equal(pa, pb) and float(pa.sum()) > 0, "64^3 splat probe")
    log("[stage2] 64^3 (splat probe): CPU plain == GPU kernels (diff, color, "
        "weight, hist, masks, instance and color renders, probe)")
    return stage2_xla(dev, Ks, small)


def stage2_xla(dev, Ks, small):
    """Phase 5b: the dense ("xla") backend, torch code on the card: at 64^3
    the card against the CPU with a u16 and a u32 histogram
    (SemanticFusion) and in majority-vote mode (fuse_frame_dense): the
    relabeled masks and every integer array equal, |diff delta| <= 2e-6;
    then its frames/s and peak memory at 256^3 with the default u32
    histogram (2 GiB alone). Returns the summary."""
    import torch
    from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                        make_sequence)
    from slam_maskrcnn_tpu_torch.fusion import state as fstate
    from slam_maskrcnn_tpu_torch.fusion.fuse import (fuse_frame_dense,
                                                     to_dense)
    from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)

    def same(a, b, fields, what):
        for f in fields:
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"{what}: CPU vs GPU {f}")
        err = float(np.abs(a.diff - b.diff).max())
        check(err <= 2e-6, f"{what}: CPU vs GPU |diff delta| {err}")
        return err

    errs = {}
    for hd in (np.uint16, np.uint32):
        cfg = FusionConfig(vol_dim=(64,) * 3, hist_dtype=hd)
        outs = []
        for d in ("cpu", dev):
            sf = SemanticFusion(Ks, cfg, backend="xla", device=d)
            masks = [sf.parse_frame(fr["depth"], fr["color"], fr["mask"],
                                    fr["extrinsic"], fr["mean_depth"])
                     for fr in small]
            outs.append((sf.dense_state(), [m.cpu() for m in masks[1:]]))
        (a, ma), (b, mb) = outs
        check(a.hist.dtype == b.hist.dtype == hd, "xla histogram dtype")
        check(all(torch.equal(x, y) for x, y in zip(ma, mb)),
              f"xla {np.dtype(hd).name} masks")
        check(a.num_objs == b.num_objs == 3, "xla num_objs")
        errs[np.dtype(hd).name] = same(a, b, ("color", "weight", "hist"),
                                       f"xla {np.dtype(hd).name}")
    mv_cfg = FusionConfig(vol_dim=(64,) * 3, majority_vote=True)
    f0 = small[0]
    e0 = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        st = fstate.init_from_first_frame(mv_cfg, f0["depth"], Ks,
                                          f0["mean_depth"], device=d)
        for k, fr in enumerate(small[1:]):
            mask = np.where(fr["mask"] > 0, (fr["mask"] + k % 2) % 32, 0)
            fuse_frame_dense(st, torch.from_numpy(fr["depth"]).to(d),
                             torch.from_numpy(fr["color"]).to(d),
                             torch.from_numpy(mask.astype(np.uint8)).to(d),
                             (fr["extrinsic"] @ e0).astype(np.float32), Ks,
                             mv_cfg)
        outs.append(to_dense(st))
    errs["majority_vote"] = same(outs[0], outs[1],
                                 ("color", "weight", "mv_id", "mv_cnt"),
                                 "xla majority vote")
    check(int(outs[1].mv_cnt.max()) >= 2, "majority-vote counters count")
    log(f"[stage2] xla backend at 64^3: CPU == GPU (masks, color, weight, "
        f"hist at u16 and u32; mv_id, mv_cnt in majority-vote mode), max "
        f"|diff delta| {errs}")

    # 256^3, u32 (the default), 480x640 frames
    K4 = make_intrinsic(520.9, 521.0, 325.1, 249.7)
    frames = make_sequence(default_scene(), K4, H, W, n_frames=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sf = SemanticFusion(K4, FusionConfig(vol_dim=(XLA_VOL,) * 3),
                        backend="xla", device=dev)
    fr = frames[0]
    sf.parse_frame(fr["depth"], fr["color"], fr["mask"], fr["extrinsic"],
                   fr["mean_depth"])
    staged = [{k: torch.from_numpy(np.asarray(f[k])).to(dev)
               for k in ("depth", "color", "mask")} for f in frames[1:]]
    torch.cuda.synchronize()
    t0 = time.time()
    for f, st in zip(frames[1:], staged):
        mg = sf.parse_frame(st["depth"], st["color"], st["mask"],
                            f["extrinsic"], f["mean_depth"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    fps = len(staged) / dt
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ids = sorted(np.unique(mg.cpu().numpy()).tolist())
    check(ids == [0, 1, 2] and sf.state.hist.dtype == torch.int32,
          f"xla {XLA_VOL}^3 u32 association: ids {ids}")
    st = staged[-1]
    busy = profile_run(lambda: sf.parse_frame(
        st["depth"], st["color"], st["mask"], frames[-1]["extrinsic"],
        frames[-1]["mean_depth"]), 1, "xla frame")
    log(f"[stage2] xla backend at {XLA_VOL}^3 (u32 histogram, {H}x{W}): "
        f"{len(staged)} frames in {dt:.3f} s = {fps:.2f} frames/s, peak "
        f"{peak:.2f} GiB, ids {ids}")
    del sf, staged
    torch.cuda.empty_cache()
    return dict(xla_64_max_diff_err=errs, xla_256_fps=fps,
                xla_256_peak_gib=peak, xla_256_busy_share=busy)


def _copy(a):
    """A deep copy of a wrapper's arguments: tensors and volumes cloned,
    tuples walked, the rest as it is."""
    if isinstance(a, tuple):
        return tuple(_copy(x) for x in a)
    return a.clone() if hasattr(a, "clone") else a


class FirstCalls:
    """Keeps a copy of the inputs of the ``nth`` launch of each kernel
    wrapper on the pipeline phase's paths (NMS, ROIAlign, the fuse
    kernel), so each can be held against its plain version at those shapes
    after the counted runs. The fuse capture clones the volume before the
    launch updates it in place."""

    def __init__(self, nth: int = 3):
        import slam_maskrcnn_tpu_torch.fusion.fuse as fz
        import slam_maskrcnn_tpu_torch.ops.nms as nms_mod
        import slam_maskrcnn_tpu_torch.ops.roi_align as roi_mod
        self.seen, self.n = {}, {}
        mods = {"nms": (nms_mod, "_nms_cuda"),
                "roi_align": (roi_mod, "_roi_align_cuda"),
                "fuse": (fz, "_fuse_cuda")}
        self.restore = []
        for key, (mod, attr) in mods.items():
            orig = getattr(mod, attr)
            self.restore.append((mod, attr, orig))

            def wrap(*args, _key=key, _orig=orig):
                sub = (_key, args[2]) if _key == "roi_align" else _key
                self.n[sub] = self.n.get(sub, 0) + 1
                if self.n[sub] == nth:
                    self.seen[sub] = _copy(args)
                return _orig(*args)
            setattr(mod, attr, wrap)

    def close(self):
        for mod, attr, orig in self.restore:
            setattr(mod, attr, orig)


def write_tum(root, frames, masks=True, base_ts=1311868164.0):
    """A TUM RGB-D sequence on disk with the port's PNG codec: rgb/ (the
    BGR frames), depth/ (u16), mask/ (the ground-truth labels) and
    groundtruth.txt (camera-to-world poses; the synthetic extrinsics are
    translations)."""
    import os
    from slam_maskrcnn_tpu_torch.data.png import write_png
    for d in ("rgb", "depth") + (("mask",) if masks else ()):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    lines = []
    for i, fr in enumerate(frames):
        name = f"{base_ts + 0.05 * i:.6f}.png"
        write_png(os.path.join(root, "rgb", name), fr["color"])
        write_png(os.path.join(root, "depth", name), fr["depth"])
        if masks:
            write_png(os.path.join(root, "mask", name), fr["mask"])
        E = np.asarray(fr["extrinsic"], np.float64)
        check(np.array_equal(E[:3, :3], np.eye(3)), "translation-only poses")
        t = [repr(float(-v)) for v in E[:3, 3]]
        lines.append(f"{base_ts + 0.05 * i:.6f} {' '.join(t)} 0.0 0.0 0.0 "
                     "1.0")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(lines)
                + "\n")


def pipeline_phase(dev):
    """Phase 6: the trained detector and the two-stage pipeline through
    the user's entry points: the 20 scenes, stage 1 on JPEG frames (path
    "stage1_jpeg"), stage 1 -> stage 2 on disk, the live pipeline.
    Returns (launches per path, rows of the kernel checks at the
    pipeline's shapes, summary)."""
    import os
    import shutil
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                        make_sequence)
    from slam_maskrcnn_tpu_torch.data import jpeg
    from slam_maskrcnn_tpu_torch.data.image_io import imread
    from slam_maskrcnn_tpu_torch.data.png import read_png
    from slam_maskrcnn_tpu_torch.data.tum import TUMSequence
    from slam_maskrcnn_tpu_torch.eval.metrics import compute_ap
    from slam_maskrcnn_tpu_torch.fusion import fuse as fz
    from slam_maskrcnn_tpu_torch.fusion.checkpoint import (load_volume,
                                                           save_volume)
    from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)
    from slam_maskrcnn_tpu_torch.models.mask_ops import (batch_mask_process,
                                                         mask_detect)
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.ops import nms as nm
    from slam_maskrcnn_tpu_torch.ops import roi_align as ra
    from slam_maskrcnn_tpu_torch.samples import fusion_demo, mask_process
    from slam_maskrcnn_tpu_torch.samples.coco import CocoInferenceConfig
    from slam_maskrcnn_tpu_torch.samples.live_pipeline import LivePipeline
    from slam_maskrcnn_tpu_torch.samples.train_shapes import (
        InferenceShapesConfig, detect_scenes, evaluate_map)
    from slam_maskrcnn_tpu_torch.utils.profiling import StageTimer

    t_phase = time.time()
    here = os.path.dirname(os.path.abspath(__file__))
    trained = os.path.join(here, "weights", "shapes_r2_f16.h5")
    work = os.path.join(here, "build", "pipeline")
    shutil.rmtree(work, ignore_errors=True)
    by_path, summary = {}, {}
    first = FirstCalls()

    def counted(path, fn):
        torch.cuda.synchronize()
        kernels.launches.reset()
        out = fn()
        torch.cuda.synchronize()
        by_path[path] = dict(kernels.launches.counts)
        return out

    # ---- 1. the trained detector: strict load, the 20 committed scenes in
    # bf16 (the default), mAP@50 against their ground truth
    scenes = detect_scenes()
    t0 = time.time()
    model = MaskRCNN("inference", InferenceShapesConfig(), device=dev)
    model.load_weights(trained)
    log(f"[pipeline] strict load of {os.path.basename(trained)} in "
        f"{time.time() - t0:.2f} s")
    model.detect([scenes[0][0]])                          # warm-up

    def detect_all(m):
        t = time.time()
        res = [m.detect([s[0]])[0] for s in scenes]
        return res, (time.time() - t) * 1e3 / len(scenes)
    res, ms_img = counted("detect", lambda: detect_all(model))
    m_ap = evaluate_map(model, scenes, results=res)
    n_det = sum(len(r["rois"]) for r in res)
    log(f"[pipeline] trained detect bf16: mAP@50 {m_ap:.4f} over "
        f"{len(scenes)} scenes ({n_det} detections), {ms_img:.2f} ms per "
        f"image, launches {by_path['detect']}")
    check(m_ap >= 0.62, f"trained bf16 mAP@50 {m_ap} < 0.62")
    summary["detect_bf16"] = dict(map50=m_ap, ms_per_image=ms_img,
                                  detections=n_det)
    summary["detect_bf16"]["busy"] = profile_run(
        lambda: detect_all(model), len(scenes), "trained image")

    # f32 with TF32 left on by the caller: the model turns it off itself
    class F32(InferenceShapesConfig):
        COMPUTE_DTYPE = "float32"
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    m32 = MaskRCNN("inference", F32(), device=dev).load_weights(trained)
    m32.detect([scenes[0][0]])
    r32, ms32 = detect_all(m32)
    torch.backends.cudnn.allow_tf32 = saved
    check(torch.backends.cudnn.allow_tf32 == saved, "TF32 flag restored")
    # the CPU plain path (~2-3 s an image) on every other scene: each size
    # and the stretched ones, in half the time
    t0 = time.time()
    cpu = MaskRCNN("inference", F32(), device="cpu").load_weights(trained)
    rcpu = [cpu.detect([s[0]])[0] for s in scenes[::2]]
    t_cpu = time.time() - t0
    n_cpu = sum(len(r["rois"]) for r in rcpu)
    matched = mad_sum = 0
    for a, b in zip(rcpu, r32[::2]):
        k, mad = match_detections(a["rois"], a["class_ids"], a["scores"],
                                  b["rois"], b["class_ids"], b["scores"],
                                  iou_thr=0.9)
        matched, mad_sum = matched + k, mad_sum + mad * k
    frac = matched / max(n_cpu, 1)
    m_ap32 = evaluate_map(m32, scenes, results=r32)
    m_apc = evaluate_map(cpu, scenes[::2], results=rcpu)
    log(f"[pipeline] trained detect f32 (TF32 off): mAP@50 {m_ap32:.4f} on "
        f"the card over the 20 scenes, {m_apc:.4f} on the CPU (plain "
        f"versions, the 10 even scenes, {t_cpu:.1f} s); box match at IoU 0.9 "
        f"{matched}/{n_cpu} = {frac:.4f} of the CPU detections, score MAD "
        f"{mad_sum / max(matched, 1):.5f}; {ms32:.2f} ms per image")
    check(frac >= 0.9, f"f32 card vs plain box match {frac}")
    summary["detect_f32"] = dict(map50=m_ap32, map50_cpu_even=m_apc,
                                 box_match=frac, score_mad=mad_sum
                                 / max(matched, 1), ms_per_image=ms32)
    del m32, cpu

    # ---- 1b. stage 1 on JPEG frames: the synthetic TUM sequence's colour
    # frames as q95 4:2:0 JPEGs by the port's encoder, batch_mask_process
    # with the trained model; each mask equals mask_detect on imread's
    # pixels
    K4 = make_intrinsic(*PIPE_K)
    frames = make_sequence(default_scene(), K4, H, W, n_frames=PIPE_FRAMES)
    rgb_dir = os.path.join(work, "jpeg_frames", "rgb")
    mask_dir = os.path.join(work, "jpeg_frames", "mask")
    os.makedirs(rgb_dir)
    blobs = []
    for k, fr in enumerate(frames):
        blobs.append(jpeg.encode(fr["color"], device=dev))
        with open(os.path.join(rgb_dir, f"{k:06d}.jpg"), "wb") as f:
            f.write(blobs[-1])
    timer = StageTimer(dev)
    n = counted("stage1_jpeg", lambda: batch_mask_process(
        model, rgb_dir, mask_dir, verbose=False, timer=timer))
    check(n == PIPE_FRAMES, f"stage 1 on JPEG frames wrote {n} masks")
    n_inst = 0
    for k in range(PIPE_FRAMES):
        f = os.path.join(rgb_dir, f"{k:06d}.jpg")
        got = read_png(os.path.join(mask_dir, f"{k:06d}.png"))
        want = mask_detect(model, np.ascontiguousarray(
            imread(f, device=dev)[:, :, ::-1]))
        check(got.shape == (H, W) and np.array_equal(got, want),
              f"stage 1 JPEG frame {k}: mask != mask_detect of imread")
        n_inst += int(got.max())
    split = [jpeg.decode_timed(b, dev)[1:] for b in blobs]
    st = {k: v * 1e3 / n for k, v in timer.totals.items()}
    summary["stage1_jpeg"] = dict(
        frames=n, instances=n_inst, read_ms=st["read"],
        detect_ms=st["detect"], write_ms=st["write"],
        entropy_ms=float(np.median([a for a, _ in split])) * 1e3,
        pixel_ms=float(np.median([b for _, b in split])) * 1e3,
        bytes=int(np.mean([len(b) for b in blobs])))
    log(f"[pipeline] stage 1 on {n} JPEG frames {H}x{W} (trained shapes "
        f"model, bf16): each mask == mask_detect of imread's pixels, "
        f"{n_inst} instances; ms a frame read {st['read']:.2f} (of it "
        f"host entropy {summary['stage1_jpeg']['entropy_ms']:.2f} + device "
        f"pixels {summary['stage1_jpeg']['pixel_ms']:.2f}, "
        f"{summary['stage1_jpeg']['bytes']} B), detect {st['detect']:.2f}, "
        f"write {st['write']:.2f}; launches {by_path['stage1_jpeg']}")

    # ---- 2. stage 1 -> stage 2 on disk: a synthetic TUM sequence, masks by
    # mask_process (COCO, ResNet-101 at 1024^2, seed-0 weights), then
    # fusion_demo on a copy holding the ground-truth masks
    n_fused = PIPE_FRAMES - 1
    seq_gt = os.path.join(work, "seq_gt")
    seq_s1 = os.path.join(work, "seq_stage1")
    write_tum(seq_gt, frames)
    write_tum(seq_s1, frames, masks=False)
    t0 = time.time()
    n = counted("mask_process", lambda: mask_process.main(
        ["--rgb", os.path.join(seq_s1, "rgb"),
         "--out", os.path.join(seq_s1, "mask"), "--device", dev]))
    t_s1 = time.time() - t0
    written = sorted(os.listdir(os.path.join(seq_s1, "mask")))
    check(n == PIPE_FRAMES and len(written) == PIPE_FRAMES,
          f"stage 1 wrote {written}")
    for f in written:
        m = read_png(os.path.join(seq_s1, "mask", f))
        check(m.dtype == np.uint8 and m.shape == (H, W), f"mask {f}")
    log(f"[pipeline] stage 1 (mask_process, COCO ResNet-101 at 1024^2, "
        f"seed-0 weights): {n} u8 mask PNGs in {t_s1:.2f} s "
        f"({t_s1 * 1e3 / n:.1f} ms per frame incl. PNG I/O), launches "
        f"{by_path['mask_process']}")
    summary["stage1_ms_per_frame"] = t_s1 * 1e3 / n

    cfg = FusionConfig(vol_dim=(PIPE_VOL,) * 3)
    orbit_dir = os.path.join(work, "orbit")
    t0 = time.time()
    fusion, views = counted("fusion_demo", lambda: fusion_demo.run(
        seq_gt, vol_dim=PIPE_VOL, backend="pallas", device=dev,
        intrinsics=PIPE_K,
        orbit_frames=4, save_dir=orbit_dir, verbose=False))
    t_demo = time.time() - t0
    # the same frames from memory: the fusion alone, timed
    mem = SemanticFusion(K4, cfg, backend="pallas", device=dev)
    mem.parse_frame(frames[0]["depth"], frames[0]["color"],
                    frames[0]["mask"], frames[0]["extrinsic"],
                    frames[0]["mean_depth"])
    torch.cuda.synchronize()
    t0 = time.time()
    for fr in frames[1:]:
        mem.parse_frame(fr["depth"], fr["color"], fr["mask"],
                        fr["extrinsic"], fr["mean_depth"])
    torch.cuda.synchronize()
    fps_fuse = n_fused / (time.time() - t0)
    for f in ("diff", "color", "weight", "hist"):
        check(torch.equal(getattr(fusion.state, f), getattr(mem.state, f)),
              f"fusion_demo from disk != SemanticFusion from memory: {f}")
    check(fusion.state.n_obs == mem.state.n_obs == n_fused
          and int(fusion.state.num_objs) == int(mem.state.num_objs) == 3,
          "fusion_demo n_obs / num_objs")
    pngs = sorted(os.listdir(orbit_dir))
    lit = [float((v.max(-1) > 0).mean()) for v in views]
    check(len(pngs) == 4 and min(lit) > 0.01, f"orbit {pngs} {lit}")
    for f, v in zip(pngs, views):
        check(np.array_equal(read_png(os.path.join(orbit_dir, f)),
                             v[:, :, ::-1]), f"orbit PNG {f}")
    log(f"[pipeline] fusion_demo {PIPE_VOL}^3: {PIPE_FRAMES} frames "
        f"({n_fused} fused) + 4 orbit views in {t_demo:.2f} s incl. PNG I/O, "
        f"state bit-equal to SemanticFusion fed from memory, which fuses "
        f"{fps_fuse:.2f} frames/s; instance views light "
        f"{[round(x, 4) for x in lit]} of the pixels; launches "
        f"{by_path['fusion_demo']}")
    summary.update(fusion_demo_s=t_demo, fusion_fps=fps_fuse)

    # the volume checkpoint: save, load, bit-equal; one more frame fused
    # into both stays equal
    t0 = time.time()
    path = save_volume(os.path.join(work, "vol.npz"), fusion.state, cfg)
    back = load_volume(path, cfg, device=dev)
    t_ckpt = time.time() - t0
    for f in ("diff", "color", "weight", "hist", "num_objs"):
        check(torch.equal(getattr(back, f), getattr(fusion.state, f)),
              f"checkpoint round trip {f}")
    check(back.n_obs == fusion.state.n_obs, "checkpoint n_obs")
    twin = SemanticFusion(K4, cfg, backend="pallas", device=dev)
    twin.state, twin.init_extrinsic_inv = back, fusion.init_extrinsic_inv
    twin.mean_depth = fusion.mean_depth
    extra = frames[2]
    for sf in (fusion, twin):
        sf.parse_frame(extra["depth"], extra["color"], extra["mask"],
                       extra["extrinsic"], extra["mean_depth"])
    for f in ("diff", "color", "weight", "hist", "num_objs"):
        check(torch.equal(getattr(back, f), getattr(fusion.state, f)),
              f"after one more frame: restored != original ({f})")
    log(f"[pipeline] checkpoint {os.path.getsize(path) / 2 ** 20:.1f} MiB "
        f"saved and loaded in {t_ckpt:.2f} s: bit-equal, and equal again "
        f"after one more fused frame")
    del fusion, mem, twin, back
    torch.cuda.empty_cache()

    # ---- 3. live: detect -> label -> fuse on the COCO model, the device
    # path over the 8 frames, the host path (depth filter) over 3
    coco = MaskRCNN("inference", CocoInferenceConfig(), device=dev)
    coco.init_params(0)
    live = LivePipeline(coco, K4, cfg, backend="pallas",
                        use_depth_filter=False)
    fps_dev = counted("live_device", lambda: live.run_device(
        TUMSequence(seq_gt), verbose=False))
    check(live.frames_done == PIPE_FRAMES
          and live.fusion.state.n_obs == n_fused, "run_device frames")
    summary["live_device_busy"] = profile_run(
        lambda: LivePipeline(coco, K4, cfg, backend="pallas",
                             use_depth_filter=False)
        .run_device(TUMSequence(seq_gt), verbose=False), PIPE_FRAMES,
        "live frame")
    host = LivePipeline(coco, K4, cfg, backend="pallas",
                        use_depth_filter=True)
    fps_host = counted("live_host", lambda: host.run(
        TUMSequence(seq_gt, max_frames=3), verbose=False))
    check(host.frames_done == 3 and host.fusion.state.n_obs == 2,
          "run frames")
    log(f"[pipeline] live: run_device {fps_dev:.2f} fused frames/s "
        f"({PIPE_FRAMES} frames, steady after 3), launches {by_path['live_device']}; run "
        f"(host path, depth filter) {fps_host:.2f} fused frames/s (3 "
        f"frames), launches {by_path['live_host']}")
    summary.update(live_device_fps=fps_dev,
                   live_host_fps=fps_host, checkpoint_s=t_ckpt)
    del live, host, coco
    first.close()

    # ---- the kernels at the pipeline's shapes against their plain
    # versions (the third launch of each)
    checks = {}
    b, s, cap, thr, sthr = first.seen["nms"]
    ki, kv = nm._nms_cuda(b, s, cap, thr, sthr)
    for i in range(s.shape[0]):
        pi, pv = nm.non_max_suppression_plain(b[i], s[i], cap, thr, sthr)
        check(torch.equal(ki[i], pi) and torch.equal(kv[i], pv),
              "pipeline nms: kernel != plain")
    checks["nms"] = dict(max_abs_err=0.0, n=int(s.shape[1]), cap=cap)
    err = 0.0
    for pool in (7, 14):
        feats, boxes, p, shape = first.seen[("roi_align", pool)]
        k = ra._roi_align_cuda(feats, boxes, p, shape)
        pl = ra.pyramid_roi_align_plain(feats, boxes, p, shape)
        err = max(err, float((k - pl).abs().max()))
    check(err <= 1e-4, f"pipeline roi_align err {err}")
    checks["roi_align"] = dict(max_abs_err=err)
    vol, depth, color, mask, params = first.seen["fuse"][:5]
    other = vol.clone()
    fz._fuse_cuda(vol, depth, color, mask, params)
    fz.fuse_frame_plain(other, depth, color, mask, params)
    for f in ("weight", "color", "hist"):
        check(torch.equal(getattr(vol, f), getattr(other, f)),
              f"pipeline fuse {f}: kernel != plain")
    err = float((vol.diff - other.diff).abs().max())
    check(err <= 2e-6, f"pipeline fuse diff err {err}")
    checks["fuse"] = dict(max_abs_err=err, vol=tuple(vol.diff.shape))
    log(f"[pipeline] kernels at the pipeline's shapes: nms (n="
        f"{checks['nms']['n']} -> {cap}) equal, roi_align (pool 7 and 14) "
        f"max err {checks['roi_align']['max_abs_err']:.3e}, fuse {PIPE_VOL}^3 "
        f"weight/color/hist equal, max |diff| {err:.3e}")
    del vol, other, first
    torch.cuda.empty_cache()
    summary["seconds"] = time.time() - t_phase
    log(f"[pipeline] phase took {summary['seconds']:.1f} s")
    return by_path, checks, summary


TRAIN_STEPS = 100              # bf16 steps from seeded init
TRAIN_LR = 0.001               # LEARNING_RATE, train_shapes' default


def train_phase(dev):
    """Phase 7: Mask R-CNN training at TrainShapesConfig (ResNet-50 FPN, 4
    classes, 128^2, batch 8, 2000 training proposals, 32 training rois)
    through MaskRCNN("training") and the Trainer's step:

    1. a seeded shapes set drawn by data/draw.py, batches by
       data_generator;
    2. one float32 step on the card against the same step on the CPU
       (plain versions), TF32 off, with the same variables, batch and
       target-sampling draws. The variables are a seeded init whose RPN
       output layers are zeroed but for the objectness bias by anchor
       ratio: the proposals are then the anchors, squares first, in index
       order on both devices. (Random RPN scores that differ by an ulp
       between the devices reorder near-tied proposals, and the sampling
       draws follow the proposal slots.) Loss parts within 1e-3
       relative, every updated parameter within 2e-6 (the CPU tests' bar
       against the JAX step);
    3. TRAIN_STEPS bfloat16 steps from seeded init, layers "all": every
       loss finite, the mean of the last 20 below that of the first 20;
       ms a step, peak memory, the device's busy share, NMS launches a
       step (counted from 0);
    4. the NMS kernel at the training shape (batch 8, n 4092, 2000
       outputs, IoU 0.7) on the proposal layer's own inputs from a step
       of (3), against its plain version in every image, and timed;
    5. save_h5_weights, a strict load into MaskRCNN("inference"), whose
       detect on the 20 committed scenes equals the trained model's.

    Returns (launches of the training run, nms row extras, summary)."""
    import os
    import shutil
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.data.dataset import data_generator
    from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
    from slam_maskrcnn_tpu_torch.models.h5 import save_h5_weights
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.models.targets import draw_target_noise
    from slam_maskrcnn_tpu_torch.ops import nms as nm
    from slam_maskrcnn_tpu_torch.samples.train_shapes import (
        InferenceShapesConfig, TrainShapesConfig, detect_scenes)
    from slam_maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                                       batch_to_device)

    t_phase = time.time()
    cfg = TrainShapesConfig()
    B, P = cfg.BATCH_SIZE, cfg.POST_NMS_ROIS_TRAINING
    ds = ShapesDataset()
    ds.load_shapes(500, 128, 128, seed=0)
    ds.prepare()
    np.random.seed(0)
    gen = data_generator(ds, cfg, seed=0)
    t0 = time.time()
    host = [next(gen) for _ in range(TRAIN_STEPS + 5)]
    data_ms = (time.time() - t0) * 1e3 / len(host)
    anchors = torch.from_numpy(get_anchors(cfg, cfg.IMAGE_SHAPE)).to(dev)
    batches = [dict(batch_to_device(h, dev), anchors=anchors) for h in host]
    log(f"[train] {len(host)} batches of {B} drawn and targeted on the host "
        f"in {data_ms:.1f} ms a batch; {anchors.shape[0]} anchors")

    # ---- 2. one f32 step, card vs CPU
    f32 = type("F32", (TrainShapesConfig,), dict(COMPUTE_DTYPE="float32"))()
    pair = []
    g = torch.Generator().manual_seed(5)
    pos, neg = draw_target_noise(B, P, g, "cpu")
    for d in ("cpu", dev):
        m = MaskRCNN("training", f32, device=d)
        m.init_params(1)
        with torch.no_grad():
            for head in (m.module.rpn_model.rpn_class_raw,
                         m.module.rpn_model.rpn_bbox_pred):
                head.weight.zero_()
                head.bias.zero_()
            # anchor (bg, fg) logits by ratio 0.5, 1, 2: squares first
            m.module.rpn_model.rpn_class_raw.bias[1::2] = torch.tensor(
                [1.0, 2.0, 0.0])
        b = dict(batch_to_device(host[0], d), anchors=anchors.to(d))
        t0 = time.time()
        loss, parts = Trainer(m).make_step(TRAIN_LR, LAYER_REGEX["all"])(
            b, pos.to(d), neg.to(d))
        if d != "cpu":
            torch.cuda.synchronize()
        pair.append((m, float(loss), {k: float(v) for k, v in parts.items()},
                     time.time() - t0))
    (mc, lc, pc, tc), (mg, lg, pg, tg) = pair
    rel = {k: abs(pg[k] - pc[k]) / max(abs(pc[k]), 1e-12) for k in pc}
    check(all(r <= 1e-3 for r in rel.values()),
          f"f32 step: card vs CPU loss parts {pg} vs {pc}")
    check(pc["mrcnn_mask_loss"] > 0 and pc["mrcnn_bbox_loss"] > 0,
          f"f32 step: positive rois {pc}")
    gp = dict(mg.module.named_parameters())
    p_err = max(float((t.detach().cpu() - gp[n].detach().cpu()).abs().max())
                for n, t in mc.module.named_parameters())
    b_err = max(float((t.cpu() - dict(mg.module.named_buffers())[n].cpu())
                      .abs().max()) for n, t in mc.module.named_buffers())
    check(p_err <= 2e-6, f"f32 step: card vs CPU params differ by {p_err}")
    log(f"[train] f32 step, card vs CPU (TF32 off): loss {lg:.6f} vs "
        f"{lc:.6f}, parts relative error {max(rel.values()):.2e}, updated "
        f"params max |delta| {p_err:.3e}, buffers {b_err:.3e}; CPU step "
        f"{tc:.1f} s, card step {tg:.2f} s (first call)")
    del pair, mc, mg, gp
    torch.cuda.empty_cache()

    # ---- 3. bf16 training from seeded init, layers "all"
    model = MaskRCNN("training", cfg, device=dev)
    model.init_params(0)
    step = Trainer(model).make_step(TRAIN_LR, LAYER_REGEX["all"])
    noise = torch.Generator(device=dev).manual_seed(0)
    seen = {}
    orig = nm._nms_cuda

    def nms_capture(boxes, scores, max_output, thr, sthr):
        if max_output == P and "args" not in seen:
            seen["args"] = (boxes.clone(), scores.clone(), max_output, thr,
                            sthr)
        return orig(boxes, scores, max_output, thr, sthr)

    def run(lo, hi, losses):
        for b in batches[lo:hi]:
            pn, nn = draw_target_noise(B, P, noise, dev)
            losses.append(step(b, pn, nn)[0])

    nm._nms_cuda = nms_capture
    try:
        warm = []
        run(0, 2, warm)                     # cuDNN's choices, the allocator
    finally:
        nm._nms_cuda = orig
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.reset()
    losses = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.time()
    start.record()
    run(2, 2 + TRAIN_STEPS, losses)
    end.record()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launches.counts)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = np.array([float(x) for x in warm + losses])
    check(np.isfinite(hist).all(), "training losses finite")
    first, last = float(hist[:20].mean()), float(hist[-20:].mean())
    check(last < first, f"training loss mean of the last 20 {last} not "
                        f"below the first 20 {first}")
    check(launches.get("nms", 0) == TRAIN_STEPS
          and launches.get("roi_align", 0) == 0,
          f"training launches: one NMS a step, no ROIAlign: {launches}")
    log(f"[train] {TRAIN_STEPS} bf16 steps (layers all, lr {TRAIN_LR}): "
        f"{step_ms:.2f} ms a step = {1e3 / step_ms:.2f} steps/s (wall "
        f"{wall * 1e3 / TRAIN_STEPS:.2f} ms a step; data on the host "
        f"{data_ms:.1f} ms a batch, not in the loop), peak {peak:.2f} GiB, "
        f"loss {hist[0]:.3f} -> {hist[-1]:.3f} (mean of the first 20 "
        f"{first:.3f}, last 20 {last:.3f}), launches {launches} "
        f"({launches['nms'] / TRAIN_STEPS:.0f} NMS a step)")
    busy = profile_run(lambda: run(2, 7, []), 5, "training step")

    # ---- 4. the NMS kernel at the training shape
    b, s, cap, thr, sthr = seen["args"]
    check(tuple(s.shape) == (B, anchors.shape[0]) and cap == P,
          f"training NMS shape {tuple(s.shape)} -> {cap}")
    ki, kv = nm._nms_cuda(b, s, cap, thr, sthr)
    for i in range(B):
        pi, pv = nm.non_max_suppression_plain(b[i], s[i], cap, thr, sthr)
        check(torch.equal(ki[i], pi) and torch.equal(kv[i], pv),
              f"training nms image {i}: kernel != plain")
    n = s.shape[1]
    t_k = cuda_time_ms(lambda: nm._nms_cuda(b, s, cap, thr, sthr), 20)
    t_p = cuda_time_ms(lambda: [nm.non_max_suppression_plain(
        b[i], s[i], cap, thr, sthr) for i in range(B)], 1, warmup=0)
    sel = kv.sum(1)
    bms, by = bound_ms(B * (n * 20 + cap * 5), int((sel + 1).sum()) * n * 12)
    log(f"[train] nms at the training shape (batch {B}, n {n}, {cap} "
        f"outputs, IoU {thr}): equal to the plain version in every image; "
        f"kernel {t_k:.3f} ms, plain {t_p:.1f} ms, bound {bms:.5f} ms "
        f"({by}), selections {sel.tolist()}")
    nms_extra = dict(train_shape=dict(batch=B, n=n, max_output=cap,
                                      ms=t_k, plain_ms=t_p, bound_ms=bms,
                                      bound_by=by, max_abs_err=0.0,
                                      selections=sel.tolist()))

    # ---- 5. the h5 writer: strict load, the same detections
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = save_h5_weights(os.path.join(work, "shapes_trained.h5"), model)
    icfg = InferenceShapesConfig()
    mem = MaskRCNN("inference", icfg, device=dev)
    mem.module.load_state_dict(model.module.state_dict())
    mem.module.to(dev)
    disk = MaskRCNN("inference", icfg, device=dev).load_weights(path)
    scenes = detect_scenes()
    ra = [mem.detect([sc[0]])[0] for sc in scenes]
    rb = [disk.detect([sc[0]])[0] for sc in scenes]
    for x, y in zip(ra, rb):
        for k in ("rois", "class_ids", "scores", "masks"):
            check(np.array_equal(x[k], y[k]),
                  f"detect after the h5 round trip: {k} differs")
    n_det = sum(len(x["class_ids"]) for x in ra)
    log(f"[train] save_h5_weights ({os.path.getsize(path) / 2 ** 20:.1f} "
        f"MiB) -> strict load: detect on the {len(scenes)} committed scenes "
        f"equal to the trained model's ({n_det} detections)")
    del model, mem, disk, batches
    shutil.rmtree(work, ignore_errors=True)          # 170 MB of f32 weights
    torch.cuda.empty_cache()
    summary = dict(step_ms=step_ms, steps_per_s=1e3 / step_ms,
                   wall_ms_per_step=wall * 1e3 / TRAIN_STEPS,
                   host_data_ms_per_batch=data_ms, peak_gib=peak,
                   busy_share=busy, loss_first20=first, loss_last20=last,
                   nms_per_step=launches["nms"] / TRAIN_STEPS,
                   f32_parts_rel_err=max(rel.values()), f32_param_err=p_err,
                   seconds=time.time() - t_phase)
    log(f"[train] phase took {summary['seconds']:.1f} s")
    return launches, nms_extra, summary


NUCLEUS_STEPS = 10             # f32 steps of the nucleus training config
BALLOON_STEPS = 3              # f32 steps of the balloon training config
NUCLEUS_IMAGES = 6             # the synthetic DSB tree (train = detect)
MINI_COCO_IMAGES = 120         # make_mini_coco(seed 0, 128^2)
# the JAX package's bbox AP50 on the same tree and weights, float32 on the
# CPU (tests/jax_mini_coco_reference.py): the port's card score must be
# within 0.02 of it
MINI_COCO_JAX_AP50 = 0.9264377597297915


class ShapeCalls:
    """Keeps a copy of the inputs of the first NMS and ROIAlign launch at
    each shape on the samples' paths: NMS keyed by (batch, n, max_output,
    IoU), ROIAlign by (pool, batch, rois, image shape)."""

    def __init__(self):
        import slam_maskrcnn_tpu_torch.ops.nms as nms_mod
        import slam_maskrcnn_tpu_torch.ops.roi_align as roi_mod
        self.seen = {}
        self.restore = [(nms_mod, "_nms_cuda", nms_mod._nms_cuda),
                        (roi_mod, "_roi_align_cuda", roi_mod._roi_align_cuda)]
        orig_nms, orig_roi = nms_mod._nms_cuda, roi_mod._roi_align_cuda

        def nms(boxes, scores, max_output, thr, sthr):
            key = ("nms", scores.shape[0], scores.shape[1], max_output,
                   round(float(thr), 4))
            if key not in self.seen:
                self.seen[key] = (boxes.clone(), scores.clone(), max_output,
                                  thr, sthr)
            return orig_nms(boxes, scores, max_output, thr, sthr)

        def roi(features, boxes, pool, image_shape):
            key = ("roi_align", pool, boxes.shape[0], boxes.shape[1],
                   tuple(image_shape))
            if key not in self.seen:
                self.seen[key] = (tuple(f.clone() for f in features),
                                  boxes.clone(), pool, image_shape)
            return orig_roi(features, boxes, pool, image_shape)

        nms_mod._nms_cuda, roi_mod._roi_align_cuda = nms, roi

    def close(self):
        for mod, attr, orig in self.restore:
            setattr(mod, attr, orig)


def hold_captured(calls, tag):
    """Each NMS and ROIAlign launch captured by ``calls`` (a ShapeCalls)
    against its plain version on the same inputs, timed, with bounds:
    ({nms shape: row}, {roi_align shape: row})."""
    import torch
    from slam_maskrcnn_tpu_torch.ops import nms as nm
    from slam_maskrcnn_tpu_torch.ops import roi_align as ra

    nms_rows, roi_rows = {}, {}
    for key in sorted(k for k in calls.seen if k[0] == "nms"):
        b, s, cap, thr, sthr = calls.seen[key]
        ki, kv = nm._nms_cuda(b, s, cap, thr, sthr)
        torch.cuda.synchronize()
        t0 = time.time()
        plain = [nm.non_max_suppression_plain(b[i], s[i], cap, thr, sthr)
                 for i in range(s.shape[0])]
        torch.cuda.synchronize()
        t_p = (time.time() - t0) * 1e3
        for i, (pi, pv) in enumerate(plain):
            check(torch.equal(ki[i], pi) and torch.equal(kv[i], pv),
                  f"{tag} nms {key} image {i}: kernel != plain")
        t_k = cuda_time_ms(lambda: nm._nms_cuda(b, s, cap, thr, sthr), 10)
        sel = kv.sum(1)
        n = s.shape[1]
        bms, by = bound_ms(s.shape[0] * (n * 20 + cap * 5),
                           int((sel + 1).sum()) * n * 12)
        name = f"batch{key[1]}_n{n}_out{cap}_iou{key[4]}"
        nms_rows[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=bms,
                              bound_by=by, max_abs_err=0.0,
                              selections=sel.tolist())
        log(f"[{tag}] nms {name}: equal to the plain version in every "
            f"image; kernel {t_k:.4f} ms, plain {t_p:.1f} ms, bound "
            f"{bms:.5f} ms ({by}), selections {sel.tolist()}")
    for key in sorted(k for k in calls.seen if k[0] == "roi_align"):
        feats, boxes, p, shape = calls.seen[key]
        k_ = ra._roi_align_cuda(feats, boxes, p, shape)
        pl = ra.pyramid_roi_align_plain(feats, boxes, p, shape)
        err = float((k_ - pl).abs().max())
        check(err <= 1e-4, f"{tag} roi_align {key}: err {err}")
        t_k = device_ms(lambda: ra._roi_align_cuda(feats, boxes, p, shape))
        t_p = cuda_time_ms(lambda: ra.pyramid_roi_align_plain(
            feats, boxes, p, shape), 2)
        n_out = boxes.shape[0] * boxes.shape[1] * p * p * feats[0].shape[-1]
        bms, by = bound_ms(roi_read_bytes(feats, boxes, p, shape)
                           + boxes.numel() * 4 + n_out * 4, n_out * 11)
        name = (f"pool{p}_batch{boxes.shape[0]}_rois{boxes.shape[1]}_"
                f"{feats[0].shape[1] * 4}px_{str(feats[0].dtype)[6:]}")
        roi_rows[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=bms,
                              bound_by=by, max_abs_err=err)
        log(f"[{tag}] roi_align {name}: max |kernel - plain| {err:.3e}; "
            f"kernel {t_k:.4f} ms (device), plain {t_p:.3f} ms, bound "
            f"{bms:.5f} ms ({by})")
        del k_, pl
    return nms_rows, roi_rows


def samples_phase(dev):
    """Phase 8: the samples on the card through their entry points.

    1. nucleus, training: a synthetic DSB tree, NucleusConfig at full
       width (ResNet-50, "crop" 512^2, batch 6, 1000 training proposals
       at IoU 0.9, 128 rois, 200 gt), f32 with TRAIN_BN, the reference
       nucleus sample's augmentation: batches drawn on the host (timed),
       NUCLEUS_STEPS steps of Trainer.make_step (CUDA events), every loss
       finite; peak memory, busy share, NMS launches a step;
    2. nucleus, detect: NucleusInferenceConfig ("pad64" at 512^2, 2000
       proposals, up to 400 detections) with the trained tensors over the
       tree through ``nucleus.detect``: every submit.csv line decodes back
       (``rle_decode_kaggle``) to the overlap-removed masks;
    3. mini-COCO: the 120-image tree, weights/shapes_r2_f16.h5 in f32
       through ``run_protocol``: bbox AP50 >= 0.85 (and within 0.02 of
       the JAX package's f32 CPU score when MINI_COCO_JAX_AP50 is set);
       on 10 images the card's boxes match the CPU plain path's at IoU 0.9
       on >= 0.9 of them;
    4. balloon: BALLOON_STEPS f32 steps of BalloonConfig (ResNet-101,
       "square" 1024^2, batch 2) through Trainer.train on the synthetic
       VIA tree, then ``detect_and_color_splash`` on one PNG: the written
       PNG equals ``color_splash`` of the same detections;
    5. tracker: ``template_match_mask_detect`` with the trained shapes
       model, class names mapping the shapes onto the tracker's
       candidates: the matched location and the box equal the CPU plain
       path's;
    6. the NMS and ROIAlign kernels at these paths' shapes (first launch
       of each shape) against their plain versions, timed, with bounds.

    Returns (launches by path, {"nms": extra, "roi_align": extra},
    summary)."""
    import os
    import shutil
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.data import augment as A
    from slam_maskrcnn_tpu_torch.data.dataset import data_generator
    from slam_maskrcnn_tpu_torch.data.png import read_png
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.models.targets import draw_target_noise
    from slam_maskrcnn_tpu_torch.samples import (balloon, mask_image,
                                                 mini_coco, nucleus)
    from slam_maskrcnn_tpu_torch.samples.coco import CocoDataset
    from slam_maskrcnn_tpu_torch.samples.sample_train_smoke import (
        balloon_setup, make_nucleus_tree, nucleus_setup)
    from slam_maskrcnn_tpu_torch.samples.train_shapes import detect_scenes
    from slam_maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                                       batch_to_device)

    t_phase = time.time()
    here = os.path.dirname(os.path.abspath(__file__))
    trained = os.path.join(here, "weights", "shapes_r2_f16.h5")
    work = os.path.join(here, "build", "samples")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    by_path, summary = {}, {}
    calls = ShapeCalls()

    def counted(path, fn):
        torch.cuda.synchronize()
        kernels.launches.reset()
        out = fn()
        torch.cuda.synchronize()
        by_path[path] = dict(kernels.launches.counts)
        return out

    # ---- 1. nucleus training, augmented, full width
    cfg, ds, _, _ = nucleus_setup(os.path.join(work, "nuc"), NUCLEUS_IMAGES,
                                  0, False)
    aug = A.SomeOf(2, [A.Fliplr(0.5), A.Flipud(0.5),
                       A.OneOf([A.Affine(rotate=90), A.Affine(rotate=180),
                                A.Affine(rotate=270)]),
                       A.Multiply((0.8, 1.5)), A.GaussianBlur((0.0, 5.0))])
    B, P = cfg.BATCH_SIZE, cfg.POST_NMS_ROIS_TRAINING
    np.random.seed(0)
    gen = data_generator(ds, cfg, seed=0, augmentation=aug)
    t0 = time.time()
    host = [next(gen) for _ in range(NUCLEUS_STEPS + 2)]
    data_ms = (time.time() - t0) * 1e3 / len(host)
    anchors = torch.from_numpy(get_anchors(cfg, cfg.IMAGE_SHAPE)).to(dev)
    batches = [dict(batch_to_device(h, dev), anchors=anchors) for h in host]
    n_gt = [int((h["gt_class_ids"] > 0).sum()) for h in host]
    log(f"[samples] nucleus: {len(host)} augmented batches of {B} "
        f"(512^2 crops) drawn on the host in {data_ms:.1f} ms a batch; gt "
        f"per batch {n_gt}; {anchors.shape[0]} anchors")
    model = MaskRCNN("training", cfg, device=dev)
    model.init_params(0)
    step = Trainer(model).make_step(1e-3, LAYER_REGEX["all"])
    noise = torch.Generator(device=dev).manual_seed(0)

    def run(lo, hi, losses):
        for b in batches[lo:hi]:
            pn, nn_ = draw_target_noise(B, P, noise, dev)
            losses.append(step(b, pn, nn_)[0])

    warm = []
    run(0, 2, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed():
        start.record()
        run(2, 2 + NUCLEUS_STEPS, losses)
        end.record()
    counted("nucleus_train", timed)
    step_ms = start.elapsed_time(end) / NUCLEUS_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = np.array([float(x) for x in warm + losses])
    check(np.isfinite(hist).all(), f"nucleus training losses {hist}")
    nms_step = by_path["nucleus_train"]["nms"] / NUCLEUS_STEPS
    log(f"[samples] nucleus training (f32, TRAIN_BN, batch {B}): "
        f"{step_ms:.2f} ms a step, peak {peak:.2f} GiB, loss {hist[0]:.3f} "
        f"-> {hist[-1]:.3f}, {nms_step:.0f} NMS launch a step, launches "
        f"{by_path['nucleus_train']}")
    busy = profile_run(lambda: run(2, 5, []), 3, "nucleus training step")
    summary["nucleus_train"] = dict(
        step_ms=step_ms, peak_gib=peak, busy_share=busy,
        host_ms_per_augmented_batch=data_ms, nms_per_step=nms_step,
        loss_first=float(hist[0]), loss_last=float(hist[-1]),
        steps=len(hist))
    del batches, host, step
    torch.cuda.empty_cache()

    # ---- 2. nucleus detect -> submit.csv, with the trained tensors
    icfg = nucleus.NucleusInferenceConfig()
    inf = MaskRCNN("inference", icfg, device=dev)
    inf.module.load_state_dict(model.module.state_dict())
    inf.module.to(dev)
    inf.initialized = True
    del model
    torch.cuda.empty_cache()
    made = []
    detect0 = inf.detect

    def recording(images, verbose=0):
        r = detect0(images, verbose)
        made.extend(r)
        return r
    inf.detect = recording
    inf.detect([ds.load_image(0)])                       # warm-up
    made.clear()
    t0 = time.time()
    path = counted("nucleus_detect", lambda: nucleus.detect(
        inf, os.path.join(work, "nuc"), "stage1_train",
        os.path.join(work, "nuc_out")))
    t_det = time.time() - t0
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0] == "ImageId,EncodedPixels", "submit.csv header")
    rows_by_image = {}
    for ln in lines[1:]:
        iid, enc = ln.split(",", 1)
        rows_by_image.setdefault(iid, []).append(enc.strip())
    n_lines, n_det = 0, 0
    for i, r in zip(ds.image_ids, made):
        iid = ds.image_info[i]["id"]
        masks, scores = r["masks"], r["scores"]
        n_det += masks.shape[-1]
        if masks.shape[-1] == 0:
            check(rows_by_image[iid] == [""], f"submit {iid}: empty")
            continue
        order = np.argsort(scores)[::-1] + 1
        m = np.max(masks * np.reshape(order, (1, 1, -1)), -1)
        check(len(rows_by_image[iid]) == len(order), f"submit {iid} lines")
        for enc, o in zip(rows_by_image[iid], order):
            check(np.array_equal(nucleus.rle_decode_kaggle(enc, m.shape),
                                 m == o), f"submit {iid}: a line does not "
                                          f"decode to its mask")
            n_lines += 1
    log(f"[samples] nucleus detect ({len(made)} images, pad64 512^2, up to "
        f"{icfg.DETECTION_MAX_INSTANCES} detections): {n_det} detections, "
        f"{n_lines} submit.csv lines, each decoding to its overlap-removed "
        f"mask; {t_det * 1e3 / len(made):.1f} ms an image incl. the RLE, "
        f"launches {by_path['nucleus_detect']}")
    summary["nucleus_detect"] = dict(images=len(made), detections=n_det,
                                     lines=n_lines,
                                     ms_per_image=t_det * 1e3 / len(made))
    del inf, made
    torch.cuda.empty_cache()

    # ---- 3. mini-COCO: the 120-image tree, the trained shapes model, f32
    mdir = os.path.join(work, "mini")
    mini_coco.make_mini_coco(mdir, MINI_COCO_IMAGES, 128, seed=0)
    mds = CocoDataset()
    mds.load_coco(mdir, "val", "2014")
    mds.prepare()

    class MiniF32(mini_coco.MiniCocoConfig):
        COMPUTE_DTYPE = "float32"
    m32 = MaskRCNN("inference", MiniF32(), device=dev).load_weights(trained)
    m32.detect([mds.load_image(0)])
    card = {}

    def get_result(i):
        card[i] = m32.detect([mds.load_image(i)])[0]
        return card[i]
    t0 = time.time()
    stats = counted("mini_coco", lambda: mini_coco.run_protocol(
        mds, get_result, verbose=False))
    t_mc = time.time() - t0
    ap50 = stats["bbox"]["ap50"]
    cpu = MaskRCNN("inference", MiniF32(), device="cpu").load_weights(trained)
    matched = n_cpu = 0
    t0 = time.time()
    for i in mds.image_ids[:10]:
        a = cpu.detect([mds.load_image(i)])[0]
        b = card[i]
        k, _ = match_detections(a["rois"], a["class_ids"], a["scores"],
                                b["rois"], b["class_ids"], b["scores"], 0.9)
        matched, n_cpu = matched + k, n_cpu + len(a["rois"])
    t_cpu = time.time() - t0
    frac = matched / max(n_cpu, 1)
    log(f"[samples] mini-COCO ({MINI_COCO_IMAGES} images, 128^2, f32): "
        f"bbox AP {stats['bbox']['ap']:.4f} AP50 {ap50:.4f} AP75 "
        f"{stats['bbox']['ap75']:.4f}; segm AP {stats['segm']['ap']:.4f} "
        f"AP50 {stats['segm']['ap50']:.4f} AP75 {stats['segm']['ap75']:.4f}; "
        f"compute_ap@50 {stats['compute_ap50_mean']:.4f}; {t_mc:.1f} s; box "
        f"match to the CPU plain path on 10 images {matched}/{n_cpu} = "
        f"{frac:.4f} ({t_cpu:.1f} s on the CPU); launches "
        f"{by_path['mini_coco']}")
    check(ap50 >= 0.85, f"mini-COCO bbox AP50 {ap50} < 0.85")
    if MINI_COCO_JAX_AP50 is not None:
        check(abs(ap50 - MINI_COCO_JAX_AP50) <= 0.02,
              f"mini-COCO bbox AP50 {ap50} vs the JAX package's "
              f"{MINI_COCO_JAX_AP50}")
    check(frac >= 0.9, f"mini-COCO card vs CPU box match {frac}")
    summary["mini_coco"] = dict(
        bbox={k: stats["bbox"][k] for k in ("ap", "ap50", "ap75")},
        segm={k: stats["segm"][k] for k in ("ap", "ap50", "ap75")},
        compute_ap50=stats["compute_ap50_mean"], seconds=t_mc,
        box_match_cpu=frac, jax_ap50=MINI_COCO_JAX_AP50)
    del cpu, card

    # ---- 5. the tracker's template match with the trained shapes model
    # (before balloon: it reuses the f32 model of 3)
    # committed scene 5 (a circle): the previous frame's crop is the
    # circle's box and 6 px around it, the new frame that scene shifted by
    # (3, -2) px
    img, gt_boxes = detect_scenes()[5][:2]
    y1, x1, y2, x2 = (int(v) for v in gt_boxes[0])
    y1, x1 = max(y1 - 6, 0), max(x1 - 6, 0)       # the shape and its edge
    y2, x2 = min(y2 + 6, img.shape[0]), min(x2 + 6, img.shape[1])
    prev = np.ascontiguousarray(img[y1:y2, x1:x2])
    nxt = np.ascontiguousarray(np.roll(img, (3, -2), (0, 1)))
    names = ["BG", "bottle", "cup", "vase"]
    res = {}
    cpu = MaskRCNN("inference", MiniF32(), device="cpu").load_weights(trained)
    for d, m in (("cpu", cpu), ("cuda", m32)):
        loc = mask_image.max_location(mask_image.match_template(
            nxt, prev, m.device))
        if d == "cuda":
            r = counted("tracker", lambda: mask_image.
                        template_match_mask_detect(m, nxt, prev, None,
                                                   names))
        else:
            r = mask_image.template_match_mask_detect(m, nxt, prev, None,
                                                      names)
        res[d] = (loc, r)
    (lc, rc), (lg, rg) = res["cpu"], res["cuda"]
    check(rc is not None and rg is not None, "tracker: no target found")
    check(lc == lg == (x1 - 2, y1 + 3),
          f"tracker location card {lg} vs CPU {lc}, shifted to "
          f"{(x1 - 2, y1 + 3)}")
    check(np.array_equal(rc["box"], rg["box"])
          and rc["class_id"] == rg["class_id"],
          f"tracker box card {rg['box']} vs CPU {rc['box']}")
    log(f"[samples] tracker: template of {prev.shape[:2]} found at {lg} on "
        f"the card and the CPU; box {rg['box'].tolist()} "
        f"({names[rg['class_id']]}, score {rg['score']:.4f}) equal; "
        f"launches {by_path['tracker']}")
    summary["tracker"] = dict(location=list(lg), box=rg["box"].tolist())
    del cpu, m32
    torch.cuda.empty_cache()

    # ---- 4. balloon: training steps at full width, then the splash
    bcfg, bds, _, binf = balloon_setup(os.path.join(work, "balloon"), 4, 0,
                                       False)
    bm = MaskRCNN("training", bcfg, device=dev)
    bm.init_params(0)
    splash_in = os.path.join(work, "balloon", "train", "b0.png")
    made = []

    def balloon_path():
        np.random.seed(0)
        hist = Trainer(bm, bcfg).train(bds, epochs=1, layers="all",
                                       steps_per_epoch=BALLOON_STEPS,
                                       checkpoint=False, verbose=0)
        inf = MaskRCNN("inference", binf, device=dev)
        inf.module.load_state_dict(bm.module.state_dict())
        inf.module.to(dev)
        inf.initialized = True
        detect0 = inf.detect
        inf.detect = lambda images, verbose=0: made.extend(
            detect0(images, verbose)) or made[-len(images):]
        out = balloon.detect_and_color_splash(inf, image_path=splash_in,
                                              out_dir=work)
        return hist, out
    t0 = time.time()
    bhist, out = counted("balloon", balloon_path)
    t_b = time.time() - t0
    check(np.isfinite(bhist).all(), f"balloon losses {bhist}")
    src = np.ascontiguousarray(read_png(splash_in)[:, :, ::-1])
    want = balloon.color_splash(src, made[0]["masks"])
    got = read_png(out)[:, :, ::-1]
    check(np.array_equal(got, want), "balloon splash PNG != color_splash")
    log(f"[samples] balloon: {BALLOON_STEPS} f32 steps (ResNet-101, 1024^2, "
        f"batch 2), mean loss {bhist[0]:.3f}, then the splash of "
        f"{os.path.basename(splash_in)} ({made[0]['masks'].shape[-1]} "
        f"detections) equal to color_splash; {t_b:.1f} s; launches "
        f"{by_path['balloon']}")
    summary["balloon"] = dict(loss=float(bhist[0]), seconds=t_b,
                              detections=int(made[0]["masks"].shape[-1]))
    del bm, made
    calls.close()
    torch.cuda.empty_cache()

    # ---- 6. the kernels at the samples' shapes against their plain
    # versions, timed, with bounds
    nms_rows, roi_rows = hold_captured(calls, "samples")
    del calls
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    summary["seconds"] = time.time() - t_phase
    log(f"[samples] phase took {summary['seconds']:.1f} s")
    return by_path, {"nms": nms_rows, "roi_align": roi_rows}, summary


SHARD_VOL = (512, 512, 512)    # the north-star volume, u16 histogram
SHARD_FRAMES = 8               # fused frames of hard_sequence (+ 1 init)
SHARD_RANKS = 2                # ranks on the one card, over gloo
# per-slab splat budgets of the sharded probe and the render: none may
# overflow at one rank, so that one rank and two fuse the same votes
SHARD_BUDGETS = dict(max_blocks=16384, max_rows=65536,
                     max_surface=1 << 22)
SHARD_ANGLE = 0.3              # the orbit view of the sharded render
DP_STEPS = 5                   # timed data-parallel steps after the check


def _span():
    """(start, stop, elapsed ms) of a span timed by CUDA events."""
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    return a.record, b.record, lambda: a.elapsed_time(b)


def _sha(t) -> str:
    """sha256 of a tensor's bytes, read back in 256 MiB pieces."""
    import hashlib
    import torch
    h = hashlib.sha256()
    flat = t.contiguous().view(torch.uint8).reshape(-1)
    step = 1 << 28
    for i in range(0, flat.numel(), step):
        h.update(flat[i:i + step].cpu().numpy().tobytes())
    return h.hexdigest()


def _state_digest(vol) -> dict:
    import torch
    return dict(sha256={f: _sha(getattr(vol, f))
                        for f in ("diff", "color", "weight", "hist")},
                fused_voxels=int((vol.weight > 0).sum()),
                hist_votes=int((vol.hist.to(torch.int32) & 0xFFFF)
                               .sum(dtype=torch.int64)))


def _shard_cfg(vol_dim):
    from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
    return FusionConfig(vol_dim=tuple(vol_dim), hist_dtype=np.uint16,
                        splat_max_blocks=SHARD_BUDGETS["max_blocks"],
                        splat_max_rows=SHARD_BUDGETS["max_rows"],
                        splat_max_surface=1 << 20)


def _stage(frames, dev):
    """frames[1:] as (depth, color, mask) on ``dev`` and each frame's
    extrinsic composed with the first frame's inverse."""
    import torch
    E0i = np.linalg.inv(frames[0]["extrinsic"]).astype(np.float32)
    return [(torch.from_numpy(f["depth"]).to(dev),
             torch.from_numpy(f["color"]).to(dev),
             torch.from_numpy(f["mask"]).to(dev),
             (f["extrinsic"] @ E0i).astype(np.float32))
            for f in frames[1:]]


def one_card_fusion(frames, K4, vol_dim, dev):
    """The port's one-card ``fusion_step`` with the splat probe in the
    sharded step's form (its budgets, no row cap) over the frames of
    ``sharded_fuse_rank``: the state's digest, the relabeled masks,
    num_objs and the misses."""
    import dataclasses
    import torch
    from slam_maskrcnn_tpu_torch.fusion.fuse import init_from_first_frame
    from slam_maskrcnn_tpu_torch.fusion.pipeline import fusion_step

    cfg = dataclasses.replace(_shard_cfg(vol_dim), probe_mode="splat",
                              splat_max_surface=SHARD_BUDGETS["max_surface"],
                              splat_row_cap=0)
    vol = init_from_first_frame(cfg, frames[0]["depth"], K4,
                                frames[0]["mean_depth"], device=dev)
    masks, misses = [], []
    for d, c, m, e in _stage(frames, dev):
        vol, mask_g, miss = fusion_step(vol, d, c, m, e, K4, cfg)
        masks.append(mask_g)
        misses.append(miss)
    out = dict(_state_digest(vol), masks=torch.stack(masks).cpu().numpy(),
               misses=[int(x) for x in misses], num_objs=int(vol.num_objs))
    del vol
    torch.cuda.empty_cache()
    return out


def sharded_fuse_rank(mesh, frames, K4, dist, vol_dim):
    """One rank of the volume-sharded fuse (also run by the parent on a
    mesh of one): this rank's slab of the ``vol_dim`` volume initialized
    from frames[0], the other frames fused through
    make_sharded_fusion_step with K1 launches counted from 0. The first
    two frames warm the process up. The next (frames - 3) / 2 run with
    every collective timed on the host between two synchronizations
    (``collective_ms`` and ``collective_calls`` a frame, and
    ``frame_ms_synced`` by CUDA events, which includes those
    synchronizations); the ones after them but the last are timed by
    CUDA events alone (``frame_ms``). The last one is untimed, and on a
    slab at x0 > 0 its K1 launch is held against the plain version
    (``fuse_frame_plain`` and ``brick_classes_plain`` at that x0, same
    parameters, on a copy of the slab taken before the launch);
    ``peak_gib`` is read before it. Then the sharded render of both
    modes, the slabs gathered on rank 0 and each field's sha256 there."""
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.fusion import fuse as fz
    from slam_maskrcnn_tpu_torch.fusion.splat import splat_render_orbit
    from slam_maskrcnn_tpu_torch.parallel import sharding as sh

    dev = mesh.device
    kernels.lib("fuse")                 # built by the parent: loaded here
    cfg = _shard_cfg(vol_dim)
    d0 = frames[0]["depth"]
    H, W = d0.shape
    full = fz.init_from_first_frame(cfg, d0, K4, frames[0]["mean_depth"],
                                    device=dev)
    vol = sh.shard_volume_state(full, mesh)
    del full
    torch.cuda.empty_cache()
    staged = _stage(frames, dev)
    step = sh.make_sharded_fusion_step(cfg, mesh, **SHARD_BUDGETS)
    coll = {"ms": 0.0, "calls": 0}
    orig = sh.all_reduce, sh.broadcast, fz._fuse_cuda
    held = {}

    def synced(fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(dev)
            coll["ms"] += (time.perf_counter() - t0) * 1e3
            coll["calls"] += 1
            return out
        return wrapped

    def fuse_held(vol, depth, color, mask, params, x0=0):
        """K1 on the slab, then the plain version on a copy taken before."""
        plain = vol.clone()
        cls_k = orig[2](vol, depth, color, mask, params, x0)
        fz.fuse_frame_plain(plain, depth, color, mask, params, x0=x0)
        cls_p = fz.brick_classes_plain(plain, params,
                                       *fz.depth_tiles_plain(depth), H, W,
                                       x0=x0)
        held.update(
            x0=x0, slab=list(vol.diff.shape),
            classes_equal=bool(torch.equal(cls_k, cls_p)),
            equal={f: bool(torch.equal(getattr(vol, f), getattr(plain, f)))
                   for f in ("color", "weight", "hist")},
            max_abs_err=float((vol.diff - plain.diff).abs().max()),
            fused=int((plain.weight > 0).sum()))
        del plain
        return cls_k

    x0 = mesh.rank * vol.diff.shape[0]
    # frames 0 and 1 warm the process up (frame 0 has nothing to probe,
    # so the probe and the collectives first run on frame 1); then n_sync
    # synced frames, the rest timed as they run, and the last one held
    # against the plain version
    n_sync = (len(staged) - 3) // 2
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    kernels.launches.reset()
    masks, misses, spans, synced_spans = [], [], [], []
    try:
        for i, (d, c, m, e) in enumerate(staged):
            last = i == len(staged) - 1
            if i == 2:
                sh.all_reduce, sh.broadcast = synced(orig[0]), synced(orig[1])
            if i == 2 + n_sync:
                sh.all_reduce, sh.broadcast = orig[:2]
            if last:
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if x0 > 0:
                    fz._fuse_cuda = fuse_held
            start, stop, ms = _span()
            start()
            vol, mask_g, miss = step(vol, d, c, m, e, K4)
            stop()
            if 2 <= i < 2 + n_sync:
                synced_spans.append(ms)
            elif 2 + n_sync <= i < len(staged) - 1:
                spans.append(ms)
            masks.append(mask_g)
            misses.append(miss)
        torch.cuda.synchronize(dev)
    finally:
        sh.all_reduce, sh.broadcast, fz._fuse_cuda = orig
    launches = dict(kernels.launches.counts)
    out = dict(rank=mesh.rank, x0=x0, frame_ms=[ms() for ms in spans],
               frame_ms_synced=[ms() for ms in synced_spans],
               launches=launches, collective_ms=coll["ms"] / n_sync,
               collective_calls=coll["calls"] / n_sync, peak_gib=peak,
               masks=torch.stack(masks).cpu().numpy(),
               misses=[int(x) for x in misses], held=held,
               num_objs=int(vol.num_objs), slab=tuple(vol.diff.shape))
    out["render"] = {mode: sh.make_sharded_render(
        cfg, mesh, SHARD_BUDGETS["max_blocks"], mode)(
            vol, SHARD_ANGLE, dist, K4, H, W).cpu().numpy()
        for mode in ("instance", "color")}
    if mesh.size == 1:
        out["orbit"] = {mode: splat_render_orbit(
            vol, SHARD_ANGLE, dist, K4, H, W, cfg, mode=mode).cpu().numpy()
            for mode in ("instance", "color")}
    whole = sh.gather_volume_state(vol, mesh)
    del vol
    torch.cuda.empty_cache()
    if whole is not None:
        out.update(_state_digest(whole))
    return out


DENSE_SHARD_VOL = (256, 256, 256)   # the dense path's volume, u32 histogram
DENSE_SHARD_FRAMES = 5         # fused frames of hard_sequence (+ 1 init)


def _slab_shas(vol, n: int) -> list:
    """sha256 of each field of each of ``n`` equal x-slabs of ``vol``."""
    X = vol.diff.shape[0] // n
    return [{f: _sha(getattr(vol, f)[r * X:(r + 1) * X])
             for f in ("diff", "color", "weight", "hist")} for r in range(n)]


def dense_sharded_rank(mesh, frames, K4, vol_dim):
    """One rank of the dense ("xla") volume-sharded step: this rank's slab
    of the ``vol_dim`` volume with a u32 histogram, initialized from
    frames[0], the other frames fused by ``make_sharded_fusion_step(...,
    backend="xla")``. Frames 0 and 1 warm up (the probe first runs on
    frame 1); from frame 2 on every collective is timed on the host
    between two synchronizations (``collective_ms`` and
    ``collective_calls`` a frame) and each frame by CUDA events
    (``frame_ms``, synchronizations included). Returns those, the peak
    memory, the relabeled masks, num_objs and the slab's sha256 per
    field."""
    import torch
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      init_from_first_frame)
    from slam_maskrcnn_tpu_torch.parallel import sharding as sh

    dev = mesh.device
    cfg = FusionConfig(vol_dim=tuple(vol_dim), hist_dtype=np.uint32)
    full = init_from_first_frame(cfg, frames[0]["depth"], K4,
                                 frames[0]["mean_depth"], device=dev)
    vol = sh.shard_volume_state(full, mesh)
    del full
    torch.cuda.empty_cache()
    staged = _stage(frames, dev)
    step = sh.make_sharded_fusion_step(cfg, mesh, backend="xla")
    coll = {"ms": 0.0, "calls": 0}
    orig = sh.all_reduce, sh.broadcast

    def synced(fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(dev)
            coll["ms"] += (time.perf_counter() - t0) * 1e3
            coll["calls"] += 1
            return out
        return wrapped

    torch.cuda.reset_peak_memory_stats(dev)
    masks, spans = [], []
    try:
        for i, (d, c, m, e) in enumerate(staged):
            if i == 2:
                sh.all_reduce, sh.broadcast = synced(orig[0]), synced(orig[1])
            start, stop, ms = _span()
            start()
            vol, mask_g, _ = step(vol, d, c, m, e, K4)
            stop()
            if i >= 2:
                spans.append(ms)
            masks.append(mask_g)
        torch.cuda.synchronize(dev)
    finally:
        sh.all_reduce, sh.broadcast = orig
    n = len(spans)
    return dict(rank=mesh.rank, x0=mesh.rank * vol.diff.shape[0],
                slab=list(vol.diff.shape), frame_ms=[ms() for ms in spans],
                collective_ms=coll["ms"] / n, collective_calls=coll["calls"]
                / n, peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                masks=torch.stack(masks).cpu().numpy(),
                num_objs=int(vol.num_objs), sha256=_slab_shas(vol, 1)[0])


def dense_sharded(dev, devices):
    """The dense ("xla") volume-sharded step at DENSE_SHARD_VOL over
    DENSE_SHARD_FRAMES hard_sequence frames at 480 x 640: one rank (the
    port's ``fusion_step_dense`` on the whole volume in this process,
    timed by CUDA events from frame 2 on) and SHARD_RANKS ranks on
    ``devices``. Each rank's slab must be sha256-equal to the one-rank
    state's planes, and the masks and num_objs equal; no rank ever holds
    more than its slab and one plane of the next. Returns the summary."""
    import torch
    from slam_maskrcnn_tpu_torch.data.synthetic import (hard_scene,
                                                        hard_sequence)
    from slam_maskrcnn_tpu_torch.fusion.pipeline import fusion_step_dense
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      init_from_first_frame,
                                                      make_intrinsic)
    from slam_maskrcnn_tpu_torch.parallel import launch

    t0 = time.time()
    K4 = make_intrinsic(*PIPE_K)
    Kinv = np.linalg.inv(K4).astype(np.float32)
    frames = hard_sequence(hard_scene(), K4, H, W,
                           n_frames=DENSE_SHARD_FRAMES + 1)
    cfg = FusionConfig(vol_dim=DENSE_SHARD_VOL, hist_dtype=np.uint32)
    st = init_from_first_frame(cfg, frames[0]["depth"], K4,
                               frames[0]["mean_depth"], device=dev)
    torch.cuda.reset_peak_memory_stats()
    masks, spans = [], []
    for i, (d, c, m, e) in enumerate(_stage(frames, dev)):
        start, stop, ms = _span()
        start()
        st, mask_g = fusion_step_dense(st, d, c, m, e, K4, Kinv, cfg)
        stop()
        if i >= 2:
            spans.append(ms)
        masks.append(mask_g)
    torch.cuda.synchronize()
    one = dict(frame_ms=float(np.mean([ms() for ms in spans])),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               masks=torch.stack(masks).cpu().numpy(),
               num_objs=int(st.num_objs),
               fused_voxels=int((st.weight > 0).sum()),
               hist_votes=int(st.hist.sum(dtype=torch.int64)),
               shas=_slab_shas(st, SHARD_RANKS))
    del st
    torch.cuda.empty_cache()            # the ranks need the card's memory
    outs = launch(dense_sharded_rank, SHARD_RANKS, devices=devices,
                  args=(frames, K4, DENSE_SHARD_VOL))
    for o in outs:
        check(o["sha256"] == one["shas"][o["rank"]],
              f"dense sharded step: rank {o['rank']}'s slab differs from "
              f"one rank's planes {o['sha256']} vs {one['shas'][o['rank']]}")
        check(np.array_equal(o["masks"], one["masks"])
              and o["num_objs"] == one["num_objs"],
              f"dense sharded step: rank {o['rank']}'s masks / num_objs "
              f"({o['num_objs']} vs {one['num_objs']})")
    check(one["num_objs"] >= 3 and one["fused_voxels"] > 100_000,
          f"dense sharded fixture: {one['num_objs']} ids, "
          f"{one['fused_voxels']} voxels")
    summary = dict(
        volume=list(DENSE_SHARD_VOL), hist="u32",
        frames=DENSE_SHARD_FRAMES, ranks=SHARD_RANKS,
        slab_sha256_equal=True, num_objs=one["num_objs"],
        fused_voxels=one["fused_voxels"], hist_votes=one["hist_votes"],
        one_rank=dict(ms_per_frame=one["frame_ms"],
                      peak_gib=one["peak_gib"]),
        per_rank=[dict(rank=o["rank"], slab=o["slab"], x0=o["x0"],
                       ms_per_frame=float(np.mean(o["frame_ms"])),
                       collective_ms_per_frame=o["collective_ms"],
                       collective_calls_per_frame=o["collective_calls"],
                       peak_gib=o["peak_gib"]) for o in outs],
        seconds=time.time() - t0)
    log("[sharded] dense (xla) step, " + json.dumps(summary))
    return summary


def dp_train_rank(mesh, batch, pos, neg, lr, steps):
    """One rank of the data-parallel training step (also run by the parent
    on a mesh of one): TrainShapesConfig in float32 with GPU_COUNT =
    mesh.size and IMAGES_PER_GPU = 8 / mesh.size, the zeroed-RPN init of
    ``train_phase``, one step of the global ``batch`` checked by the
    caller, then ``steps`` more timed by CUDA events with the NMS launches
    counted from 0."""
    import hashlib
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.parallel import shard_batch
    from slam_maskrcnn_tpu_torch.samples.train_shapes import TrainShapesConfig
    from slam_maskrcnn_tpu_torch.train.trainer import (BATCH_KEYS,
                                                       LAYER_REGEX, Trainer)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    kernels.lib("nms")
    cfg = type("DP", (TrainShapesConfig,), dict(
        COMPUTE_DTYPE="float32", GPU_COUNT=mesh.size,
        IMAGES_PER_GPU=8 // mesh.size))()
    m = MaskRCNN("training", cfg, device=dev)
    m.init_params(1)
    with torch.no_grad():
        for head in (m.module.rpn_model.rpn_class_raw,
                     m.module.rpn_model.rpn_bbox_pred):
            head.weight.zero_()
            head.bias.zero_()
        m.module.rpn_model.rpn_class_raw.bias[1::2] = torch.tensor(
            [1.0, 2.0, 0.0])
    step = Trainer(m, cfg).make_step(lr, LAYER_REGEX["all"], mesh)
    local = shard_batch(dict({k: batch[k] for k in BATCH_KEYS}, pos=pos,
                             neg=neg), mesh)
    p, n = local.pop("pos"), local.pop("neg")
    local["anchors"] = torch.from_numpy(get_anchors(
        cfg, cfg.IMAGE_SHAPE)).to(dev)
    loss, parts = step(local, p, n)
    params = {k: v.detach().cpu().numpy().copy()
              for k, v in m.module.named_parameters()}
    digest = hashlib.sha256(b"".join(params[k].tobytes()
                                     for k in sorted(params))).hexdigest()
    torch.cuda.synchronize(dev)
    kernels.launches.reset()
    start, stop, ms = _span()
    start()
    for _ in range(steps):
        step(local, p, n)
    stop()
    torch.cuda.synchronize(dev)
    return dict(rank=mesh.rank, loss=float(loss),
                parts={k: float(v) for k, v in parts.items()},
                params=params if mesh.rank == 0 else None, digest=digest,
                step_ms=ms() / steps,
                launches=dict(kernels.launches.counts))


def sharded_phase(dev):
    """Phase 8: the multi-rank paths of parallel/sharding.py, with
    SHARD_RANKS ranks on the one card over gloo (NCCL refuses two ranks on
    one device), spawned by ``launch`` after the parent built the kernels:

    1. the collectives the module uses (all_reduce SUM / MIN / MAX,
       broadcast) on CUDA f32, i32 and int16-as-bytes tensors over gloo;
    2. K1 on an x-slab at a nonzero x offset against its plain version
       and against the whole volume's launch (128^3, slab x 64..127);
    3. the volume-sharded fuse of SHARD_FRAMES hard_sequence frames into
       the 512^3 volume (K=32, u16) at one rank (this process) and at
       SHARD_RANKS ranks: the gathered state (diff, color, weight, hist)
       bit-equal by sha256, and so the relabeled masks, num_objs and the
       misses, both to each other and to the port's one-card
       ``fusion_step`` with the splat probe; K1 launched on every rank's
       slab, once a frame, and held against its plain version at the
       path's own shapes on the last rank's slab (x0 > 0, 480 x 640
       frame): color, weight, hist and the brick classes equal, diff
       within 2e-6; ms a frame per rank, the collectives' time and count a
       frame, peak memory per rank;
    4. the sharded render of that state, "instance" and "color": at most
       1% of pixels apart from the one-rank splat_render_orbit; then the
       dense ("xla") step sharded (``dense_sharded``: 256^3 with a u32
       histogram, the ray-march probe across the slabs), each rank's
       slab sha256-equal to one rank's ``fusion_step_dense``;
    5. the data-parallel training step (TrainShapesConfig, f32, TF32 off,
       the zeroed-RPN fixture of ``train_phase``) at 2 ranks of 4 images
       against one rank of 8: loss parts within 1e-3 relative, every
       updated parameter within 2e-6, both ranks' parameters equal; ms a
       step and the NMS kernel's launches per rank.

    Returns (launches by path, fuse row extras, summary)."""
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.data.dataset import data_generator
    from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset
    from slam_maskrcnn_tpu_torch.data.synthetic import (hard_scene,
                                                        hard_sequence)
    from slam_maskrcnn_tpu_torch.fusion import fuse as fz
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)
    from slam_maskrcnn_tpu_torch.models.targets import draw_target_noise
    from slam_maskrcnn_tpu_torch.parallel import launch, single_mesh
    from slam_maskrcnn_tpu_torch.samples.train_shapes import TrainShapesConfig

    t_phase = time.time()
    devices = ["cuda:0"] * SHARD_RANKS
    # ---- 1. the collectives on the card
    probe = launch(_collective_probe_rank, SHARD_RANKS, devices=devices)
    log(f"[sharded] gloo on {dev}: {probe[0]}")

    # ---- 2. K1 on a slab at x0 = 64
    K4 = make_intrinsic(*PIPE_K)
    frames = hard_sequence(hard_scene(), K4, H, W, n_frames=SHARD_FRAMES + 1)
    cfg_s = FusionConfig(vol_dim=(128,) * 3)
    f0 = frames[0]
    whole = fz.init_from_first_frame(cfg_s, f0["depth"], K4,
                                     f0["mean_depth"], device=dev)
    E0i = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    fr = frames[3]
    d, c, m = (torch.from_numpy(fr[k]).to(dev)
               for k in ("depth", "color", "mask"))
    p = fz.fuse_params(whole, (fr["extrinsic"] @ E0i).astype(np.float32),
                       K4, cfg_s)
    slab = fz.init_state(FusionConfig(vol_dim=(64, 128, 128)),
                         whole.vol_start, whole.vol_end, device=dev)
    slab.voxel, slab.mu = whole.voxel, whole.mu
    slab.diff.fill_(float(whole.mu))
    plain = slab.clone()
    fz._fuse_cuda(whole, d, c, m, p)
    cls_k = fz._fuse_cuda(slab, d, c, m, p, x0=64)
    fz.fuse_frame_plain(plain, d, c, m, p, x0=64)
    cls_p = fz.brick_classes_plain(plain, p, *fz.depth_tiles_plain(d),
                                   H, W, x0=64)
    torch.cuda.synchronize()
    check(torch.equal(cls_k, cls_p), "slab x0 64: brick classes != plain")
    for f in ("diff", "color", "weight", "hist"):
        check(torch.equal(getattr(slab, f), getattr(whole, f)[64:]),
              f"slab x0 64 {f}: != the whole volume's launch")
        if f != "diff":
            check(torch.equal(getattr(slab, f), getattr(plain, f)),
                  f"slab x0 64 {f}: kernel != plain")
    x0_err = float((slab.diff - plain.diff).abs().max())
    check(x0_err <= 2e-6, f"slab x0 64 diff err {x0_err}")
    n_upd = int((slab.weight > 0).sum())
    check(n_upd > 0, "slab x0 64: nothing fused")
    log(f"[sharded] K1 at x0 64 on a 64x128x128 slab: bit-equal to the "
        f"whole 128^3 launch's planes 64..127, == plain (max |diff| "
        f"{x0_err:.3e}), classes == plain, {n_upd} voxels fused")
    del whole, slab, plain

    # ---- 3-4. the sharded fuse and render, one rank then SHARD_RANKS
    dist = float(f0["mean_depth"])
    t0 = time.time()
    one = sharded_fuse_rank(single_mesh(dev), frames, K4, dist, SHARD_VOL)
    t_one = time.time() - t0
    torch.cuda.empty_cache()
    log(f"[sharded] one rank: {np.mean(one['frame_ms']):.2f} ms a frame, "
        f"peak {one['peak_gib']:.2f} GiB, misses {one['misses']}, "
        f"{one['num_objs']} ids, {t_one:.1f} s")
    card = one_card_fusion(frames, K4, SHARD_VOL, dev)
    torch.cuda.empty_cache()            # the ranks need the card's memory
    check(card["sha256"] == one["sha256"],
          f"sharded fuse on one rank: the state differs from fusion_step's "
          f"{one['sha256']} vs {card['sha256']}")
    check(np.array_equal(card["masks"], one["masks"])
          and card["misses"] == one["misses"]
          and card["num_objs"] == one["num_objs"],
          f"sharded fuse on one rank: masks / misses / num_objs differ from "
          f"fusion_step's ({card['misses']}, {card['num_objs']})")
    log(f"[sharded] one rank == fusion_step (splat probe): state sha256, "
        f"masks, misses {card['misses']}, {card['num_objs']} ids")
    t0 = time.time()
    outs = launch(sharded_fuse_rank, SHARD_RANKS, devices=devices,
                  args=(frames, K4, dist, SHARD_VOL))
    t_many = time.time() - t0
    lead = outs[0]
    check(all(x == 0 for x in one["misses"]),
          f"sharded fuse: one rank overflowed its budgets {one['misses']}")
    check(lead["sha256"] == one["sha256"],
          f"sharded fuse: the gathered state differs from one rank's "
          f"{lead['sha256']} vs {one['sha256']}")
    for o in outs:
        check(np.array_equal(o["masks"], one["masks"]),
              f"sharded fuse: rank {o['rank']}'s masks differ")
        check(o["misses"] == one["misses"] and o["num_objs"] ==
              one["num_objs"], f"sharded fuse: rank {o['rank']} misses / "
              f"num_objs {o['misses']} {o['num_objs']}")
        check(o["launches"]["fuse"] == SHARD_FRAMES,
              f"sharded fuse: rank {o['rank']} K1 launches "
              f"{o['launches']}")
    held = outs[-1]["held"]
    check(held.get("x0", 0) > 0 and held["classes_equal"]
          and all(held["equal"].values()) and held["max_abs_err"] <= 2e-6
          and held["fused"] > 0,
          f"sharded fuse: K1 against plain on rank {SHARD_RANKS - 1}'s slab "
          f"{held}")
    log(f"[sharded] K1 at x0 {held['x0']} on the {held['slab']} slab, "
        f"{H}x{W} frame: color / weight / hist / classes == plain, max "
        f"|diff| {held['max_abs_err']:.3e}, {held['fused']} voxels fused")
    check(one["num_objs"] >= 3 and one["fused_voxels"] > 1_000_000,
          f"sharded fuse fixture: {one['num_objs']} ids, "
          f"{one['fused_voxels']} voxels")
    render = {}
    for mode in ("instance", "color"):
        ref = one["orbit"][mode]
        for o in outs:
            check(np.array_equal(o["render"][mode], lead["render"][mode]),
                  f"sharded render {mode}: ranks disagree")
        diff = float((lead["render"][mode] != ref).any(-1).mean())
        lit = float((ref.sum(-1) > 0).mean())
        check(diff <= 0.01 and lit > 0.05,
              f"sharded render {mode}: {diff:.4f} of pixels differ, "
              f"{lit:.3f} lit")
        render[mode] = dict(differ=diff, lit=lit)
    fuse_summary = dict(
        volume=list(SHARD_VOL), frames=SHARD_FRAMES, ranks=SHARD_RANKS,
        state_sha256_equal=True, equal_to_fusion_step=True,
        num_objs=one["num_objs"], fused_voxels=one["fused_voxels"],
        misses=one["misses"], kernel_vs_plain=held,
        one_rank=dict(ms_per_frame=float(np.mean(one["frame_ms"])),
                      ms_per_frame_synced=float(np.mean(
                          one["frame_ms_synced"])),
                      collective_ms_per_frame=one["collective_ms"],
                      collective_calls_per_frame=one["collective_calls"],
                      peak_gib=one["peak_gib"], launches=one["launches"]),
        per_rank=[dict(rank=o["rank"], slab=list(o["slab"]), x0=o["x0"],
                       ms_per_frame=float(np.mean(o["frame_ms"])),
                       ms_per_frame_synced=float(np.mean(
                           o["frame_ms_synced"])),
                       collective_ms_per_frame=o["collective_ms"],
                       collective_calls_per_frame=o["collective_calls"],
                       peak_gib=o["peak_gib"], launches=o["launches"])
                  for o in outs],
        render=render, seconds_one=t_one, seconds_spawned=t_many)
    log(f"[sharded] fuse {SHARD_VOL}, " + json.dumps(fuse_summary))

    # ---- 4b. the dense ("xla") step sharded, u32 histogram
    dense_summary = dense_sharded(dev, devices)

    # ---- 5. the data-parallel training step
    cfg = TrainShapesConfig()
    ds = ShapesDataset()
    ds.load_shapes(64, 128, 128, seed=0)
    ds.prepare()
    np.random.seed(0)
    batch = next(data_generator(ds, cfg, seed=0))
    g = torch.Generator().manual_seed(5)
    pos, neg = draw_target_noise(8, cfg.POST_NMS_ROIS_TRAINING, g, "cpu")
    one_dp = dp_train_rank(single_mesh(dev), batch, pos, neg, TRAIN_LR,
                           DP_STEPS)
    dp = launch(dp_train_rank, SHARD_RANKS, devices=devices,
                args=(batch, pos, neg, TRAIN_LR, DP_STEPS))
    check(all(o["digest"] == dp[0]["digest"] for o in dp),
          "data-parallel step: the ranks' parameters differ")
    rel = {k: abs(dp[0]["parts"][k] - v) / max(abs(v), 1e-12)
           for k, v in one_dp["parts"].items()}
    check(all(r <= 1e-3 for r in rel.values()),
          f"data-parallel step: loss parts {dp[0]['parts']} vs one rank "
          f"{one_dp['parts']}")
    check(one_dp["parts"]["mrcnn_mask_loss"] > 0,
          f"data-parallel fixture: positive rois {one_dp['parts']}")
    p_err = max(float(np.abs(dp[0]["params"][k] - v).max())
                for k, v in one_dp["params"].items())
    check(p_err <= 2e-6, f"data-parallel step: parameters differ by {p_err}")
    for o in dp:
        check(o["launches"]["nms"] == DP_STEPS,
              f"data-parallel step: rank {o['rank']} NMS launches "
              f"{o['launches']}")
    dp_summary = dict(
        ranks=SHARD_RANKS, images_per_rank=8 // SHARD_RANKS,
        loss=dp[0]["loss"], loss_one_rank=one_dp["loss"],
        parts_rel_err=max(rel.values()), params_max_abs_err=p_err,
        step_ms_one_rank=one_dp["step_ms"],
        per_rank=[dict(rank=o["rank"], step_ms=o["step_ms"],
                       launches=o["launches"]) for o in dp])
    log("[sharded] data-parallel step, " + json.dumps(dp_summary))
    paths = {"sharded_fuse": _sum_launches(outs),
             "dp_train": _sum_launches(dp)}
    log(f"[sharded] phase {time.time() - t_phase:.1f} s")
    return (paths, dict(slab_x0_max_abs_err=x0_err,
                        sharded_slab_max_abs_err=held["max_abs_err"],
                        sharded_slab=dict(x0=held["x0"],
                                          shape=held["slab"])),
            dict(probe=probe[0], fuse=fuse_summary, dense=dense_summary,
                 dp=dp_summary))


SFM_SEED = 11
PM_SMALL = (120, 160)          # PatchMatch held card against CPU
PM_BIG = (480, 640)            # PatchMatch timed at a TUM frame's size
PM_SHIFT = 6                   # the pairs' disparity, px


def _texture(rng, h: int, w: int) -> np.ndarray:
    """A smooth random f32 texture in [0, 255]: uniform noise blurred by
    two passes of the binomial [1, 4, 6, 4, 1] / 16 per axis (wrapping)."""
    t = rng.random((h, w)) * 255.0
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for _ in range(2):
        for ax in (0, 1):
            t = sum(k[i] * np.roll(t, i - 2, axis=ax) for i in range(5))
    return t.astype(np.float32)


def sfm_phase(dev):
    """Phase 9: sfm/ on the card.

    1. PatchMatch (patch 5, max_disp 16, 4 iterations, seed 0) on a
       120 x 160 pair shifted by PM_SHIFT px, on the card and on the CPU:
       ``disp`` within 1e-3 px on at least 99% of pixels, finite and
       positive (the share within 0.5 px of the shift is recorded: the
       reference's 4 iterations do not converge at this size); then a
       480 x 640 pair (patch 5, max_disp 48, 5 iterations) timed alone on
       the card.
    2. ``slam_two_view`` on the card against its CPU run
       (``two_view_check``), with its stage times.

    Returns the summary."""
    import torch
    from slam_maskrcnn_tpu_torch.sfm import PatchMatch

    t_phase = time.time()
    rng = np.random.default_rng(SFM_SEED)
    out = {}
    right = _texture(rng, *PM_SMALL)
    left = np.roll(right, PM_SHIFT, axis=1)
    t0 = time.time()
    card = PatchMatch(left, right, patch=5, max_disp=16, seed=0,
                      device=dev).run(4).cpu().numpy()
    t_card = time.time() - t0
    t0 = time.time()
    cpu = PatchMatch(left, right, patch=5, max_disp=16, seed=0,
                     device="cpu").run(4).numpy()
    t_cpu = time.time() - t0
    share = float((np.abs(card - cpu) <= 1e-3).mean())
    check(share >= 0.99, f"PatchMatch card vs CPU: {share:.4f} of pixels "
          f"within 1e-3 px")
    check(bool(np.isfinite(card).all()) and card.min() > 0,
          "PatchMatch: disparities not finite and positive")
    out["patchmatch_small"] = dict(
        shape=list(PM_SMALL), share_within_1e3=share,
        equal=float((card == cpu).mean()),
        median_disp=float(np.median(card[10:-10, 20:-10])),
        share_within_half_px_of_shift=float(
            (np.abs(card[10:-10, 20:-10] - PM_SHIFT) < 0.5).mean()),
        seconds_card=t_card, seconds_cpu=t_cpu)
    right = _texture(rng, *PM_BIG)
    left = np.roll(right, PM_SHIFT, axis=1)
    pm = PatchMatch(left, right, patch=5, max_disp=48, seed=0, device=dev)
    torch.cuda.synchronize()
    start, stop, ms = _span()
    start()
    disp = pm.run(5)
    stop()
    torch.cuda.synchronize()
    check(tuple(disp.shape) == PM_BIG and bool(torch.isfinite(disp).all())
          and float(disp.min()) > 0,
          "PatchMatch 480x640: disparities not finite and positive")
    out["patchmatch_big"] = dict(
        shape=list(PM_BIG), patch=5, max_disp=48, iters=5, ms=ms(),
        median_disp=float(disp[10:-10, 60:-10].median()))
    out["two_view"] = two_view_check(dev)
    out["seconds"] = time.time() - t_phase
    log("[sfm] " + json.dumps(out))
    return out


def _pair_keypoints(ka, kb) -> float:
    """The share of ``ka``'s keypoints with a keypoint of ``kb`` of the
    same octave and ``pt`` within 0.01 px."""
    from scipy.spatial import cKDTree
    if not len(ka["pt"]):
        return 0.0
    tree = cKDTree(kb["pt"])
    hits = tree.query_ball_point(ka["pt"], r=0.01, p=np.inf)
    octa, octb = ka["octave"] & 255, kb["octave"] & 255
    return float(np.mean([any(octb[j] == octa[i] for j in h)
                          for i, h in enumerate(hits)]))


def _deg(Ra, Rb) -> float:
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def _tdeg(a, b) -> float:
    a, b = np.ravel(a) / np.linalg.norm(a), np.ravel(b) / np.linalg.norm(b)
    return float(np.degrees(np.arccos(np.clip(abs(a @ b), -1, 1))))


def two_view_check(dev):
    """``slam_two_view`` on the 480 x 640 three-plane scene (sfm/scene.py,
    seed SFM_SEED), on the card (a warm-up run, then one with a stage
    time after each mark: host clock around a synchronization) and on the
    CPU: at least 99% of the CPU's keypoints paired on the card (same
    octave, pt within 0.01 px), R and t within 0.1 degree of the CPU's,
    the ground truth within 1 and 2 degrees, the card's warps bit-equal
    to the CPU's on the same homographies and SGBM bit-equal to the CPU's
    on the card's rectified pair."""
    import torch
    from slam_maskrcnn_tpu_torch.ops.sgbm import sgbm_disparity
    from slam_maskrcnn_tpu_torch.ops.warp import warp_perspective
    from slam_maskrcnn_tpu_torch.sfm import slam_two_view
    from slam_maskrcnn_tpu_torch.sfm.scene import two_view_scene

    img1, img2, K, R, t = two_view_scene(SFM_SEED)
    slam_two_view(img1, img2, K, device=dev, seed=SFM_SEED)
    stages, last = {}, [0.0]

    def mark(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[stage] = (now - last[0]) * 1e3
        last[0] = now

    torch.cuda.synchronize()
    last[0] = t0 = time.perf_counter()
    card = slam_two_view(img1, img2, K, device=dev, seed=SFM_SEED,
                         mark=mark)
    total = (time.perf_counter() - t0) * 1e3
    t0 = time.time()
    cpu = slam_two_view(img1, img2, K, device="cpu", seed=SFM_SEED)
    t_cpu = time.time() - t0
    paired = [_pair_keypoints(c, g) for c, g in zip(cpu["keypoints"],
                                                    card["keypoints"])]
    check(min(paired) >= 0.99, f"two-view SIFT: card pairs {paired} of the "
          f"CPU's keypoints")
    dR, dt = _deg(card["R"], cpu["R"]), _tdeg(card["t"], cpu["t"])
    check(dR <= 0.1 and dt <= 0.1, f"two-view pose: card vs CPU R {dR:.4f}, "
          f"t {dt:.4f} degrees")
    gR, gt = _deg(card["R"], R), _tdeg(card["t"], t)
    check(gR <= 1.0 and gt <= 2.0, f"two-view pose vs ground truth: R "
          f"{gR:.4f}, t {gt:.4f} degrees")
    check("disparity" in card, "two-view: the rectification failed")
    r1, r2 = card["rectified"]
    H1, H2 = card["homographies"]
    size = (img1.shape[1], img1.shape[0])
    for r, img, Hm in ((r1, img1, H1), (r2, img2, H2)):
        check(torch.equal(r.cpu(), warp_perspective(torch.from_numpy(img),
                                                    Hm, size)),
              "two-view: warpPerspective card != CPU")
    d_cpu = sgbm_disparity(r1.cpu(), r2.cpu())
    d_card = (card["disparity"] * 16).to(torch.int16).cpu()
    check(torch.equal(d_card, d_cpu), "two-view: SGBM card != CPU on the "
          "same rectified pair")
    valid = float((d_cpu >= 0).float().mean())
    check(valid > 0.3, f"two-view: {valid:.3f} of the disparity valid")
    res = dict(shape=list(img1.shape), matches=len(card["matches"][0]),
               votes=card["positive_depth_votes"], keypoints_paired=paired,
               keypoints=[len(k["pt"]) for k in card["keypoints"]],
               card_vs_cpu_deg=dict(R=dR, t=dt),
               ground_truth_deg=dict(R=gR, t=gt),
               disparity_valid=valid, sgbm_bit_equal=True,
               warps_bit_equal=True, stage_ms=stages, total_ms=total,
               seconds_cpu=t_cpu)
    log("[sfm] two-view " + json.dumps(res))
    return res


VIZ_SIZES = ((480, 640), (1024, 1024))   # the JPEG corpus's images
VIZ_REPS = 3                   # timed decodes of each JPEG, the median kept
VIZ_VIDEO = (8, 480, 640)      # frames, height, width of the splash video
VIZ_FPS = 12.5


def _viz_photo(h, w, seed):
    """A seeded photo-like BGR image: smooth colour fields, a few hard
    shapes (data/draw.py) and sensor noise."""
    from slam_maskrcnn_tpu_torch.data import draw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    f = [rng.uniform(20, 90) for _ in range(6)]
    img = np.stack([128 + 80 * np.sin(xx / f[c] + c) * np.cos(yy / f[c + 3])
                    for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    for _ in range(6):
        c = tuple(int(v) for v in rng.integers(0, 256, 3))
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        r = int(rng.integers(h // 20, h // 6))
        if rng.random() < 0.5:
            draw.circle(img, (x, y), r, c)
        else:
            draw.rectangle(img, (x - r, y - r // 2), (x + r, y + r // 2), c)
    return img


def _shapes_frame(h, w, k, seed=5):
    """Frame k of the splash video: three large shapes (a square, a circle,
    a triangle, as the shapes dataset draws them) drifting over a flat
    ground, in colours away from saturation, BGR."""
    from slam_maskrcnn_tpu_torch.data import draw
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = rng.integers(40, 216, 3)
    for j, kind in enumerate(("square", "circle", "triangle")):
        c = tuple(int(v) for v in rng.integers(40, 216, 3))
        s = int(rng.integers(h // 10, h // 6))
        x = int(w * (0.2 + 0.3 * j) + 6 * k)
        y = int(h * 0.5 + (j - 1) * h * 0.22)
        if kind == "square":
            draw.rectangle(img, (x - s, y - s), (x + s, y + s), c)
        elif kind == "circle":
            draw.circle(img, (x, y), s, c)
        else:
            pts = np.array([[x, y - s], [x - s, y + s], [x + s, y + s]])
            draw.fill_poly(img, pts, c)
    return img


def _png_file(s, depth, ctype, interlace=False, plte=None, trns=None):
    """A PNG of samples s [H, W, ch] (u8 or u16) over zlib, rows with
    filter type 0, optionally Adam7-interlaced."""
    import struct
    import zlib
    from slam_maskrcnn_tpu_torch.data.png import ADAM7, SIGNATURE, chunk

    def rows(p):
        h, w, ch = p.shape
        if depth == 16:
            raw = p.astype(">u2").view(np.uint8).reshape(h, -1)
        elif depth == 8:
            raw = p.reshape(h, -1)
        else:
            bits = np.unpackbits(p.reshape(h, w * ch, 1), axis=2)
            raw = np.packbits(bits[:, :, 8 - depth:].reshape(h, -1), axis=1)
        return np.concatenate([np.zeros((h, 1), np.uint8), raw], 1).tobytes()
    passes = [(0, 0, 1, 1)] if not interlace else ADAM7
    data = b"".join(rows(s[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                    if s[y0::dy, x0::dx].size)
    h, w = s.shape[:2]
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                 ctype, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(data, 1)) + chunk(b"IEND", b"")


def _png_kinds(h, w, seed=7):
    """The PNG kinds beyond u8 gray / BGR and u16 gray: name
    -> (bytes, channels at IMREAD_UNCHANGED, 16-bit)."""
    rng = np.random.default_rng(seed)

    def u8(ch, top=255):
        return rng.integers(0, top + 1, (h, w, ch)).astype(np.uint8)

    def u16(ch):
        return rng.integers(0, 65536, (h, w, ch)).astype(np.uint16)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    return {
        "gray1": (_png_file(u8(1, 1), 1, 0), 1, False),
        "gray4": (_png_file(u8(1, 15), 4, 0), 1, False),
        "palette4_trns": (_png_file(u8(1, 15), 4, 3, plte=pal,
                                    trns=bytes(range(0, 160, 10))), 4,
                          False),
        "gray_alpha8": (_png_file(u8(2), 8, 4), 4, False),
        "rgb16": (_png_file(u16(3), 16, 2), 3, True),
        "rgba16": (_png_file(u16(4), 16, 6), 4, True),
        "adam7_rgb8": (_png_file(u8(3), 8, 2, interlace=True), 3, False),
    }


def _ink_outside(base, comp, dets, names, H, W):
    """Pixels drawn by display_instances' boxes and captions (comp against
    the boxless composite base) outside every detection's outline band
    and caption band, and the detections whose bands hold no ink."""
    ink = (comp != base).any(-1)
    allowed = np.zeros((H, W), bool)
    empty = []
    for i, (y1, x1, y2, x2) in enumerate(dets["rois"].astype(int)):
        band = np.zeros((H, W), bool)
        band[max(y1 - 2, 0):y2 + 3, max(x1 - 2, 0):x2 + 3] = True
        band[y1 + 2:max(y2 - 1, y1 + 2), x1 + 2:max(x2 - 1, x1 + 2)] = False
        cap = f"{names[dets['class_ids'][i]]} {dets['scores'][i]:.3f}"
        base_y = max(y1 - 4, 10)
        band[max(base_y - 11, 0):base_y + 4,
             max(x1 - 1, 0):x1 + 11 * len(cap) + 2] = True
        if not (ink & band).any():
            empty.append(i)
        allowed |= band
    return int((ink & ~allowed).sum()), empty


def viz_phase(dev):
    """Phase 10: JPEG and MJPEG-AVI I/O, the captions and the demo on the
    card (``viz_phase``).

    (a) a seeded corpus made by the port's encoder (on the card, its
        bytes equal to the CPU encoder's): VIZ_SIZES at 4:2:0 / 4:2:2 /
        4:4:4 / gray, 4:2:0 with restart markers, and progressive; each
        decoded on the card and on the CPU, bit-equal; ms per image split
        into host entropy decoding and device pixel stages; then a 480x640
        Adobe CMYK JPEG (the port's writer) and the same file as YCCK,
        and the PNG kinds of ``_png_kinds``, read by ``imread`` on the
        card and on the CPU at cv2's flags: equal, in cv2's dtypes and
        shapes; ms a read;
    (b) ``samples/demo.main`` on three of those JPEGs at full
        CocoInferenceConfig width (ResNet-101, 1024^2, 81 classes),
        seeded weights: ms per image by stage (read, detect, composite,
        write); each written _det.png reads back equal to the composite;
        the NMS and ROIAlign launches of its detects counted (path
        "demo");
    (c) ``display_instances`` with captions on the trained shapes
        detector's card detections (weights/shapes_r2_f16.h5, the 20
        committed scenes): every detection's outline and caption ink
        lies in its box's outline and caption bands, and each band has
        ink; then captions beyond ASCII ("cafe" with its accent, Cyrillic
        "zhe", the CJK "person") drawn with a JPEG ``save_path`` encoded
        on the card: composite and bytes equal to the CPU's;
    (d) ``balloon.detect_and_color_splash(video_path=...)`` with the
        trained shapes detector on a VIZ_VIDEO MJPEG AVI written by the
        port (path "balloon_video"): the output's frame count, size and
        fps equal the input's; each output frame is the port's JPEG of
        ``color_splash`` of its decoded input frame under that frame's
        masks, byte for byte, and within PSNR 35 dB of that splash; ms
        per frame;
    then the NMS and ROIAlign kernels at these paths' shapes against
    their plain versions.

    Returns (launches by path, {"nms": extra, "roi_align": extra},
    summary)."""
    import os
    import shutil
    import torch
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.data import avi, jpeg
    from slam_maskrcnn_tpu_torch.data.image_io import imread
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.samples import balloon, demo
    from slam_maskrcnn_tpu_torch.samples.train_shapes import (
        InferenceShapesConfig, detect_scenes)
    from slam_maskrcnn_tpu_torch.viz.visualize import display_instances

    t_phase = time.time()
    jpeg.native()
    log(f"[viz] host library (csrc/jpeg.cpp) built and "
        f"loaded in {time.time() - t_phase:.1f} s")
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "viz")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    by_path, summary = {}, {}

    def counted(path, fn):
        torch.cuda.synchronize()
        kernels.launches.reset()
        out = fn()
        torch.cuda.synchronize()
        by_path[path] = dict(kernels.launches.counts)
        return out

    # ---- (a) the corpus: encoded on the card, decoded on card and CPU
    corpus = []
    for k, (h, w) in enumerate(VIZ_SIZES):
        img = _viz_photo(h, w, 100 + k)
        for name, kw in (("420", {}), ("422", dict(sampling="422")),
                         ("444", dict(sampling="444")), ("gray", {}),
                         ("420_rst", dict(restart_interval=4)),
                         ("progressive", dict(progressive=True))):
            src = img[..., 1].copy() if name == "gray" else img
            t0 = time.perf_counter()
            data = jpeg.encode(src, quality=95, device=dev, **kw)
            t_enc = (time.perf_counter() - t0) * 1e3
            check(data == jpeg.encode(src, quality=95, device="cpu", **kw),
                  f"jpeg {h}x{w} {name}: card encoder bytes != CPU's")
            path = os.path.join(work, f"img_{h}x{w}_{name}.jpg")
            with open(path, "wb") as f:
                f.write(data)
            corpus.append((f"{h}x{w}_{name}", path, data, t_enc))
    jpeg.decode(corpus[0][2], dev)                         # warm-up
    rows = {}
    for name, path, data, t_enc in corpus:
        card = jpeg.decode(data, dev).cpu()
        cpu = jpeg.decode(data, "cpu")
        check(torch.equal(card, cpu), f"jpeg {name}: card decode != CPU")
        host, pix = [], []
        for _ in range(VIZ_REPS):
            _, t_h, t_p = jpeg.decode_timed(data, dev)
            host.append(t_h * 1e3)
            pix.append(t_p * 1e3)
        rows[name] = dict(bytes=len(data), encode_ms=t_enc,
                          entropy_ms=float(np.median(host)),
                          pixel_ms=float(np.median(pix)))
        log(f"[viz] jpeg {name}: {len(data)} bytes, card == CPU; decode "
            f"{rows[name]['entropy_ms']:.2f} ms host entropy + "
            f"{rows[name]['pixel_ms']:.2f} ms device pixel stages; encode "
            f"{t_enc:.1f} ms")
    summary["jpeg"] = rows

    # ---- (a') four-component JPEGs (CMYK by the port's Adobe writer, the
    # same file as YCCK) and the PNG kinds through imread, card == CPU
    h, w = VIZ_SIZES[0]
    photo = _viz_photo(h, w, 100)
    cmyk = np.concatenate([255 - photo, photo.min(-1, keepdims=True)], -1)
    blob = jpeg.encode_cmyk(cmyk, quality=95, device=dev)
    check(blob == jpeg.encode_cmyk(cmyk, quality=95, device="cpu"),
          "cmyk encoder: card bytes != CPU's")
    at = blob.index(b"Adobe") + 11                  # the transform byte
    four = (("cmyk", blob), ("ycck", blob[:at] + b"\x02" + blob[at + 1:]))
    for name, data in four:
        path = os.path.join(work, f"img_{h}x{w}_{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        for flags in (1, 0, -1):
            card = imread(path, flags, device=dev)
            check(card is not None and card.shape == ((h, w) if flags == 0
                                                      else (h, w, 3))
                  and np.array_equal(card, imread(path, flags, device="cpu")),
                  f"jpeg {name} flags {flags}: card != CPU")
        host, pix = [], []
        for _ in range(VIZ_REPS):
            _, t_h, t_p = jpeg.decode_timed(data, dev)
            host.append(t_h * 1e3)
            pix.append(t_p * 1e3)
        rows[f"{h}x{w}_{name}"] = dict(bytes=len(data),
                                       entropy_ms=float(np.median(host)),
                                       pixel_ms=float(np.median(pix)))
        log(f"[viz] jpeg {h}x{w} {name} (4 components, 4:4:4): {len(data)} "
            f"bytes, imread card == CPU at flags 1, 0, -1; decode "
            f"{rows[f'{h}x{w}_{name}']['entropy_ms']:.2f} ms host entropy + "
            f"{rows[f'{h}x{w}_{name}']['pixel_ms']:.2f} ms device pixel "
            f"stages (4:4:4 three components: "
            f"{rows[f'{h}x{w}_444']['pixel_ms']:.2f})")
    for name, (data, ch, deep) in _png_kinds(h, w).items():
        path = os.path.join(work, f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        d16 = np.uint16 if deep else np.uint8
        for flags, shape, dtype in (
                (1, (h, w, 3), np.uint8), (0, (h, w), np.uint8),
                (2, (h, w), d16), (-1, (h, w) + ((ch,) if ch > 1 else ()),
                                   d16)):
            card = imread(path, flags, device=dev)
            got = None if card is None else (card.dtype, card.shape)
            check(got == (dtype, shape) and np.array_equal(
                card, imread(path, flags, device="cpu")),
                f"png {name} flags {flags}: {got}, not {dtype} {shape}, or "
                f"card != CPU")
        t = []
        for _ in range(VIZ_REPS):
            t0 = time.perf_counter()
            imread(path, device=dev)
            t.append((time.perf_counter() - t0) * 1e3)
        rows[f"{h}x{w}_png_{name}"] = dict(bytes=len(data),
                                           read_ms=float(np.median(t)))
    log(f"[viz] PNG kinds {h}x{w} through imread (flags 1, 0, 2, -1: cv2's "
        f"dtypes and shapes, card == CPU), ms a read at IMREAD_COLOR: "
        + ", ".join(f"{k[len(f'{h}x{w}_png_'):]} {v['read_ms']:.2f}"
                    for k, v in rows.items() if "_png_" in k))

    calls = ShapeCalls()
    # ---- (b) the demo at full COCO width on three corpus JPEGs
    want = (f"{VIZ_SIZES[0][0]}x{VIZ_SIZES[0][1]}_420",
            f"{VIZ_SIZES[-1][0]}x{VIZ_SIZES[-1][1]}_422",
            f"{VIZ_SIZES[0][0]}x{VIZ_SIZES[0][1]}_progressive")
    picks = [c[1] for name in want for c in corpus if c[0] == name]
    out_dir = os.path.join(work, "demo")
    records = counted("demo", lambda: demo.main(
        [*picks, "--out", out_dir, "--device", dev]))
    check(len(records) == 3, f"demo wrote {len(records)} of 3 images")
    for r in records:
        back = imread(r["out"])
        check(back is not None and np.array_equal(
            back, r["composite"][:, :, ::-1]),
            f"demo {r['out']}: the PNG does not read back as the composite")
    ms = {k: [r["ms"][k] for r in records] for k in records[0]["ms"]}
    summary["demo"] = dict(images=len(records), ms=ms, detections=[
        int(len(r["detections"]["class_ids"])) for r in records])
    log(f"[viz] demo (ResNet-101, 1024^2, 81 classes, seeded weights) on "
        f"{len(records)} JPEGs: ms per image read {ms['read']}, detect "
        f"{ms['detect']}, composite {ms['composite']}, write "
        f"{ms['write']}; launches {by_path['demo']}")

    # ---- (c) captions on the trained shapes detector's detections
    names = ("BG", "square", "circle", "triangle")
    shapes = MaskRCNN("inference", InferenceShapesConfig(), device=dev)
    shapes.load_weights(os.path.join(here, "weights", "shapes_r2_f16.h5"))
    n_det, t_comp, dets = 0, 0.0, []
    scenes = detect_scenes()
    for k, (image, *_rest) in enumerate(scenes):
        r = shapes.detect([image])[0]
        dets.append(r)
        H, W = image.shape[:2]
        colors = [(1.0, 0.2 + 0.1 * (i % 8), 0.1) for i in range(len(
            r["rois"]))]
        t0 = time.perf_counter()
        comp = display_instances(image, r["rois"], r["masks"],
                                 r["class_ids"], names, r["scores"],
                                 colors=colors, show=False)
        t_comp += time.perf_counter() - t0
        base = display_instances(image, r["rois"], r["masks"],
                                 r["class_ids"], names, r["scores"],
                                 colors=colors, show=False,
                                 show_bbox=False)
        stray, empty = _ink_outside(base, comp, r, names, H, W)
        check(stray == 0 and not empty,
              f"scene {k}: {stray} ink pixels outside the boxes' bands, "
              f"detections without ink {empty}")
        n_det += len(r["rois"])
    check(n_det > 0, "the trained detector found nothing to caption")
    # captions beyond ASCII on the scene with the most detections: the
    # composite (its JPEG encoded on the card) equals the CPU's, and the
    # caption ink stays in the bands
    uni = ("BG", "caf\u00e9", "\u0436", "\u4eba")
    k = int(np.argmax([len(r["rois"]) for r in dets]))
    image, r = scenes[k][0], dets[k]
    H, W = image.shape[:2]
    colors = [(0.1, 0.9, 0.3)] * len(r["rois"])
    outs = []
    for where in (dev, "cpu"):
        jpg = os.path.join(work, f"uni_{where}.jpg")
        outs.append((display_instances(
            image, r["rois"], r["masks"], r["class_ids"], uni, r["scores"],
            colors=colors, show=False, save_path=jpg, device=where),
            open(jpg, "rb").read()))
    base = display_instances(image, r["rois"], r["masks"], r["class_ids"],
                             uni, r["scores"], colors=colors, show=False,
                             show_bbox=False, device="cpu")
    stray, empty = _ink_outside(base, outs[0][0], r, uni, H, W)
    check(np.array_equal(outs[0][0], outs[1][0])
          and outs[0][1] == outs[1][1] and stray == 0 and not empty,
          f"non-ASCII captions: card != CPU, or {stray} stray ink pixels, "
          f"detections without ink {empty}")
    log(f"[viz] captions {uni[1:]} on scene {k} ({len(r['rois'])} "
        f"detections): composite and its card-encoded JPEG equal the CPU's, "
        f"ink inside the bands")
    summary["captions"] = dict(detections=n_det, ms_per_image=1e3 * t_comp
                               / len(scenes))
    log(f"[viz] captions: {n_det} detections on {len(scenes)} scenes, every "
        f"outline "
        f"and caption inside its box's bands; display_instances "
        f"{summary['captions']['ms_per_image']:.2f} ms an image")

    # ---- (d) the balloon video branch on the port's own MJPEG AVI
    nf, vh, vw = VIZ_VIDEO
    src = os.path.join(work, "in.avi")
    writer = avi.AviWriter(src, VIZ_FPS, (vw, vh), device=dev)
    for k in range(nf):
        writer.write(_shapes_frame(vh, vw, k))
    writer.release()
    made = []
    detect0 = shapes.detect
    shapes.detect = lambda images, verbose=0: made.extend(
        detect0(images, verbose)) or made[-len(images):]
    t0 = time.perf_counter()
    out = counted("balloon_video", lambda: balloon.detect_and_color_splash(
        shapes, video_path=src, out_dir=work))
    t_video = time.perf_counter() - t0
    shapes.detect = detect0
    rin, rout = avi.AviReader(src), avi.AviReader(out)
    check((len(rout), rout.width, rout.height, rout.fps)
          == (len(rin), rin.width, rin.height, rin.fps) == (nf, vw, vh,
                                                            VIZ_FPS),
          f"splash video {len(rout)} frames {rout.width}x{rout.height} "
          f"{rout.fps} fps != the input's")
    psnr = []
    for k in range(nf):
        rgb = np.ascontiguousarray(rin.read(k, device=dev)[:, :, ::-1])
        splash = balloon.color_splash(rgb, made[k]["masks"])
        check(rout.frame_bytes(k) == jpeg.encode(
            np.ascontiguousarray(splash[:, :, ::-1]), device=dev),
            f"splash frame {k}: not the port's JPEG of color_splash")
        want = splash.astype(np.float64)
        got = rout.read(k, device=dev)[:, :, ::-1].astype(np.float64)
        mse = float(((got - want) ** 2).mean())
        psnr.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
    check(min(psnr) > 35.0, f"splash frames PSNR {psnr} <= 35 dB")
    masked = [int(m["masks"].any(-1).sum()) if m["masks"].shape[-1] else 0
              for m in made]
    summary["balloon_video"] = dict(
        frames=nf, ms_per_frame=1e3 * t_video / nf, psnr_min=min(psnr),
        masked_pixels=masked)
    log(f"[viz] balloon splash video: {nf} frames {vw}x{vh} at {VIZ_FPS} "
        f"fps in and out, PSNR to color_splash {min(psnr):.2f}-"
        f"{max(psnr):.2f} dB, masked pixels a frame {masked}; "
        f"{1e3 * t_video / nf:.1f} ms a frame; launches "
        f"{by_path['balloon_video']}")
    calls.close()
    del shapes, made
    torch.cuda.empty_cache()
    nms_rows, roi_rows = hold_captured(calls, "viz")
    del calls
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    summary["seconds"] = time.time() - t_phase
    log(f"[viz] phase took {summary['seconds']:.1f} s")
    return by_path, {"nms": nms_rows, "roi_align": roi_rows}, summary


def _sum_launches(outs) -> dict:
    return {k: sum(o["launches"][k] for o in outs)
            for k in outs[0]["launches"]}


def _collective_probe_rank(mesh):
    """all_reduce MIN / MAX / SUM and broadcast of CUDA f32, i32 and int16
    tensors over the mesh (parallel/sharding.py's own wrappers)."""
    import torch
    from slam_maskrcnn_tpu_torch.parallel import sharding as sh

    r, n, dev = mesh.rank, mesh.size, mesh.device
    f = torch.tensor([1.5 + r, -2.0 * r, 7.0], device=dev)
    i = torch.tensor([10 - r, r, 3], dtype=torch.int32, device=dev)
    h = torch.full((5,), 100 * (r + 1), dtype=torch.int16, device=dev)
    got = dict(min_f32=sh.all_reduce(f, "min", mesh).tolist(),
               min_i32=sh.all_reduce(i, "min", mesh).tolist(),
               max_i32=sh.all_reduce(i, "max", mesh).tolist(),
               sum_f32=sh.all_reduce(f, "sum", mesh).tolist(),
               bcast_i16=sh.broadcast(h, mesh, src=n - 1).tolist())
    want = dict(min_f32=[1.5, -2.0 * (n - 1), 7.0],
                min_i32=[10 - (n - 1), 0, 3], max_i32=[10, n - 1, 3],
                sum_f32=[sum(1.5 + k for k in range(n)),
                         sum(-2.0 * k for k in range(n)), 7.0 * n],
                bcast_i16=[100 * n] * 5)
    if got != want:
        raise RuntimeError(f"rank {r}: collectives on {dev}: {got} != "
                           f"{want}")
    return dict(got, device=str(dev), backend="gloo")


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
    t_start = t0 = time.time()
    build_logs = {}
    kernels.build_all(logs=build_logs)
    for name in kernels.SOURCES:
        kernels.lib(name)
    log(f"[build] {len(kernels.SOURCES)} kernels in {time.time() - t0:.1f} s")
    for src, text in build_logs.items():
        for name, regs, spill, stack, smem in ptxas_lines(text):
            log(f"[build] {src}.cu {name}: {regs} registers, {spill} bytes "
                f"spilled, {stack} bytes of stack, {smem} bytes of static "
                f"shared memory")

    (state, frames, staged, ms, fps, peak, launches, rec, cfg, K4, model,
     dist) = main_path(dev)
    state, c_ms, c_fps, c_peak, c_launches, _ = chunk_path(
        dev, model, state, staged, K4, dist)
    rows = kernel_phase(dev, state, staged, rec, cfg, K4)
    del state, model
    torch.cuda.empty_cache()
    s2_summary = stage2_phase(dev)
    p_paths, p_checks, p_summary = pipeline_phase(dev)
    for k, c in p_checks.items():
        rows[k]["pipeline_max_abs_err"] = c["max_abs_err"]
    t_launches, nms_extra, t_summary = train_phase(dev)
    rows["nms"].update(nms_extra)
    s_paths, s_rows, s_summary = samples_phase(dev)
    for k, extra in s_rows.items():
        rows[k]["samples"] = extra
    sh_paths, sh_fuse, sh_summary = sharded_phase(dev)
    rows["fuse"].update(sh_fuse)
    sfm_summary = sfm_phase(dev)
    v_paths, v_rows, v_summary = viz_phase(dev)
    for k, extra in v_rows.items():
        rows[k]["viz"] = extra

    # launches: each path was counted from 0 on its own (launches_by_path);
    # "launches" is their total. Every kernel of a path must have launched
    # in that path's run.
    by_path = {"step": launches, "paired_chunk": c_launches, **p_paths,
               "train": t_launches, **s_paths, **sh_paths, **v_paths}
    on_path = {"step": ("fuse", "nms", "roi_align"),
               "paired_chunk": ("fuse_pair", "nms", "roi_align"),
               "detect": ("nms", "roi_align"),
               "stage1_jpeg": ("nms", "roi_align"),
               "mask_process": ("nms", "roi_align"),
               "fusion_demo": ("fuse",),
               "live_device": ("fuse", "nms", "roi_align"),
               "live_host": ("fuse", "nms", "roi_align"),
               "train": ("nms",),
               "nucleus_train": ("nms",),
               "nucleus_detect": ("nms", "roi_align"),
               "mini_coco": ("nms", "roi_align"),
               "balloon": ("nms", "roi_align"),
               "tracker": ("nms", "roi_align"),
               "sharded_fuse": ("fuse",),
               "dp_train": ("nms",),
               "demo": ("nms", "roi_align"),
               "balloon_video": ("nms", "roi_align")}
    for path, names in on_path.items():
        check(all(by_path[path][k] > 0 for k in names),
              f"a kernel of the {path} path was never launched: "
              f"{by_path[path]}")
    for k in rows:
        rows[k]["launches_by_path"] = {p: c.get(k, 0)
                                       for p, c in by_path.items()}
        rows[k]["launches"] = sum(rows[k]["launches_by_path"].values())
    log(json.dumps({"north_star": {
        "step": {"stage_ms": ms, "fps": fps, "peak_gib": peak,
                 "frames": N_FRAMES, "launches": launches},
        "paired_chunk": {"stage_ms_per_frame": c_ms, "fps": c_fps,
                         "peak_gib": c_peak, "frames": N_CHUNK,
                         "launches": c_launches},
        "card": smi}}))
    log(json.dumps({"pipeline": dict(p_summary, launches=p_paths,
                                     card=smi)}))
    log(json.dumps({"stage2_xla": dict(s2_summary, card=smi)}))
    log(json.dumps({"train": dict(t_summary, launches=t_launches,
                                  card=smi)}))
    log(json.dumps({"samples": dict(s_summary, launches=s_paths,
                                    card=smi)}))
    log(json.dumps({"sharded": dict(sh_summary, launches=sh_paths,
                                    card=smi)}))
    log(json.dumps({"sfm": dict(sfm_summary, card=smi)}))
    log(json.dumps({"viz": dict(v_summary, launches=v_paths, card=smi)}))
    log(f"[total] {time.time() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [rows[k] for k in (
        "fuse", "fuse_pair", "nms", "nms_sorted", "roi_align")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
