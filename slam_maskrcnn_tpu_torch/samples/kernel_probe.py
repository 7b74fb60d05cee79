#!/usr/bin/env python3
"""Where the redesigned kernels of the PyTorch port spend their time, on
one NVIDIA GPU.

    python3 -m slam_maskrcnn_tpu_torch.samples.kernel_probe

(from the repository's root, where chip_smoke.py lies)

chip_smoke.py times each kernel through its Python wrapper on the main
path's inputs. This probe runs inputs chosen to isolate one part of a
kernel. It launches the fuse kernels' C entry points directly (their
wrappers cost about 0.1 ms of host time a call, which hides anything
faster) and the NMS kernel through its wrapper (its times are well above
that):

- fuse at 512^3 (CUDA events over 50 launches): the main path's frame, a
  pair, a camera looking away (every brick skips at its first test: the
  cost of the grid and the depth-tile pass), a depth image of zeros (every
  brick projects its corners and scans its tiles, then skips), a wall behind
  the volume (every brick in view is free: the streaming update of diff and
  weight), and a camera inside the volume;
- argmax NMS, 1000 selections at batch 1 (CUDA events over 20 launches):
  1024 boxes with a threshold nothing exceeds (one box a thread: what a
  selection costs beside the IoU tests), 6000 such boxes, 6000 seeded
  boxes at the proposal threshold, and a batch of 16 sets of 6000 boxes
  drawn around 40 centres, where most boxes die early;
- sorted NMS on the same two sets of boxes sorted by score, at batch 1
  and 16: its pair-matrix kernel and its scan kernel timed apart (their C
  entry points launched directly), and both through the wrapper;
- ROIAlign at the model's pyramid shapes (768 x 1024 molded, C = 256,
  seeded features and boxes), bf16 and f32 features, pool 7 (1000 rois)
  and pool 14 (32 rois), batch 1 and 16, against its byte bound.

The sorted NMS and ROIAlign times are device times: the launches are
queued behind a spin kernel (chip_smoke.device_ms).

Prints the card's name and power limit, then one line per measurement.
"""

import ctypes
import subprocess
import sys

import numpy as np


def main() -> int:
    import torch

    import chip_smoke as cs
    from slam_maskrcnn_tpu_torch import kernels
    from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                        make_sequence)
    from slam_maskrcnn_tpu_torch.fusion import fuse as fz
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)
    from slam_maskrcnn_tpu_torch.ops import nms as nm

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels.build_all()
    P = kernels.ptr

    # ---- fuse: the smoke's volume and frames
    H, W = cs.H, cs.W
    K4 = make_intrinsic(520.9, 521.0, 325.1, 249.7)
    frames = make_sequence(default_scene(), K4, H, W, n_frames=4)
    E0i = np.linalg.inv(frames[0]["extrinsic"]).astype(np.float32)
    cfg = FusionConfig(vol_dim=cs.VOL)
    vol = fz.init_from_first_frame(cfg, frames[0]["depth"], K4,
                                   frames[0]["mean_depth"], device=dev)
    e2i = [(f["extrinsic"] @ E0i).astype(np.float32) for f in frames[1:]]
    fr = [(torch.from_numpy(f["depth"]).to(dev),
           torch.from_numpy(f["color"]).to(dev),
           torch.from_numpy(f["mask"]).to(dev),
           fz.fuse_params(vol, e, K4, cfg)) for f, e in zip(frames[1:], e2i)]
    for f in fr:
        fz.fuse_frame_plain(vol, *f)
    poses = cs.seeded_poses(vol.vol_start, vol.vol_end, e2i[0])
    with_pose = lambda name: fr[0][:3] + (fz.fuse_params(vol, poses[name],
                                                         K4, cfg),)
    with_depth = lambda raw: (torch.full_like(fr[0][0], raw),) + fr[0][1:]
    cases = {"main path's frame": [fr[0]], "pair": [fr[2], fr[0]],
             "looking away (all skip at once)": [with_pose("away")],
             "depth of zeros (all skip after the tile scan)": [with_depth(0)],
             "wall behind the volume (free in view)": [with_depth(20000)],
             "camera inside the volume": [with_pose("inside")]}
    X, Y, Z = vol.diff.shape
    K = vol.hist.shape[-1]
    lib = kernels.lib("fuse")
    state = (P(vol.diff), P(vol.color), P(vol.weight), P(vol.hist), X, Y, Z, K)
    for name, fs in cases.items():
        ps, tiles, classes = fz._kernel_scratch(vol, len(fs), H, W,
                                                [f[3] for f in fs])
        pp = [p.ctypes.data_as(ctypes.c_void_p) for p in ps]
        tail = (P(tiles), P(classes), kernels.stream_ptr(vol.device))
        if len(fs) == 1:
            d, c, m, _ = fs[0]
            launch = lambda: lib.fuse_frame_cuda(
                *state, P(d), P(c), P(m), H, W, pp[0], *tail[:2], 0, tail[2])
        else:
            (d1, c1, m1, _), (d2, c2, m2, _) = fs
            launch = lambda: lib.fuse_frames2_cuda(
                *state, P(d1), P(c1), P(m1), pp[0], P(d2), P(c2), P(m2),
                pp[1], H, W, *tail)
        kernels.check(launch(), "fuse kernel")
        ms = cs.cuda_time_ms(launch, 50)
        n = [int((classes == c).sum()) for c in (fz.SKIP, fz.FREE, fz.FULL)]
        print(f"[fuse] {name}: {ms:.4f} ms (bricks skip / free / full, all "
              f"frames: {n[0]} / {n[1]} / {n[2]})", flush=True)

    # ---- NMS
    g = torch.Generator().manual_seed(0)
    yx = torch.rand(16, 6000, 2, generator=g) * 0.9
    hw = torch.rand(16, 6000, 2, generator=g) * 0.3 + 0.01
    b = torch.cat([yx, yx + hw], -1).to(dev).contiguous()
    s = torch.rand(16, 6000, generator=g).to(dev)
    ctr = torch.rand(16, 40, 2, generator=g)[
        :, torch.randint(0, 40, (6000,), generator=g)] * 0.8
    jit = lambda: torch.rand(16, 6000, 2, generator=g) * 0.03
    bo = torch.cat([ctr + jit(), ctr + 0.15 + jit()], -1).to(dev).contiguous()
    ninf = float("-inf")
    runs = {"1024 boxes, nothing suppressed": (b[:1, :1024], s[:1, :1024], 1.0),
            "6000 boxes, nothing suppressed": (b[:1], s[:1], 1.0),
            "6000 seeded boxes, IoU 0.7": (b[:1], s[:1], 0.7),
            "16 x 6000 boxes around 40 centres, IoU 0.7": (bo, s, 0.7)}
    for name, (bb, ss, thr) in runs.items():
        bb, ss = bb.contiguous(), ss.contiguous()
        ms = cs.cuda_time_ms(lambda: nm._nms_cuda(bb, ss, 1000, thr, ninf), 20)
        sel = nm._nms_cuda(bb, ss, 1000, thr, ninf)[1].sum(1)
        print(f"[nms] {name}: {ms:.4f} ms, {ms * 1e3 / int(sel.max()):.3f} us "
              f"a selection ({int(sel.min())}-{int(sel.max())} selections an "
              f"image)", flush=True)

    # ---- sorted NMS: the pair matrix and the scan apart, on the same
    # boxes sorted by score, at batch 1 and 16
    order = torch.sort(s, dim=1, descending=True, stable=True)[1]
    lib = kernels.lib("nms_sorted")
    for name, bb in (("6000 seeded boxes", b), ("6000 boxes around 40 "
                                                "centres", bo)):
        bs = torch.gather(bb, 1, order[..., None].expand(-1, -1, 4))
        for B in (1, 16):
            x = bs[:B].contiguous()
            n = x.shape[1]
            bits = torch.empty(B, n, (n + 63) // 64, dtype=torch.int64,
                               device=dev)
            sup = torch.empty(B, n, dtype=torch.uint8, device=dev)
            st = kernels.stream_ptr(x.device)
            pairs = lambda: lib.nms_sorted_pairs_cuda(P(x), B, n, 0.7,
                                                      P(bits), st)
            scan = lambda: lib.nms_sorted_scan_cuda(B, n, P(bits), P(sup), st)
            kernels.check(pairs(), "pair kernel")
            kernels.check(scan(), "scan kernel")
            check = nm._nms_sorted_cuda(x, 0.7)
            assert torch.equal(check, sup), "probe's sup != the wrapper's"
            t_pair, t_scan = cs.device_ms(pairs), cs.device_ms(scan)
            t_all = cs.device_ms(lambda: nm._nms_sorted_cuda(x, 0.7))
            kept = n - sup.sum(1)
            print(f"[nms_sorted] {name}, IoU 0.7, batch {B}: pair matrix "
                  f"{t_pair:.4f} ms ({B * n * (n - 1) // 2} IoUs), scan "
                  f"{t_scan:.4f} ms ({(n + 63) // 64} chunks, "
                  f"{int(kept.min())}-{int(kept.max())} kept an image), "
                  f"both through the wrapper {t_all:.4f} ms", flush=True)

    # ---- ROIAlign: the model's pyramid at 768 x 1024 (P2..P5, C = 256),
    # seeded features, proposal-like boxes; both heads, batch 1 and 16
    from slam_maskrcnn_tpu_torch.ops import roi_align as ra
    shape = (768, 1024)
    for dtype in (torch.bfloat16, torch.float32):
        feats = tuple(torch.randn(16, shape[0] // k, shape[1] // k, 256,
                                  generator=g).to(dev, dtype)
                      for k in (4, 8, 16, 32))
        for n, pool in ((1000, 7), (32, 14)):
            yx = torch.rand(16, n, 2, generator=g) * 0.9
            hw = torch.rand(16, n, 2, generator=g) * 0.3 + 0.01
            boxes = torch.cat([yx, yx + hw], -1).to(dev)
            for B in (1, 16):
                f = tuple(x[:B] for x in feats)
                bx = boxes[:B].contiguous()
                ms = cs.device_ms(lambda: ra._roi_align_cuda(f, bx, pool,
                                                              shape))
                read = cs.roi_read_bytes(f, bx, pool, shape)
                out = B * n * pool * pool * 256 * 4
                bms, _ = cs.bound_ms(read + bx.numel() * 4 + out, 0)
                print(f"[roi_align] {dtype}, pool {pool}, {n} rois, batch "
                      f"{B}: {ms:.4f} ms, bound {bms:.5f} ms (bytes: "
                      f"{read / 1e6:.1f} MB of cells read, {out / 1e6:.1f} MB "
                      f"written), {(read + out) / ms / 1e9:.2f} TB/s",
                      flush=True)
        del feats
    return 0


if __name__ == "__main__":
    sys.exit(main())
