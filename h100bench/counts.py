"""The yardstick's counts: the card's published peaks, the detector's
FLOPs a frame, and the bytes and operations K1 (the fuse kernels) and K2
(the NMS kernel) need for the work a traced stretch gave them.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W: 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s HBM3. A kernel's bound is the larger of its bytes over the
bandwidth and its operations over the float32 rate.

Everything is counted from the configuration's shapes and the frames'
contents, never from the port's code, so a count reads the same whatever
implements the work.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import traffic

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_HBM_BYTES, n_ops / PEAK_F32_FLOPS)


def _conv(k: int, cin: int, cout: int, h: int, w: int) -> int:
    """2 FLOPs a multiply-add of a k x k convolution with an h x w output."""
    return 2 * k * k * cin * cout * h * w


def detector_flops(det: dict) -> int:
    """Mask R-CNN inference FLOPs of one frame at the molded size: the
    ResNet trunk (bottlenecks [3, 4, {6|23}, 3], the stride on each
    stage's first 1x1), the FPN, the RPN over every level, the classifier
    head over POST_NMS_ROIS_INFERENCE rois and the mask head over
    DETECTION_MAX_INSTANCES rois. Convolutions and dense layers only."""
    H, W = det["IMAGE_SHAPE"][:2]
    up = lambda n, s: -(-n // s)
    f = _conv(7, 3, 64, up(H, 2), up(W, 2))
    cin = 64
    c_stage = {}
    for stage, (n_blk, width) in enumerate(
            zip(RESNET_BLOCKS[det["BACKBONE"]], (64, 128, 256, 512))):
        s = 4 * 2 ** stage
        h, w = up(H, s), up(W, s)
        for b in range(n_blk):
            f += _conv(1, cin, width, h, w)
            f += _conv(3, width, width, h, w)
            f += _conv(1, width, 4 * width, h, w)
            if b == 0:
                f += _conv(1, cin, 4 * width, h, w)
            cin = 4 * width
        c_stage[stage] = (cin, h, w)
    d = det["TOP_DOWN_PYRAMID_SIZE"]
    for cin, h, w in c_stage.values():
        f += _conv(1, cin, d, h, w) + _conv(3, d, d, h, w)
    a = len(det["RPN_ANCHOR_RATIOS"])
    for s in det["BACKBONE_STRIDES"]:
        h, w = up(H, s), up(W, s)
        f += _conv(3, d, 512, h, w) + _conv(1, 512, 6 * a, h, w)
    fc, ncls = det["FPN_CLASSIF_FC_LAYERS_SIZE"], det["NUM_CLASSES"]
    p = det["POOL_SIZE"]
    f += det["POST_NMS_ROIS_INFERENCE"] * (
        _conv(p, d, fc, 1, 1) + _conv(1, fc, fc, 1, 1)
        + _conv(1, fc, 5 * ncls, 1, 1))
    m = det["MASK_POOL_SIZE"]
    f += det["DETECTION_MAX_INSTANCES"] * (
        4 * _conv(3, d, 256, m, m) + _conv(2, 256, 256, m, m)
        + _conv(1, 256, ncls, 2 * m, 2 * m))
    return f


def k2_launch(batch: int, n: int, cap: int):
    """(bytes, operations) of one K2 launch: boxes and scores read, (index,
    valid) written; one IoU (12 operations) of every box for each of the
    ``cap`` + 1 selections. The selections a launch makes are not seen
    from outside the port, so each is counted at its ``cap``."""
    return batch * (n * 20 + cap * 5), batch * (cap + 1) * n * 12


def k2_bound_s(record) -> float:
    """K2's bound over the traced stretch: each detect graph run of
    ``detect_batch`` frames launches K2 twice (the proposals, then the
    class-offset detections)."""
    det = record["config"]["detector"]
    b = record["driver"].detect_batch
    runs = record["trace_frames"] // b
    n_pre = min(det["PRE_NMS_LIMIT"], _anchors(det))
    rois = det["POST_NMS_ROIS_INFERENCE"]
    out = 0.0
    for n, cap in ((n_pre, rois), (rois, det["DETECTION_MAX_INSTANCES"])):
        out += runs * bound_s(*k2_launch(b, n, cap))
    return out


def _anchors(det: dict) -> int:
    H, W = det["IMAGE_SHAPE"][:2]
    a = len(det["RPN_ANCHOR_RATIOS"])
    return sum(a * -(-H // s) * -(-W // s) for s in det["BACKBONE_STRIDES"])


def k1_masks(geometry: dict, vol_dim, fusion: dict, K, depth, e2i,
             xa: int, xb: int):
    """(valid, gated) voxels of x-planes [xa, xb) for one frame, by the
    fuse's own tests (tsdf.cu:18-70): in front of the camera, inside the
    image, depth > 0, diff > -mu; gated: normalized diff < the colour
    gate. Float32, in the kernel's evaluation order."""
    dev = depth.device
    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    E = np.asarray(e2i, np.float32)
    vs = np.asarray(geometry["vol_start"], np.float32)
    vx = np.asarray(geometry["voxel"], np.float32)
    base = ((E[:3, 0] * vs[0] + E[:3, 1] * vs[1]) + E[:3, 2] * vs[2]) \
        + E[:3, 3]
    _, Y, Z = vol_dim
    H, W = depth.shape
    gx = torch.arange(xa, xb, dtype=torch.float32, device=dev)[:, None, None]
    gy = torch.arange(Y, dtype=torch.float32, device=dev)[None, :, None]
    gz = torch.arange(Z, dtype=torch.float32, device=dev)[None, None, :]
    p = [((f(base[r]) + f(E[r, 0] * vx[0]) * gx) + f(E[r, 1] * vx[1]) * gy)
         + f(E[r, 2] * vx[2]) * gz for r in range(3)]
    tiny = f(1e-9)
    safe_z = torch.where(p[2].abs() < tiny, tiny, p[2])
    u = torch.floor((f(K[0, 0]) * p[0] + f(K[0, 2]) * p[2]) / safe_z)
    v = torch.floor((f(K[1, 1]) * p[1] + f(K[1, 2]) * p[2]) / safe_z)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (p[2] > 0)
    pix = (v.clamp(0, H - 1) * W + u.clamp(0, W - 1)).long()
    d = depth.reshape(-1).to(torch.int32)[pix].float() / f(
        fusion["depth_scale"])
    mu = f(geometry["mu"])
    diff = d - p[2]
    valid = inside & (d > 0) & (diff > -mu)
    gated = valid & (torch.minimum(diff, mu) / mu < f(
        fusion["color_diff_gate"]))
    return valid, gated


def k1_bound_s(record, slab: int = 32) -> float:
    """K1's bound over the traced stretch. A launch of g frames (1, or 2
    for the paired kernel) needs: each frame once (depth 2, colour 3, mask
    1 bytes a pixel); diff and weight (4 + 4 bytes) read and written for
    each voxel valid in any of its frames; colour (3) and one histogram
    bin (2) read and written for each gated update; the projection of
    every voxel (20 operations) for each frame."""
    drv = record["driver"]
    cfg = record["config"]
    fusion = dict(cfg["fusion"], **record["cell"].get("fusion", {}))
    vol_dim = fusion["vol_dim"]
    cam = cfg["camera"]
    K = traffic.intrinsic(cam)
    H, W = cam["height"], cam["width"]
    first = record["trace_first"]
    frames = np.concatenate(
        drv.call_frames[first:first + record["cell"]["trace_calls"]])
    g = drv.fuse_per_launch
    seq = drv.seq
    total = 0.0
    nvox = int(np.prod(vol_dim))
    for i in range(0, len(frames) - g + 1, g):
        group = frames[i:i + g]
        n_valid = n_gated = 0
        for xa in range(0, vol_dim[0], slab):
            xb = min(vol_dim[0], xa + slab)
            any_valid = None
            for k in group:
                v, gt = k1_masks(drv.geometry, vol_dim, fusion, K,
                                 seq.depth[k], seq.e2i[k], xa, xb)
                any_valid = v if any_valid is None else any_valid | v
                n_gated += int(gt.sum())
            n_valid += int(any_valid.sum())
        total += bound_s(g * H * W * 6 + n_valid * 16 + n_gated * 10,
                         g * nvox * 20)
    return total
