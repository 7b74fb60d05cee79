"""Seeded inputs that the CPU tests and the card gate share; not part of the
reference.

The CPU tests hold the port to the JAX package on them, and ``chip_smoke.py``
holds each kernel to its plain version on them on the card: the NMS edge
cases, the association's cases, the fuse kernel's camera poses, the greedy
match of two detection sets, and a TUM sequence on disk. numpy only (and the
port's PNG writer), so that the card's machine, which has no JAX, imports it.
"""

import numpy as np


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


# the association's cases (the CPU tests against the JAX package, the card
# tests and phase 4): seeds, then the named cases; "chained" is two calls,
# num_objs passed on
ASSOC_CASES = (0, 1, 2, 3, "contested", "tied", "unmatched", "short_mask",
               "chained")
ASSOC_K = 32


def assoc_seeded(seed, Hs=48, Ws=64):
    """A label image of a few blobs and histogram votes that partly agree
    with it (some ids match a global id, some are new)."""
    rng = np.random.default_rng(seed)
    bh, bw = Hs // 4, Ws // 4
    mask = np.zeros((Hs, Ws), np.uint8)
    n_ids = int(rng.integers(3, 7))
    for i in range(1, n_ids + 1):
        y, x = rng.integers(0, Hs - bh), rng.integers(0, Ws - bw)
        mask[y:y + bh, x:x + bw] = i
    n_obs = int(rng.integers(2, 6))
    probs = rng.integers(0, 2, (Hs, Ws, ASSOC_K)).astype(np.float32)
    for i in range(1, n_ids + 1):
        if rng.uniform() < 0.6:                        # matches global id g
            g = int(rng.integers(1, 10))
            probs[mask == i, g] += n_obs
    return probs, probs > 0.3, mask, n_obs, int(rng.integers(2, 10))


def _assoc_blobs(Hs, Ws, where):
    """A label image with id i on the block ``where[i]`` = (row, col) in
    units of a twelfth of the height and a sixteenth of the width, each
    block 2 x 3 units."""
    mask = np.zeros((Hs, Ws), np.uint8)
    uy, ux = Hs // 12, Ws // 16
    for i, (r, c) in where.items():
        mask[r * uy:(r + 2) * uy, c * ux:(c + 3) * ux] = i
    return mask


def assoc_named(case, Hs=48, Ws=64):
    """(probs, box_mask, mask, n_obs, num_objs, expected) of a named case;
    ``expected`` is ({id: the global id it must get}, the new num_objs).
    Votes without a box mask score exactly exp(log(share)); every area
    scales with the image, so the expectations hold at any size."""
    n_obs = 4
    probs = np.zeros((Hs, Ws, ASSOC_K), np.float32)
    bm = np.zeros((Hs, Ws, ASSOC_K), bool)
    if case == "contested":
        # 1, 3 and 5 all vote for global 7: 3 outbids 1, 5 does not outbid 3
        mask = _assoc_blobs(Hs, Ws, {1: (0, 0), 3: (0, 5), 5: (5, 0)})
        for i, share in ((1, 0.6), (3, 1.0), (5, 0.8)):
            probs[mask == i, 7] = share * n_obs
        return probs, bm, mask, n_obs, 9, ({3: 7, 1: 9, 5: 10}, 11)
    if case == "tied":
        # 2 and 4 score exactly 1.0 for global 5: the earlier m keeps it;
        # 1 scores exactly 1.0 for globals 3 and 6: the first n is its best
        mask = _assoc_blobs(Hs, Ws, {2: (0, 0), 4: (5, 8), 1: (8, 3)})
        probs[mask == 2, 5] = n_obs
        probs[mask == 4, 5] = n_obs
        probs[mask == 1, 3] = n_obs
        probs[mask == 1, 6] = n_obs
        return probs, bm, mask, n_obs, 8, ({2: 5, 4: 8, 1: 3}, 9)
    if case == "unmatched":
        # no votes: every present id is fresh, in raster order of its first
        # pixel (6, 3, 2, 4, 1), not in id order
        mask = _assoc_blobs(Hs, Ws, {6: (0, 4), 3: (3, 1), 2: (3, 8),
                                     4: (6, 0), 1: (9, 10)})
        return probs, bm, mask, n_obs, 5, ({6: 5, 3: 6, 2: 7, 4: 8, 1: 9},
                                           10)
    if case == "short_mask":
        # ids 1-3 of K = 32: the absent rows 4.. would score ~0.95 for
        # global 9 off the background's votes and outbid 1 (~0.93), were
        # they allowed to claim; 2 and 3 (~0.86) do not outbid 1
        mask = _assoc_blobs(Hs, Ws, {1: (0, 0), 2: (0, 8), 3: (6, 4)})
        probs[mask == 1, 9] = 0.5 * n_obs
        probs[mask == 0, 9] = 0.05 * n_obs
        bm[mask == 0, 9] = True
        expected = {1: 9, 2: 12, 3: 13}
        expected.update({m: m for m in range(4, ASSOC_K)})
        return probs, bm, mask, n_obs, 12, (expected, 14)
    raise KeyError(case)


def assoc_frames(case, Hs=48, Ws=64):
    """The calls of a case: ([(probs, box_mask, mask, n_obs), ...], the
    first call's num_objs, ``expected`` of the last call or None). Each
    later call takes the num_objs the one before returned."""
    if isinstance(case, int):
        probs, bm, mask, n_obs, num_objs = assoc_seeded(case, Hs=Hs, Ws=Ws)
        return [(probs, bm, mask, n_obs)], num_objs, None
    if case == "chained":
        a, b = assoc_seeded(4, Hs=Hs, Ws=Ws), assoc_seeded(5, Hs=Hs, Ws=Ws)
        return [a[:4], b[:4]], a[4], None
    probs, bm, mask, n_obs, num_objs, expected = assoc_named(case, Hs, Ws)
    return [(probs, bm, mask, n_obs)], num_objs, expected


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
        if not np.array_equal(E[:3, :3], np.eye(3)):
            raise AssertionError("translation-only poses")
        t = [repr(float(-v)) for v in E[:3, 3]]
        lines.append(f"{base_ts + 0.05 * i:.6f} {' '.join(t)} 0.0 0.0 0.0 "
                     "1.0")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(lines)
                + "\n")


# ---------------------------------------------------------------- RPN targets

# name -> anchors: "grid" (hand-placed integer boxes whose IoUs are exact)
# or the image side of data_generator's pixel anchors
RPN_CASES = {"no_gt": 128, "only_crowd": 128, "crowd": 512,
             "class_zero_with_crowd": 128, "unmatched_gt": 128,
             "column_ties": "grid", "thresholds": "grid",
             "many_positives": "grid", "gt100": 512, "tiles": 128,
             "random_128": 128, "random_512": 512, "random_1024": 1024,
             "traffic_1024": 1024}


def rpn_config(side):
    """A square ``side``^2 training config of the port (Config's anchors;
    at 128^2 the shapes sample's scales, 8-128)."""
    from slam_maskrcnn_tpu_torch.models.config import Config

    attrs = dict(IMAGE_MIN_DIM=side, IMAGE_MAX_DIM=side)
    if side == 128:
        attrs["RPN_ANCHOR_SCALES"] = (8, 16, 32, 64, 128)
    return type(f"Rpn{side}", (Config,), attrs)()


def rpn_anchors(side):
    """data_generator's f32 pixel anchors of ``rpn_config(side)``: 4,092 at
    128^2, 65,472 at 512^2, 261,888 at 1024^2."""
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors

    cfg = rpn_config(side)
    s = np.array([side - 1] * 4, np.float32)
    return get_anchors(cfg, cfg.IMAGE_SHAPE) * s + np.array(
        [0, 0, 1, 1], np.float32)


def _grid_anchors():
    """10x10-pixel squares every 10 pixels over 100^2; then [0, 0, 10, 3],
    [0, 0, 10, 7] and [0, 0, 10, 2]; then 300 copies of [60, 60, 80, 80]."""
    y, x = np.meshgrid(np.arange(10) * 10, np.arange(10) * 10,
                       indexing="ij")
    grid = np.stack([y, x, y + 10, x + 10], -1).reshape(-1, 4)
    extra = [[0, 0, 10, 3], [0, 0, 10, 7], [0, 0, 10, 2]]
    dup = np.tile([[60, 60, 80, 80]], (300, 1))
    return np.concatenate([grid, extra, dup]).astype(np.float32)


def _random_gt(rng, n, side, lo=8, hi=None):
    """n integer boxes inside side^2, sides lo..hi pixels."""
    hi = hi or side // 3
    h, w = rng.integers(lo, hi, n), rng.integers(lo, hi, n)
    y1, x1 = rng.integers(0, side - h), rng.integers(0, side - w)
    return np.stack([y1, x1, y1 + h, x1 + w], 1).astype(np.float32)


def _traffic_gt(rng, n=12, side=1024):
    """Boxes as the training cell's 480x640 frames give them molded to
    1024^2 (scale 1.6, 128 rows of padding above): the boxes of n discs of
    radius 10-200 pixels, cut at the frame's window; discs that leave the
    window are dropped as the generator drops empty masks."""
    top, bottom = 128, 128 + 768
    cy = rng.uniform(top - 100, bottom + 100, n)
    cx = rng.uniform(-100, side + 100, n)
    r = rng.uniform(10, 200, n)
    b = np.stack([np.floor(cy - r), np.floor(cx - r), np.ceil(cy + r),
                  np.ceil(cx + r)], 1)
    b = np.clip(b, [top, 0, top, 0], [bottom, side, bottom, side])
    keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
    return b[keep].astype(np.float32)


def rpn_split(gt_class_ids, gt_boxes):
    """(the gt boxes that build_rpn_targets matches, the crowd boxes): with
    a crowd box the gt of class > 0, else every gt."""
    crowd = gt_boxes[gt_class_ids < 0]
    return (gt_boxes[gt_class_ids > 0] if len(crowd) else gt_boxes), crowd


def rpn_case(name, seed=0):
    """One case of ``build_rpn_targets``: (anchors f32 [A, 4], gt_class_ids
    i32 [N] (< 0 crowd), gt_boxes f32 [N, 4], config)."""
    rng = np.random.default_rng([seed, len(name)])
    where = RPN_CASES[name]
    side = 100 if where == "grid" else where
    anchors = _grid_anchors() if where == "grid" else rpn_anchors(side)
    cfg = rpn_config(128 if where == "grid" else side)
    ids = None
    if name == "no_gt":
        gt = np.zeros((0, 4), np.float32)
    elif name == "only_crowd":
        gt, ids = _random_gt(rng, 2, side), np.array([-1, -1])
    elif name == "crowd":
        # three crowd boxes, each 20 pixels around a gt: the anchors near
        # them go neutral, not negative
        gt = _random_gt(rng, 8, side)
        crowd = np.concatenate([gt[:3, :2] - 20, gt[:3, 2:] + 20], 1)
        gt = np.concatenate([gt, np.clip(crowd, 0, side)])
        ids = np.array([1, 2, 3, 4, 1, 2, 3, 4, -1, -1, -1])
    elif name == "class_zero_with_crowd":
        # a crowd box drops the class-0 gt from the matching; without a
        # crowd box it would stay
        gt, ids = _random_gt(rng, 4, side), np.array([2, 0, -1, 1])
    elif name == "unmatched_gt":
        # far outside every anchor: its column max is 0, so every anchor
        # with IoU 0 to it is positive (model.py:1499-1502), thousands of
        # positives for the subsample
        gt = np.array([[20, 30, 60, 90], [1000, 1000, 1010, 1010]],
                      np.float32)
    elif name == "column_ties":
        # between two anchors, between four, on one, and its copy
        gt = np.array([[0, 5, 10, 15], [45, 45, 55, 55], [20, 20, 30, 30],
                       [20, 20, 30, 30]], np.float32)
    elif name == "thresholds":
        # anchors [0, 0, 10, 3] and [0, 0, 10, 7] against the gt on anchor
        # 0: IoU 30 / 100 = 0.3f (not negative) and 70 / 100 = 0.7f
        # (positive); [0, 0, 10, 2]: 0.2 (negative)
        gt = np.array([[0, 0, 10, 10], [90, 90, 100, 100]], np.float32)
    elif name == "many_positives":
        gt = np.array([[60, 60, 80, 80], [5, 5, 25, 25]], np.float32)
    elif name == "gt100":
        gt = _random_gt(rng, 100, side)
    elif name == "tiles":
        # more boxes than the kernel stages at once (256), crowd last
        gt = _random_gt(rng, 320, side, 4, 48)
        ids = np.where(np.arange(320) < 300, 1, -1)
    elif name.startswith("random"):
        gt = _random_gt(rng, 12, side)
        ids = rng.integers(1, 81, 12)
        ids[:2] = -1
    else:
        gt = _traffic_gt(rng)
    if ids is None:
        ids = rng.integers(1, 81, len(gt))
    return anchors, np.asarray(ids, np.int32), gt, cfg


def molded_gt(masks, class_ids, config, flip=False):
    """One frame's instances (bool masks [H, W, N], class ids [N]) as
    data_generator hands them to build_rpn_targets: (class ids i32 [n], f32
    boxes [n, 4]) after load_image_gt's molding to ``config``'s shape and
    its flip (``flip``), empty masks dropped."""
    from slam_maskrcnn_tpu_torch.data.augment import Fliplr
    from slam_maskrcnn_tpu_torch.data.dataset import Dataset, load_image_gt

    class Frame(Dataset):
        def load_image(self, image_id):
            return np.zeros(masks.shape[:2] + (3,), np.uint8)

        def load_mask(self, image_id):
            return masks, np.asarray(class_ids, np.int32)

    ds = Frame()
    ds.add_image("frame", 0, None)
    ds.prepare()
    _, ids, boxes, *_ = load_image_gt(
        ds, config, 0, augmentation=Fliplr(1.0 if flip else 0.0),
        rng=np.random.default_rng(0), use_mini_mask=False)
    return np.asarray(ids, np.int32), boxes.astype(np.float32)
