"""A tiny copy of the benchmark's files for CPU runs: the same cells,
configurations and metrics, shrunk (ResNet-50 at 128 x 128, 100 rois, a
32^3 volume, 120 x 160 frames with boxes of 30% of the frame, a 16-frame
orbit) by ``shrink``. The port's
kernels run their plain PyTorch versions on the CPU."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def shrink_config(c: dict) -> dict:
    c = json.loads(json.dumps(c))
    d = c["detector"]
    d.update(BACKBONE="resnet50", IMAGE_MIN_DIM=96, IMAGE_MAX_DIM=128,
             POST_NMS_ROIS_INFERENCE=100, PRE_NMS_LIMIT=600,
             DETECTION_MAX_INSTANCES=min(d["DETECTION_MAX_INSTANCES"], 8),
             FPN_CLASSIF_FC_LAYERS_SIZE=64)
    if d["IMAGE_RESIZE_MODE"] == "rect":
        d.update(IMAGE_RECT_SHAPE=[128, 128], IMAGE_SHAPE=[128, 128, 3])
    else:
        d.update(IMAGE_SHAPE=[128, 128, 3])
    c["fusion"]["vol_dim"] = [32, 32, 32]
    # boxes large enough that masks keep the label encoder's 2000 pixels
    # in a 120 x 160 frame
    c["weights"]["box_area_share"] = 0.3
    cam = c["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] = cam[k] / 4
    cam.update(height=120, width=160)
    return c


def shrink_cell(w: dict) -> dict:
    w = json.loads(json.dumps(w))
    w["traffic"]["frames_per_orbit"] = 16
    if "chunk" in w["traffic"]:
        w["traffic"]["chunk"] = 4
    if "frames" in w["traffic"]:
        w["traffic"].update(frames=4, frames_per_call=2)
    for k in ("judge_calls", "judge_frames", "trace_calls"):
        if k in w:
            w[k] = min(w[k], 2)
    f = w.get("fusion", {})
    for k in ("splat_max_blocks", "splat_max_rows", "splat_max_surface"):
        if k in f:
            f[k] = f[k] // 8
    return w


def make_tree(dest: str) -> str:
    """A checkout-like tree at ``dest`` (BENCHMARK.json and h100bench/)
    holding the shrunk files. Returns ``dest``."""
    shutil.copytree(BENCH, os.path.join(dest, "h100bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for sub, fn in (("configs", shrink_config), ("workloads", shrink_cell)):
        d = os.path.join(dest, "h100bench", sub)
        for name in os.listdir(d):
            p = os.path.join(d, name)
            with open(p) as f:
                obj = fn(json.load(f))
            with open(p, "w") as f:
                json.dump(obj, f)
    return dest
