"""PyTorch port vs the committed stress-sequence goldens.

The recipe of tools/make_goldens.py (hard sequence, 120x160, 64^3, the
default FusionConfig: probe_mode="splat", exact splat compaction, 16
frames) through the port's SemanticFusion on the CPU, held to
tests/goldens/hard_seq.json and hard_render_{instance,color}.png, which
the JAX package's production backend wrote.

Bars: the relabel trace, num_objs, n_frames and misses exact (association
outcomes do not depend on single voxels); the renders on more than 99.9%
of the pixels (the JAX test's own bar); the volume checksums exact where
the port reaches it, else within the share of ambiguous voxels (a
projection within 1e-4 px of a pixel edge, or a distance within 1e-5 of a
threshold, where XLA:CPU's contracted multiply-adds round the other way):
the measured deltas are asserted as the bars below.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu_torch.data.synthetic import hard_scene, hard_sequence
from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
from slam_maskrcnn_tpu_torch.fusion.splat import (pinhole_of_extrinsic,
                                                  splat_render)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, make_intrinsic

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
H, W = 120, 160
# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def want():
    with open(os.path.join(GOLDEN_DIR, "hard_seq.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fused():
    K4 = make_intrinsic(130.0, 130.0, W / 2, H / 2)
    frames = hard_sequence(hard_scene(), K4, H, W, n_frames=16)
    cfg = FusionConfig(vol_dim=(64,) * 3)
    fus = SemanticFusion(K4, cfg, backend="pallas", device="cpu")
    trace, misses = [], 0
    for fr in frames:
        mg = fus.parse_frame(fr["depth"], fr["color"], fr["mask"],
                             fr["extrinsic"], fr["mean_depth"])
        if mg is None:
            trace.append([])
            continue
        misses += int(fus.last_misses)
        mg, m = mg.numpy(), fr["mask"]
        trace.append([int(np.bincount(mg[m == lid]).argmax())
                      for lid in range(1, int(m.max()) + 1)])
    e2i = (frames[-1]["extrinsic"]
           @ np.linalg.inv(np.asarray(frames[0]["extrinsic"], np.float64))
           .astype(np.float32))
    M, m4 = pinhole_of_extrinsic(e2i, K4)
    renders = {mode: splat_render(fus.state, M, m4, H, W, cfg,
                                  mode=mode).numpy()
               for mode in ("instance", "color")}
    return fus, frames, trace, misses, renders


def test_hard_sequence_association_matches_goldens(fused, want):
    fus, frames, trace, misses, _ = fused
    assert len(frames) == want["n_frames"]
    assert misses == want["misses"] == 0
    assert int(fus.state.num_objs) == want["num_objs"]
    assert trace == want["relabel_trace"]
    assert want["num_objs"] > max(len(t) for t in trace) >= 3


def test_hard_sequence_checksums_match_goldens(fused, want):
    """Exact where the port reaches it; the bars are the measured deltas
    (each a few ambiguous voxels of 262144, see ROADMAP.md C)."""
    st = fused[0].dense_state()
    hist = st.hist.astype(np.int64)
    got = {"weight_sum": int(st.weight.astype(np.int64).sum()),
           "hist_sum": int(hist.sum()),
           "diff_negative_voxels": int((st.diff < 0).sum())}
    per_bin = hist.reshape(-1, hist.shape[-1]).sum(0)
    delta = {k: got[k] - want[k] for k in got}
    delta["hist_per_bin_max"] = int(np.abs(
        per_bin - np.asarray(want["hist_per_bin"])).max())
    print("golden checksum deltas:", delta)
    for key, bar in BARS.items():
        assert abs(delta[key]) <= bar, (key, delta[key])
    diff_sum = round(float(st.diff.astype(np.float64).sum()) * 1e-3, 3)
    assert abs(diff_sum - want["diff_sum_1e3"]) < 1e-2


# |port - golden| of each checksum, as measured (0 = exact)
BARS = {"weight_sum": 0, "hist_sum": 0, "diff_negative_voxels": 0,
        "hist_per_bin_max": 0}


@pytest.mark.parametrize("mode", ["instance", "color"])
def test_hard_sequence_renders_match_goldens(fused, mode):
    got = fused[4][mode]
    want_img = cv2.imread(os.path.join(
        GOLDEN_DIR, f"hard_render_{mode}.png"))[:, :, ::-1]   # BGR -> RGB
    assert got.shape == want_img.shape and got.dtype == np.uint8
    exact = (got == want_img).all(axis=-1).mean()
    assert exact > 0.999, f"{mode} render: {exact:.4f} of pixels equal"
    assert (got.max(-1) > 0).mean() > 0.05, "render must show something"
