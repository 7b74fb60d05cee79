"""Stage 1 (``models/mask_ops.batch_mask_process``) on the frame kinds the
JAX driver reads with ``cv2.imread``: a folder of JPEG frames (no PNG
there, so both drivers fall back to ``*.jpg``) and a folder of gray PNG
frames, each read as BGR. The trained detector in float32 on four 128^2
parity scenes; the port's label PNGs against the JAX package's, at the
bar of tests/test_torch_stage2.py (>= 99.5% of pixels equal per mask)."""

import os

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.models import mask_ops as jops
from slam_maskrcnn_tpu_torch.data.image_io import imread
from slam_maskrcnn_tpu_torch.models import mask_ops as tops
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.samples.train_shapes import detect_scenes
from slam_maskrcnn_tpu_torch.utils.profiling import StageTimer
from test_torch_detect import JF32, TF32, TRAINED, _jax_trained

torch.set_num_threads(2)

SCENES = (0, 2, 4, 5)          # 128 x 128 scenes: one JAX compile


@pytest.fixture(scope="module")
def models():
    return (_jax_trained(JF32),
            MaskRCNN("inference", TF32(), device="cpu").load_weights(TRAINED))


def _write_frames(root, kind):
    rgb = root / "rgb"
    os.makedirs(rgb)
    scenes = detect_scenes()
    for k in SCENES:
        bgr = np.ascontiguousarray(scenes[k][0][:, :, ::-1])
        if kind == "jpeg":
            cv2.imwrite(str(rgb / f"{k:02d}.jpg"), bgr)
        else:
            cv2.imwrite(str(rgb / f"{k:02d}.png"),
                        cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    return rgb


@pytest.mark.parametrize("kind", ["jpeg", "gray_png"])
def test_batch_mask_process_frames_match_jax(tmp_path, models, kind):
    jm, tm = models
    rgb = _write_frames(tmp_path, kind)
    timer = StageTimer("cpu")
    assert jops.batch_mask_process(jm, str(rgb), str(tmp_path / "jm"),
                                   verbose=False) == len(SCENES)
    assert tops.batch_mask_process(tm, str(rgb), str(tmp_path / "tm"),
                                   verbose=False, timer=timer) == len(SCENES)
    assert timer.counts["read"] == timer.counts["detect"] == len(SCENES)
    names = sorted(os.listdir(tmp_path / "jm"))
    assert names == sorted(os.listdir(tmp_path / "tm")) and \
        all(n.endswith(".png") for n in names)
    agree, n_inst = [], 0
    for f in names:
        a = cv2.imread(str(tmp_path / "jm" / f), cv2.IMREAD_UNCHANGED)
        b = imread(tmp_path / "tm" / f, -1, device="cpu")
        assert b.dtype == np.uint8 and b.shape == a.shape
        agree.append((a == b).mean())
        n_inst += int(a.max())
    assert min(agree) >= 0.995, agree
    assert n_inst >= 1
