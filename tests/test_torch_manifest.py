"""The strict-load readiness of the port for the real ``mask_rcnn_coco.h5``
(the counterpart of tests/test_manifest.py): the port's ResNet-101 /
81-class module and its ResNet-50 variant, mapped to Keras layer and
weight names by models/h5.py (what ``save_h5_weights`` writes and the
strict ``load_h5_weights`` reads), cover the matterport layer manifest of
models/coco_manifest.py one for one, shapes included; and the port's copy
of the manifest equals the JAX package's."""

import pytest
import torch

from slam_maskrcnn_tpu.models.coco_manifest import (
    coco_h5_manifest as j_manifest)
from slam_maskrcnn_tpu_torch.models.coco_manifest import coco_h5_manifest
from slam_maskrcnn_tpu_torch.models.config import Config
from slam_maskrcnn_tpu_torch.models.h5 import keras_weights
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

torch.set_num_threads(2)


def _config(backbone, classes):
    class C(Config):
        NAME = "coco"
        BACKBONE = backbone
        NUM_CLASSES = classes
        IMAGES_PER_GPU = 1
        GPU_COUNT = 1
    return C()


@pytest.mark.parametrize("backbone,classes", [("resnet101", 81),
                                              ("resnet50", 2),
                                              ("resnet50", 4)])
def test_manifest_covered_exactly(backbone, classes):
    want = coco_h5_manifest(backbone, classes)
    model = MaskRCNN("inference", _config(backbone, classes), device="cpu")
    got = {layer: {w: tuple(a.shape) for w, a in ws.items()}
           for layer, ws in keras_weights(model).items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    assert not missing, f"model lacks {len(missing)} h5 layers: {missing[:10]}"
    assert not extra, f"model has {len(extra)} non-h5 layers: {extra[:10]}"
    for layer, weights in want.items():
        assert got[layer] == weights, (
            f"{layer}: model {got[layer]} vs manifest {weights}")


@pytest.mark.parametrize("backbone,classes", [("resnet101", 81),
                                              ("resnet50", 2)])
def test_manifest_copy_matches_jax(backbone, classes):
    m = coco_h5_manifest(backbone, classes)
    assert m == j_manifest(backbone, classes)
    assert ("res4w_branch2c" in m) == (backbone == "resnet101")
    assert m["mrcnn_class_logits"]["kernel:0"] == (1024, classes)
