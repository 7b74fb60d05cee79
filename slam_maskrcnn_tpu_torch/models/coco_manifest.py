"""Manifest of the matterport ``mask_rcnn_coco.h5`` layer names + shapes.

A copy of slam_maskrcnn_tpu/models/coco_manifest.py. The real pretrained
checkpoint is not in the repository and is not fetched, so this module
encodes the ground truth the strict h5 loader (models/h5.py) must match on
first contact: every weighted layer the reference
graph creates, with its Keras weight names and shapes. Derived by reading
the reference graph code, not from a download:

* ResNet stem/blocks: ``Mask_RCNN/mrcnn/model.py:101-212`` (conv/bn naming
  ``res{stage}{block}_branch{2a,2b,2c,1}`` / ``bn...``; stage-4 block ids
  ``chr(98+i)`` for 22 blocks on resnet101).
* FPN lateral/output convs: ``model.py:1894-1911`` (``fpn_c{5..2}p{5..2}``,
  ``fpn_p{2..5}``).
* RPN head: ``model.py:835-876`` (``rpn_conv_shared``, ``rpn_class_raw``,
  ``rpn_bbox_pred``; anchors_per_location = len(RPN_ANCHOR_RATIOS) = 3).
* FPN classifier head: ``model.py:905-956`` (``mrcnn_class_conv1/2`` are
  pool_size-wide convs-as-FC, ``mrcnn_class_logits``/``mrcnn_bbox_fc``
  are Dense).
* Mask head: ``model.py:959-1008`` (4 convs + ``mrcnn_mask_deconv``
  Conv2DTranspose + ``mrcnn_mask``).

Keras shape conventions: Conv2D kernel [kh, kw, cin, cout]; Dense kernel
[in, out]; Conv2DTranspose kernel [kh, kw, cout, cin]; every layer has a
bias; BatchNorm stores gamma/beta/moving_mean/moving_variance of [c].
"""

from __future__ import annotations


def _conv(shapes: dict, name: str, kh: int, kw: int, cin: int, cout: int):
    shapes[name] = {"kernel:0": (kh, kw, cin, cout), "bias:0": (cout,)}


def _bn(shapes: dict, name: str, c: int):
    shapes[name] = {w: (c,) for w in ("gamma:0", "beta:0", "moving_mean:0",
                                      "moving_variance:0")}


def _dense(shapes: dict, name: str, cin: int, cout: int):
    shapes[name] = {"kernel:0": (cin, cout), "bias:0": (cout,)}


def _resnet(shapes: dict, architecture: str):
    _conv(shapes, "conv1", 7, 7, 3, 64)
    _bn(shapes, "bn_conv1", 64)
    stages = {
        2: ([64, 64, 256], ["a", "b", "c"]),
        3: ([128, 128, 512], ["a", "b", "c", "d"]),
        4: ([256, 256, 1024],
            ["a"] + [chr(98 + i)
                     for i in range({"resnet50": 5, "resnet101": 22}
                                    [architecture])]),
        5: ([512, 512, 2048], ["a", "b", "c"]),
    }
    cin = 64
    for stage, (filters, blocks) in stages.items():
        f1, f2, f3 = filters
        for block in blocks:
            conv_base = f"res{stage}{block}_branch"
            bn_base = f"bn{stage}{block}_branch"
            _conv(shapes, conv_base + "2a", 1, 1, cin, f1)
            _bn(shapes, bn_base + "2a", f1)
            _conv(shapes, conv_base + "2b", 3, 3, f1, f2)
            _bn(shapes, bn_base + "2b", f2)
            _conv(shapes, conv_base + "2c", 1, 1, f2, f3)
            _bn(shapes, bn_base + "2c", f3)
            if block == "a":  # conv_block: projection shortcut
                _conv(shapes, conv_base + "1", 1, 1, cin, f3)
                _bn(shapes, bn_base + "1", f3)
            cin = f3
    return {2: 256, 3: 512, 4: 1024, 5: 2048}


def coco_h5_manifest(architecture: str = "resnet101", num_classes: int = 81,
                     top_down: int = 256, fc_size: int = 1024,
                     anchors_per_location: int = 3, pool_size: int = 7,
                     mask_conv: int = 256) -> dict[str, dict[str, tuple]]:
    """{layer_name: {keras_weight_name: shape}} for the full training graph
    (what ``mask_rcnn_coco.h5`` contains — the reference saves all weighted
    layers regardless of mode)."""
    shapes: dict[str, dict[str, tuple]] = {}
    c_out = _resnet(shapes, architecture)
    for stage in (5, 4, 3, 2):
        _conv(shapes, f"fpn_c{stage}p{stage}", 1, 1, c_out[stage], top_down)
    for level in (2, 3, 4, 5):
        _conv(shapes, f"fpn_p{level}", 3, 3, top_down, top_down)
    _conv(shapes, "rpn_conv_shared", 3, 3, top_down, 512)
    _conv(shapes, "rpn_class_raw", 1, 1, 512, 2 * anchors_per_location)
    _conv(shapes, "rpn_bbox_pred", 1, 1, 512, 4 * anchors_per_location)
    _conv(shapes, "mrcnn_class_conv1", pool_size, pool_size, top_down,
          fc_size)
    _bn(shapes, "mrcnn_class_bn1", fc_size)
    _conv(shapes, "mrcnn_class_conv2", 1, 1, fc_size, fc_size)
    _bn(shapes, "mrcnn_class_bn2", fc_size)
    _dense(shapes, "mrcnn_class_logits", fc_size, num_classes)
    _dense(shapes, "mrcnn_bbox_fc", fc_size, num_classes * 4)
    for i in (1, 2, 3, 4):
        _conv(shapes, f"mrcnn_mask_conv{i}", 3, 3, mask_conv, mask_conv)
        _bn(shapes, f"mrcnn_mask_bn{i}", mask_conv)
    # Conv2DTranspose kernel is [kh, kw, cout, cin] in Keras — square here
    shapes["mrcnn_mask_deconv"] = {"kernel:0": (2, 2, mask_conv, mask_conv),
                                   "bias:0": (mask_conv,)}
    _conv(shapes, "mrcnn_mask", 1, 1, mask_conv, num_classes)
    return shapes
