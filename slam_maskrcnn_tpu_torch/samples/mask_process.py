"""Batch mask generation, stage 1 of the two-stage pipeline.

Port of slam_maskrcnn_tpu/samples/mask_process.py (= ``Mask_RCNN/
mask_process.py``): the COCO inference config (GPU_COUNT=1,
IMAGES_PER_GPU=1, :57-61), then sorted rgb/*.png -> mask_detect -> a
label-encoded mask/<name>.png each (:94-105), stage 2's input (pixel
value = instance id, 0 = background).

    python -m slam_maskrcnn_tpu_torch.samples.mask_process \\
        --rgb seq/rgb --out seq/mask [--depth seq/depth] [--weights w.h5]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rgb", required=True, help="input rgb folder")
    p.add_argument("--out", required=True, help="output mask folder")
    p.add_argument("--depth", default=None,
                   help="optional depth folder for depth filtering")
    p.add_argument("--weights", default=None,
                   help="Keras .h5 weights; seeded random weights if "
                        "omitted (for smoke tests)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from slam_maskrcnn_tpu_torch.models.mask_ops import batch_mask_process
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.samples.coco import CocoInferenceConfig

    model = MaskRCNN("inference", CocoInferenceConfig(), device=a.device)
    if a.weights:
        model.load_weights(a.weights, by_name=True)
    else:
        model.init_params()
    n = batch_mask_process(model, a.rgb, a.out, a.depth)
    print(f"wrote {n} masks to {a.out}")
    return n


if __name__ == "__main__":
    main()
