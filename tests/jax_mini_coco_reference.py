"""The JAX package's mini-COCO score on the CPU, in float32: the reference
the port's card score is held to (chip_smoke.py ``MINI_COCO_JAX_AP50``).

    JAX_PLATFORMS=cpu python tests/jax_mini_coco_reference.py \\
        --dir build/mini_coco_ref

Generates the 120-image tree (``make_mini_coco``, seed 0, 128^2; the port
writes the same pixels and JSON, tests/test_torch_samples.py), loads
weights/shapes_r2_f16.h5 into the JAX package's shapes model with
COMPUTE_DTYPE float32, and runs its ``run_protocol`` (COCOevalLite bbox
and segm). Prints the stats as one JSON line. Not collected by pytest: it
is a reference run, about a minute on a CPU.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from slam_maskrcnn_tpu.data.shapes import ShapesConfig
    from slam_maskrcnn_tpu.models import MaskRCNN
    from slam_maskrcnn_tpu.samples.coco import CocoDataset
    from slam_maskrcnn_tpu.samples.mini_coco import (make_mini_coco,
                                                     run_protocol)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", default=os.path.join(REPO, "build",
                                                 "mini_coco_ref"))
    p.add_argument("--weights", default=os.path.join(
        REPO, "weights", "shapes_r2_f16.h5"))
    a = p.parse_args()
    make_mini_coco(a.dir, 120, 128, seed=0)

    class MiniInferenceConfig(ShapesConfig):
        NAME = "mini_coco"
        GPU_COUNT = 1
        IMAGES_PER_GPU = 1
        COMPUTE_DTYPE = "float32"

    ds = CocoDataset()
    ds.load_coco(a.dir, "val", "2014")
    ds.prepare()
    model = MaskRCNN("inference", MiniInferenceConfig())
    model.load_weights(a.weights, by_name=True)
    stats = run_protocol(ds, lambda i: model.detect([ds.load_image(i)])[0],
                         verbose=False)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
