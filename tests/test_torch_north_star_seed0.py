"""Weight seed 0 of test_torch_north_star's tiny model, the seed that
``test_north_star_slice_matches_jax`` leaves out: its frames' detections
differ between the packages only through the trunk's summation order.

On the north-star fixture's frames 1-3 (96x128 molded to 128^2), the JAX
package computes the feature pyramid, the RPN and the proposals; the port
then runs its own ROIAlign, classifier, detection layer and mask head on
those JAX feature maps and proposals (its ``MaskRCNNModule.forward`` with
the trunk and the proposal layer handed the JAX values). The detections
must equal the JAX graph's on the same inputs: the valid flags and class
ids exactly, the boxes within 1e-5, the u8 masks within one level. The
port's own trunk agrees with the JAX one to 1e-4 of the largest
activation, as test_trunk_and_heads_match_jax holds for seed 3: what
the slice test sees at seed 0 is that ulp-level difference moving a
proposal clipped at 1.0 across the feature map's last sample row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import default_scene, make_sequence
from slam_maskrcnn_tpu.fusion.state import make_intrinsic
from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.models.anchors import get_anchors
from slam_maskrcnn_tpu.models.detection import detection_layer as j_detection
from slam_maskrcnn_tpu.models.proposal import generate_proposals as j_props
from slam_maskrcnn_tpu.ops.roi_align import pyramid_roi_align_auto
from slam_maskrcnn_tpu_torch.models import mask_rcnn as tmr
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN as TMaskRCNN
from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
from test_torch_north_star import (_configs, _rel_close, _steady_heads,
                                   _variables)

torch.set_num_threads(2)


def _jax_heads(m, pyramid, anchors, windows):
    """The JAX graph after the trunk (models/mask_rcnn.py ``__call__``):
    RPN, proposals, ROIAlign, classifier, detection layer, mask head, the
    class plane and the u8 quantisation."""
    _, probs, bbox = m.rpn_outputs(pyramid)
    proposals, _ = j_props(probs, bbox, anchors, m.proposal_count,
                           m.rpn_nms_threshold, m.pre_nms_limit,
                           m.rpn_bbox_std)
    feats = pyramid[:4]

    def align(boxes, pool):
        return pyramid_roi_align_auto(tuple(f[0] for f in feats), boxes[0],
                                      pool, m.image_shape)[None]

    _, cprobs, cbbox = jax.vmap(m.classifier)(align(proposals, m.pool_size))
    det, valid = j_detection(proposals, cprobs, cbbox, windows,
                             max_instances=m.detection_max_instances,
                             min_confidence=m.detection_min_confidence,
                             nms_threshold=m.detection_nms_threshold,
                             bbox_std=m.bbox_std)
    masks = jax.vmap(m.mask_head)(align(det[..., :4], m.mask_pool_size))
    cls = det[..., 4].astype(jnp.int32)
    oh = cls[:, :, None] == jnp.arange(m.num_classes)[None, None, :]
    masks = jnp.einsum("bdhwc,bdc->bdhw", masks, oh.astype(masks.dtype))
    return proposals, det, valid, jnp.round(masks * 255.0).astype(jnp.uint8)


@pytest.fixture(scope="module")
def seed0():
    jcfg, tcfg = _configs()
    jm = JMaskRCNN("inference", jcfg)
    v = _steady_heads(_variables(jm, 0))
    jm.params = jax.tree.map(jnp.asarray, v)
    tm = TMaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(v, tm, device="cpu")
    feats = jax.jit(lambda p, x: jm.module.apply(
        p, x, method=lambda m, y: m.features(y)))
    heads = jax.jit(lambda p, pyr, a, w: jm.module.apply(
        p, pyr, a, w, method=_jax_heads))
    return jm, tm, feats, heads


@pytest.mark.parametrize("frame", [1, 2, 3])
def test_heads_on_jax_trunk_match_jax_at_seed0(seed0, frame, monkeypatch):
    jm, tm, feats, heads = seed0
    K4 = make_intrinsic(100.0, 100.0, 64.0, 48.0)
    color = make_sequence(default_scene(), K4, 96, 128, 4)[frame]["color"]
    img = np.pad(color[..., ::-1].astype(np.float32),
                 ((16, 16), (0, 0), (0, 0)))
    img = (img - np.asarray(jm.config.MEAN_PIXEL, np.float32))[None]
    anchors = get_anchors(jm.config, (128, 128, 3))
    win = np.array([[16 / 127, 0.0, 111 / 127, 1.0]], np.float32)
    jpyr = feats(jm.params, jnp.asarray(img))
    jprop, jdet, jvalid, jmask = heads(jm.params, jpyr, jnp.asarray(anchors),
                                       jnp.asarray(win))

    # the port's graph, its trunk and proposal layer replaced by the JAX
    # values
    tpyr = tuple(torch.from_numpy(np.array(p)).permute(0, 3, 1, 2)
                 for p in jpyr)
    monkeypatch.setattr(tm.module, "features", lambda images: tpyr)
    monkeypatch.setattr(tmr, "generate_proposals", lambda *a, **k: (
        torch.from_numpy(np.array(jprop)), None))
    out = tm.module(torch.from_numpy(img), torch.from_numpy(anchors),
                    torch.from_numpy(win))
    np.testing.assert_array_equal(out["detection_valid"].numpy(),
                                  np.asarray(jvalid))
    np.testing.assert_array_equal(out["detections"][..., 4].numpy(),
                                  np.asarray(jdet[..., 4]))
    np.testing.assert_allclose(out["detections"][..., :5].numpy(),
                               np.asarray(jdet[..., :5]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["detections"][..., 5].numpy(),
                               np.asarray(jdet[..., 5]), rtol=0, atol=1e-5)
    diff = np.abs(out["masks"].numpy().astype(int)
                  - np.asarray(jmask).astype(int))
    assert diff.max() <= 1
    assert int(np.asarray(jvalid).sum()) > 0

    # the port's own trunk: ulps from the JAX one
    monkeypatch.undo()
    with torch.no_grad():
        own = tm.module.features(torch.from_numpy(img))
    for a, b in zip(jpyr, own):
        _rel_close(b.permute(0, 2, 3, 1).numpy(), a)
