"""PyTorch port vs the JAX package: weight carry, Mask R-CNN trunk and
heads stage by stage, and the north-star slice end to end (detect ->
label -> depth probe -> associate -> fuse, render mode "none").

The weights are made from a numpy seed in the Flax variable layout, used
as they are by the JAX model and carried into the port by
models/weights.load_jax_params. Everything runs in float32 on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as nn

from slam_maskrcnn_tpu.data.synthetic import default_scene, make_sequence
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion.state import make_intrinsic
from slam_maskrcnn_tpu.models import Config as JConfig, MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.models.anchors import get_anchors
from slam_maskrcnn_tpu.models.detection import detection_layer as j_detection
from slam_maskrcnn_tpu.models.mask_ops import label_masks_device as j_label
from slam_maskrcnn_tpu.models.proposal import generate_proposals as j_props
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import (
    init_blocked_from_first_frame, to_dense as j_dense)
from slam_maskrcnn_tpu.ops.roi_align import pyramid_roi_align as j_roi
from slam_maskrcnn_tpu.samples.north_star import NorthStar as JNorthStar
from slam_maskrcnn_tpu_torch.fusion.fuse import init_from_first_frame, to_dense
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.models.config import Config as TConfig
from slam_maskrcnn_tpu_torch.models.detection import \
    detection_layer as t_detection
from slam_maskrcnn_tpu_torch.models.heads import ConvTranspose
from slam_maskrcnn_tpu_torch.models.mask_ops import \
    label_masks_device as t_label
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN as TMaskRCNN
from slam_maskrcnn_tpu_torch.models.proposal import \
    generate_proposals as t_props
from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
from slam_maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align as t_roi
from slam_maskrcnn_tpu_torch.samples.north_star import NorthStar
from test_torch_fuse import _ambiguous_voxels

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

TINY = dict(NAME="tiny", BACKBONE="resnet50", IMAGE_MIN_DIM=128,
            IMAGE_MAX_DIM=128, NUM_CLASSES=4,
            RPN_ANCHOR_SCALES=(8, 16, 32, 64, 128),
            POST_NMS_ROIS_INFERENCE=50, PRE_NMS_LIMIT=200,
            DETECTION_MAX_INSTANCES=10, IMAGES_PER_GPU=1, GPU_COUNT=1,
            DETECTION_MIN_CONFIDENCE=0.0, COMPUTE_DTYPE="float32")


def _configs(**over):
    attrs = dict(TINY, **over)
    return (type("JTiny", (JConfig,), attrs)(),
            type("TTiny", (TConfig,), attrs)())


def _variables(jmodel, seed):
    """numpy-seeded variables in the Flax layout of `jmodel` (shapes from
    jax.eval_shape, so nothing is initialised by JAX)."""
    cfg = jmodel.config
    shape = tuple(int(s) for s in cfg.IMAGE_SHAPE[:2])
    anchors = get_anchors(cfg, cfg.IMAGE_SHAPE)
    tree = jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1,) + shape + (3,)), jnp.asarray(anchors),
                          jnp.zeros((1, 4)))
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shp = path[-1].key, sds.shape
        if name == "kernel":
            v = rng.normal(0, 1 / math.sqrt(math.prod(shp[:-1])), shp)
        elif name == "bias":
            v = rng.normal(0, 0.05, shp)
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, shp)
        else:
            v = rng.normal(0, 0.1, shp)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _steady_heads(v):
    """Keep the random heads out of saturation: small class/box/mask
    kernels, class 1 favoured, detection boxes widened and masks biased on,
    so detections are few, large and well separated in score."""
    cls, mask = v["params"]["fpn_classifier"], v["params"]["fpn_mask"]
    cls["mrcnn_class_logits"]["kernel"] *= 0.02
    cls["mrcnn_class_logits"]["bias"][1] += 4.0
    cls["mrcnn_bbox_fc"]["kernel"] *= 0.02
    cls["mrcnn_bbox_fc"]["bias"][6:8] += 10.0
    mask["mrcnn_mask"]["kernel"] *= 0.05
    mask["mrcnn_mask"]["bias"] += 3.0
    rpn = v["params"]["rpn_model"]
    rpn["rpn_class_raw"]["kernel"] *= 0.05
    rpn["rpn_bbox_pred"]["kernel"] *= 0.05
    return v


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    jm = JMaskRCNN("inference", jcfg)
    v = _steady_heads(_variables(jm, 3))
    jm.params = jax.tree.map(jnp.asarray, v)
    tm = TMaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(v, tm, device="cpu")
    return jm, tm, v


def _rel_close(got, want, rtol=1e-4):
    """|got - want| <= rtol * max|want| (scale-relative: random trunks give
    activations in the hundreds, summed in another order than XLA's)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_weight_carry_is_strict(backbone):
    jcfg, tcfg = _configs(BACKBONE=backbone)
    v = _variables(JMaskRCNN("inference", jcfg), 1)
    tm = TMaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(v, tm, device="cpu")
    n_leaves = len(jax.tree.leaves(v))
    n_port = (len(list(tm.module.parameters()))
              + len(list(tm.module.buffers())))
    assert n_leaves == n_port
    w = tm.module.resnet.Bottleneck_0.res2a_branch2b.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        v["params"]["resnet"]["Bottleneck_0"]["res2a_branch2b"]["kernel"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        tm.module.fpn_classifier.mrcnn_class_logits.weight.detach().numpy(),
        v["params"]["fpn_classifier"]["mrcnn_class_logits"]["kernel"].T)
    np.testing.assert_array_equal(
        tm.module.resnet.bn_conv1.var.numpy(),
        v["batch_stats"]["resnet"]["bn_conv1"]["bn"]["var"])

    del v["params"]["fpn"]["fpn_p2"]["bias"]               # unwritten port
    with pytest.raises(KeyError, match="unwritten"):
        load_jax_params(v, tm, device="cpu")
    v["params"]["fpn"]["fpn_p2"]["bias"] = np.zeros(256, np.float32)
    v["params"]["fpn"]["extra"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(v, tm, device="cpu")


def test_conv_transpose_matches_flax():
    """Flax's ConvTranspose does not flip its kernel, PyTorch's does: the
    carry flips it (models/weights.py)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    k = rng.normal(size=(2, 2, 3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = nn.ConvTranspose(4, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": k, "bias": b}}, x)
    m = ConvTranspose(3, 4, 2)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])))
        m.bias.copy_(torch.from_numpy(b))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_trunk_and_heads_match_jax(models):
    """Stage by stage on shared inputs: each stage gets the JAX side's
    previous output, so a difference is the stage's own."""
    jm, tm, v = models
    jv = jm.params
    K4 = make_intrinsic(100.0, 100.0, 64.0, 48.0)
    color = make_sequence(default_scene(), K4, 96, 128, 2)[1]["color"]
    img = np.pad(color[..., ::-1].astype(np.float32), ((16, 16), (0, 0),
                                                        (0, 0)))
    img = (img - np.asarray(jm.config.MEAN_PIXEL, np.float32))[None]
    cfg = jm.config
    anchors = get_anchors(cfg, (128, 128, 3))
    win = np.array([[16 / 127, 0.0, 111 / 127, 1.0]], np.float32)
    ti = torch.from_numpy(img)

    jpyr = jm.module.apply(jv, jnp.asarray(img),
                           method=lambda m, x: m.features(x))
    with torch.no_grad():
        tpyr = tm.module.features(ti)
    for a, b in zip(jpyr, tpyr):
        _rel_close(b.permute(0, 2, 3, 1).numpy(), a)

    _, jprobs, jbbox = jm.module.apply(
        jv, jpyr, method=lambda m, p: m.rpn_outputs(p))
    with torch.no_grad():
        _, tprobs, tbbox = tm.module.rpn_outputs(
            [torch.from_numpy(np.asarray(p)).permute(0, 3, 1, 2)
             for p in jpyr])
    _rel_close(tprobs.numpy(), jprobs)
    _rel_close(tbbox.numpy(), jbbox)

    # proposals from the same RPN outputs
    kw = dict(proposal_count=cfg.POST_NMS_ROIS_INFERENCE, nms_threshold=0.7,
              pre_nms_limit=cfg.PRE_NMS_LIMIT)
    jp, jpv = j_props(jprobs, jbbox, jnp.asarray(anchors), **kw)
    tp, tpv = t_props(torch.from_numpy(np.asarray(jprobs)),
                      torch.from_numpy(np.asarray(jbbox)),
                      torch.from_numpy(anchors), **kw)
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-4)

    # classifier + detection layer from the same proposals and features
    feats = tuple(np.asarray(p)[0] for p in jpyr[:4])
    with jax.disable_jit():   # the exact f32 oracle (see test_torch_ops)
        jpool = j_roi(tuple(map(jnp.asarray, feats)), jp[0], 7, (128, 128))
    tpool = t_roi(tuple(map(torch.from_numpy, feats)),
                  torch.from_numpy(np.asarray(jp[0])), 7, (128, 128))
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=0,
                               atol=1e-5 * float(np.abs(jpool).max()))
    _, jcp, jcb = jm.module.apply(jv, jpool,
                                  method=lambda m, x: m.classifier(x))
    with torch.no_grad():
        _, tcp, tcb = tm.module.fpn_classifier(
            torch.from_numpy(np.asarray(jpool)))
    _rel_close(tcp.numpy(), jcp)
    _rel_close(tcb.numpy(), jcb)
    dkw = dict(max_instances=cfg.DETECTION_MAX_INSTANCES, min_confidence=0.0,
               nms_threshold=0.3)
    jd, jdv = j_detection(jp, jcp[None], jcb[None], jnp.asarray(win), **dkw)
    td, tdv = t_detection(torch.from_numpy(np.asarray(jp)),
                          torch.from_numpy(np.asarray(jcp))[None],
                          torch.from_numpy(np.asarray(jcb))[None],
                          torch.from_numpy(win), **dkw)
    np.testing.assert_array_equal(tdv.numpy(), np.asarray(jdv))
    np.testing.assert_array_equal(td[..., 4].numpy(), np.asarray(jd[..., 4]))
    np.testing.assert_allclose(td[..., :4].numpy(), np.asarray(jd[..., :4]),
                               rtol=0, atol=1e-4)
    assert int(tdv.sum()) > 0

    # mask head + class-plane select + u8, then the label image
    with jax.disable_jit():
        jmp = j_roi(tuple(map(jnp.asarray, feats)), jd[0, :, :4], 14,
                    (128, 128))
    jmask = jm.module.apply(jv, jmp, method=lambda m, x: m.mask_head(x))
    with torch.no_grad():
        tmask = tm.module.fpn_mask(torch.from_numpy(np.asarray(jmp)))
    _rel_close(tmask.numpy(), jmask)
    cls = np.asarray(jd[0, :, 4]).astype(int)
    ju8 = np.round(np.take_along_axis(
        np.asarray(jmask), cls[:, None, None, None], 3)[..., 0] * 255
    ).astype(np.uint8)
    jl = np.asarray(j_label(jd[0], jnp.asarray(ju8), jnp.asarray(win[0]),
                            (96, 128), min_area=2000))
    tl = t_label(torch.from_numpy(np.asarray(jd[0])), torch.from_numpy(ju8),
                 torch.from_numpy(win[0]), (96, 128), min_area=2000)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert len(np.unique(jl)) >= 2, "fixture must label something"


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_north_star_slice_matches_jax(seed):
    """The slice end to end on make_sequence frames (96x128, 64^3,
    probe_mode="depth", probe_stride=2) against the JAX NorthStar step with
    render_mode="none", for three weight seeds. Frame 0 sizes the volume;
    frame 1 fuses without association, frames 2-3 associate.

    A box clipped to exactly 1.0 samples its last ROIAlign row on the
    feature map's last row, where one rounding of the sample grid decides
    whether the row reads the map or 0. XLA compiles the grid's division
    by (pool - 1) into a multiplication by a folded f32 constant and its
    origin + k * step into one fused rounding; the port computes the grid
    the same way (ops/roi_align.py ``sample_grid``, and the kernel), so
    these edges agree on equal proposals and no detection is excused. The
    proposals themselves come from the trunk, whose summation order
    differs by ulps between the packages: a proposal clipped at 1.0 whose
    last sample lands within an ulp of the last row can still read the map
    on one side and 0 on the other (seed 0 of these weights; seeds 1-6
    are clear; ROADMAP.md C)."""
    jcfg, tcfg = _configs()
    jm = JMaskRCNN("inference", jcfg)
    v = _steady_heads(_variables(jm, seed))
    jm.params = jax.tree.map(jnp.asarray, v)
    tm = TMaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(v, tm, device="cpu")
    H, W = 96, 128
    K4 = make_intrinsic(100.0, 100.0, W / 2, H / 2)
    frames = make_sequence(default_scene(), K4, H, W, n_frames=4)
    jcfg = JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16,
                         probe_mode="depth", probe_stride=2)
    tcfg = FusionConfig(vol_dim=(64,) * 3, probe_mode="depth", probe_stride=2)
    f0 = frames[0]
    js = init_blocked_from_first_frame(jcfg, f0["depth"], K4,
                                       f0["mean_depth"])
    ts = init_from_first_frame(tcfg, f0["depth"], K4, f0["mean_depth"],
                               device="cpu")
    jns = JNorthStar(jm, K4, jcfg, H, W, render_mode="none")
    tns = NorthStar(tm, K4, tcfg, H, W, render_mode="none")
    E0i = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    ids = set()
    ambiguous = np.zeros((64,) * 3, bool)
    for fr in frames[1:]:
        e = (fr["extrinsic"] @ E0i).astype(np.float32)
        ambiguous |= _ambiguous_voxels(ts, e, fr["depth"])
        js, _, jmg, miss = jns.step(js, jnp.asarray(fr["depth"]),
                                    jnp.asarray(fr["color"]), jnp.asarray(e),
                                    0.0, 1.0)
        ts, trender, tmg, tmiss = tns.step(
            ts, torch.from_numpy(fr["depth"]), torch.from_numpy(fr["color"]),
            e, 0.0, 1.0)
        assert trender.shape == (H, W, 3) and not trender.any()
        jmg = np.asarray(jmg)
        assert tmg.dtype == torch.uint8 and tmg.shape == (H, W)
        assert (tmg.numpy() == jmg).mean() >= 0.999
        assert int(miss) == 0 and int(tmiss) == 0
        ids |= set(np.unique(jmg).tolist())
    assert len(ids) >= 2, f"fixture must label an instance: {ids}"
    jd, td = j_dense(js, jcfg), to_dense(ts)
    assert int(jd.num_objs) == td.num_objs and td.n_obs == int(jd.n_obs)
    # weight, color and diff agree as in test_torch_fuse (bit-equal /
    # 2e-6 but for a few ambiguous voxels); the histogram on >= 99.9%
    differ = ((td.weight != np.asarray(jd.weight))
              | (td.color != np.asarray(jd.color)).any(-1)
              | (np.abs(td.diff - np.asarray(jd.diff)) > 2e-6))
    assert not (differ & ~ambiguous).any() and differ.mean() < 1e-3
    assert (td.hist == np.asarray(jd.hist)).all(-1).mean() >= 0.999
