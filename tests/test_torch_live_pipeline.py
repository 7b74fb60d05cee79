"""The port's LivePipeline against the JAX package's on the CPU, at the
tiny configuration of tests/test_live_pipeline.py and 64^3: the host path
(``run``: prefetch thread, ``step`` with and without the depth filter,
renders every 2 frames) and the device path (``run_device``: upload
thread, device molding, ``label_masks_device``, fusion on device
tensors). Both sides get the same numpy-seeded weights.

The JAX ``mask_detect_device`` hands the molded u8 image to the graph
without subtracting the mean pixel (its ``detect`` and ``run_device`` do
subtract it); the port subtracts it on every path, so the JAX side of the
device-label case runs the same graph as its ``detect`` (``_j_label``).

Bars as tests/test_torch_fusion.py: label masks >= 99.9% equal; weight,
color and diff equal outside the ambiguous voxels (fewer than 0.1% of
the volume differ); histograms equal on >= 99.9% of the voxels; renders
> 99.9% of the pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import default_scene, make_sequence
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.samples.live_pipeline import \
    LivePipeline as JLivePipeline
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
from slam_maskrcnn_tpu_torch.samples.live_pipeline import LivePipeline
from test_torch_fuse import H, K4, W, _ambiguous_voxels
from test_torch_north_star import _configs, _steady_heads, _variables

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

JCFG = JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16)
TCFG = FusionConfig(vol_dim=(64,) * 3)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    jm = JMaskRCNN("inference", jcfg)
    v = _steady_heads(_variables(jm, 5))
    jm.params = jax.tree.map(jnp.asarray, v)
    tm = MaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(v, tm, device="cpu")
    frames = make_sequence(default_scene(), K4, H, W, n_frames=5)
    return jm, tm, frames


def _ambiguous(tf, frames):
    amb = np.zeros((64,) * 3, bool)
    for fr in frames[1:]:
        e2i = (fr["extrinsic"] @ tf.init_extrinsic_inv).astype(np.float32)
        amb |= _ambiguous_voxels(tf.state, e2i, fr["depth"])
    return amb


def _assert_states(jf, tf, frames):
    jd, td = jf.dense_state(), tf.dense_state()
    assert td.n_obs == int(jd.n_obs) == len(frames) - 1
    differ = ((td.weight != np.asarray(jd.weight))
              | (td.color != np.asarray(jd.color)).any(-1)
              | (np.abs(td.diff - np.asarray(jd.diff)) > 2e-6))
    assert not (differ & ~_ambiguous(tf, frames)).any()
    assert differ.mean() < 1e-3
    assert (td.hist == np.asarray(jd.hist)).all(-1).mean() >= 0.999
    assert (td.weight > 0).mean() > 0.05
    return td


def _j_label(model, rgb_image, min_area: int = 2000):
    """JAX mask_detect_device with the mean pixel subtracted, as the JAX
    ``detect`` graph does."""
    from slam_maskrcnn_tpu.models.anchors import get_anchors
    from slam_maskrcnn_tpu.models.mask_ops import label_masks_device

    molded, windows = model.mold_inputs([rgb_image])
    Hm, Wm = molded.shape[1:3]
    scale = np.array([Hm - 1, Wm - 1, Hm - 1, Wm - 1], np.float32)
    nwin = (windows.astype(np.float32) - np.array([0, 0, 1, 1],
                                                  np.float32)) / scale
    out = model._apply_fn()(model.params, jnp.asarray(molded),
                            jnp.asarray(get_anchors(model.config,
                                                    molded.shape[1:])),
                            jnp.asarray(nwin))
    return np.asarray(label_masks_device(
        out["detections"][0], out["masks"][0], jnp.asarray(nwin[0]),
        rgb_image.shape[:2], min_area=min_area))


@pytest.mark.parametrize("depth_filter", [True, False])
def test_run_matches_jax(setup, depth_filter, monkeypatch):
    jm, tm, frames = setup
    monkeypatch.setattr("slam_maskrcnn_tpu.models.mask_ops."
                        "mask_detect_device", _j_label)
    jp = JLivePipeline(jm, K4, JCFG, backend="pallas",
                       use_depth_filter=depth_filter, render_every=2)
    tp = LivePipeline(tm, K4, TCFG, use_depth_filter=depth_filter,
                      render_every=2)
    masks = {}
    for name, p in (("jax", jp), ("port", tp)):
        step = p.step
        masks[name] = []

        def recording(*a, _step=step, _out=masks[name], **kw):
            mask, out = _step(*a, **kw)
            _out.append(np.asarray(mask))
            return mask, out
        p.step = recording
        assert p.run(frames, verbose=False) > 0
    assert tp.frames_done == jp.frames_done == len(frames)
    assert sum(int(m.max()) for m in masks["jax"]) > 0, "no instances kept"
    for a, b in zip(masks["jax"], masks["port"]):
        assert b.dtype == np.uint8 and b.shape == (H, W)
        assert (a == b).mean() >= 0.999
    _assert_states(jp.fusion, tp.fusion, frames)
    assert len(tp.renders) == len(jp.renders) == 2
    for a, b in zip(jp.renders, tp.renders):
        assert (np.asarray(a) == b).all(-1).mean() > 0.999


def test_run_device_matches_jax(setup):
    jm, tm, frames = setup
    jp = JLivePipeline(jm, K4, JCFG, backend="pallas",
                       use_depth_filter=False)
    tp = LivePipeline(tm, K4, TCFG, use_depth_filter=False)
    assert jp.run_device(frames, verbose=False) > 0
    assert tp.run_device(frames, verbose=False) > 0
    assert tp.frames_done == len(frames) and tp.fusion.miss_check_every == 0
    td = _assert_states(jp.fusion, tp.fusion, frames)
    assert td.num_objs == int(jp.fusion.state.num_objs)
