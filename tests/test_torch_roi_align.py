"""PyramidROIAlign of the PyTorch port, on the CPU (its plain version; the
CUDA kernel is held to the same plain version on the card by
chip_smoke.py): the batched call against per-image calls, the port
against the JAX package's Pallas kernel (interpret mode), and the model's
one-launch-per-head ROIAlign against per-image calls.

Inputs are made from a numpy seed and fed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.ops.pallas.roi_align_kernel import (
    pyramid_roi_align_pallas)
from slam_maskrcnn_tpu.ops.roi_align import roi_level as j_level
from slam_maskrcnn_tpu_torch.models.config import Config
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.ops.roi_align import (_roi_align_cuda,
                                                   pyramid_roi_align)
from test_torch_ops import _roi_boxes

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)


def _pyramid(rng, batch, shape, C):
    """NHWC levels P2..P5 [batch, H / s, W / s, C] for s = 4, 8, 16, 32."""
    return [rng.normal(0, 1, (batch, shape[0] // s, shape[1] // s, C))
            .astype(np.float32) for s in (4, 8, 16, 32)]


@pytest.mark.parametrize("pool,dtype", [(7, torch.float32),
                                        (14, torch.bfloat16)])
def test_batched_equals_per_image(pool, dtype):
    """A batch of 3 images in one call equals the stack of per-image
    calls exactly (rois of every level, some outside [0, 1], some of
    aspect above 4)."""
    rng = np.random.default_rng(pool)
    shape = (256, 512)
    feats = [torch.from_numpy(f).to(dtype) for f in _pyramid(rng, 3, shape,
                                                             16)]
    boxes = torch.from_numpy(np.stack([_roi_boxes(rng, 40)
                                       for _ in range(3)]))
    got = pyramid_roi_align(tuple(feats), boxes, pool, shape)
    assert got.dtype == torch.float32
    assert got.shape == (3, 40, pool, pool, 16)
    want = torch.stack([pyramid_roi_align(tuple(f[b] for f in feats),
                                          boxes[b], pool, shape)
                        for b in range(3)])
    assert torch.equal(got, want)
    lv = np.asarray(j_level(jnp.asarray(boxes.reshape(-1, 4).numpy()),
                            shape))
    assert len(np.unique(lv)) == 4, "fixture must reach every level"


@pytest.mark.parametrize("pool", [7, 14])
def test_matches_jax_pallas_kernel(pool):
    """The port against the JAX package's Pallas kernel, the one its
    inference path picks on the TPU, run as its own tests run it (interpret
    mode, f32): C = 128, 16 boxes of aspect <= 4, some partly outside the
    image, no clamped samples (misses == 0); atol 1e-5. Under jit XLA:CPU
    contracts the kernel's sample-grid multiply-add (one rounding less than
    the port), which moves a sample by up to one ulp (4e-6 at 64 cells);
    the features change by at most ~0.6 from one cell to the next, so that
    stays under 3e-6, while a wrong cell or level moves a value by 0.1 or
    more."""
    rng = np.random.default_rng(30 + pool)
    shape = (256, 256)
    C = 128
    phase = rng.uniform(0, 2 * np.pi, C)
    feats = []
    for s in (4, 8, 16, 32):
        h, w = np.meshgrid(np.arange(shape[0] // s), np.arange(shape[1] // s),
                           indexing="ij")
        feats.append(np.sin(0.37 * h[..., None] + 0.23 * w[..., None]
                            + phase).astype(np.float32))
    n = 16
    centre = rng.uniform(-0.05, 1.05, (n, 2))
    size = np.exp(rng.uniform(np.log(0.03), np.log(1.0), (n, 1)))
    aspect = np.exp(rng.uniform(np.log(0.25), np.log(4.0), (n, 1)))
    hw = np.concatenate([size * np.sqrt(aspect), size / np.sqrt(aspect)], 1)
    boxes = np.concatenate([centre - hw / 2, centre + hw / 2],
                           1).astype(np.float32)
    want, misses = pyramid_roi_align_pallas(
        tuple(map(jnp.asarray, feats)), jnp.asarray(boxes), pool, shape,
        compute_dtype=jnp.float32, return_misses=True)
    assert int(misses) == 0
    got = pyramid_roi_align(tuple(map(torch.from_numpy, feats)),
                            torch.from_numpy(boxes), pool, shape).numpy()
    assert got.shape == (n, pool, pool, C)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    levels = np.asarray(j_level(jnp.asarray(boxes), shape))
    assert len(np.unique(levels)) >= 3, "fixture must reach three levels"


class _Tiny(Config):
    NAME = "tiny"
    BACKBONE = "resnet50"
    IMAGE_MIN_DIM = 128
    IMAGE_MAX_DIM = 128
    NUM_CLASSES = 4
    IMAGES_PER_GPU = 1
    GPU_COUNT = 1
    COMPUTE_DTYPE = "float32"


def test_model_roi_align_one_call_per_head():
    """MaskRCNN's ROIAlign takes the whole batch in one call, on NHWC views
    of the channels-last NCHW levels, and equals per-image calls."""
    module = MaskRCNN("inference", _Tiny(), device="cpu").module
    rng = np.random.default_rng(4)
    shape = module.image_shape
    # what the FPN gives: NCHW tensors in channels-last memory
    feats = [torch.from_numpy(f).permute(0, 3, 1, 2)
             for f in _pyramid(rng, 2, shape, 256)]
    assert all(f.is_contiguous(memory_format=torch.channels_last)
               for f in feats)
    boxes = torch.from_numpy(np.stack([_roi_boxes(rng, 12)
                                       for _ in range(2)]))
    for pool in (module.pool_size, module.mask_pool_size):
        got = module._roi_align(feats, boxes, pool)
        want = torch.stack([
            pyramid_roi_align(tuple(f[b].permute(1, 2, 0) for f in feats),
                              boxes[b], pool, shape) for b in range(2)])
        assert got.shape == (2, 12, pool, pool, 256)
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad,match", [
    (dict(C=12), "C % 8"),
    (dict(C=16, pool=65), "pool size"),
    (dict(C=16, boxes_shape=(5, 4)), r"\[B, N, 4\]"),
    (dict(C=16, dtype=torch.float16), "f32 or bf16")])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """The CUDA wrapper checks its arguments before it builds or launches
    anything (so these run on the CPU): channels a multiple of 8 (16-byte
    loads), pool 1..64, boxes [B, N, 4], f32 or bf16 features."""
    C = bad["C"]
    feats = tuple(torch.zeros(1, 8 // k, 8 // k, C,
                              dtype=bad.get("dtype", torch.float32))
                  for k in (1, 2, 4, 8))
    boxes = torch.zeros(bad.get("boxes_shape", (1, 5, 4)))
    with pytest.raises((ValueError, TypeError), match=match):
        _roi_align_cuda(feats, boxes, bad.get("pool", 7), (32, 32))
