"""PyTorch port vs the JAX package: NMS, ROIAlign, box ops and molding
resize, on the CPU (the ports' plain versions; the CUDA kernels are held
against the same plain versions on the card by chip_smoke.py).

Inputs are made from a numpy seed and fed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.ops import boxes as jboxes
from slam_maskrcnn_tpu.ops.nms import non_max_suppression as j_nms
from slam_maskrcnn_tpu.ops.pallas.nms_kernel import (
    non_max_suppression_pallas as j_nms_pallas)
from slam_maskrcnn_tpu.ops.roi_align import pyramid_roi_align as j_roi
from slam_maskrcnn_tpu.ops.roi_align import roi_level as j_level
from slam_maskrcnn_tpu_torch.ops import boxes as tboxes
from slam_maskrcnn_tpu_torch.ops.nms import (
    NMS_MAX_N, check_nms_size, nms_sorted_suppression_plain,
    non_max_suppression as t_nms)
from slam_maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align as t_roi
from slam_maskrcnn_tpu_torch.samples.north_star import resize_bilinear
from slam_maskrcnn_tpu_torch.testing import nms_edge_cases


# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)


def _boxes(rng, n):
    yx = rng.uniform(0.0, 0.9, (n, 2))
    hw = rng.uniform(0.01, 0.3, (n, 2))
    return np.concatenate([yx, yx + hw], 1).astype(np.float32)


@pytest.mark.parametrize("cap,thr", [(100, 0.7), (10, 0.3)])
def test_nms_matches_jax(cap, thr):
    """Indices and validity exactly equal, with exactly tied scores
    (ties go to the lower index on both sides)."""
    rng = np.random.default_rng(cap)
    n = 600
    b = _boxes(rng, n)
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[rng.choice(n, 200, replace=False)] = 0.5       # a block of exact ties
    s[:20] = s[20:40]                                 # pairwise ties
    ji, jv = j_nms(jnp.asarray(b), jnp.asarray(s), cap, thr)
    ti, tv = t_nms(torch.from_numpy(b), torch.from_numpy(s), cap, thr)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert tv.sum() > 0


def test_nms_score_threshold_and_exhaustion():
    """Fewer live boxes than slots: trailing slots are (0, invalid) on
    both sides; scores at or below the threshold never select."""
    rng = np.random.default_rng(7)
    b = _boxes(rng, 50)
    s = rng.uniform(-1, 1, 50).astype(np.float32)
    ji, jv = j_nms(jnp.asarray(b), jnp.asarray(s), 40, 0.5, 0.0)
    ti, tv = t_nms(torch.from_numpy(b), torch.from_numpy(s), 40, 0.5, 0.0)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert 0 < int(tv.sum()) < 40


def test_nms_batched_equals_per_image():
    rng = np.random.default_rng(3)
    b = np.stack([_boxes(rng, 120) for _ in range(2)])
    s = rng.uniform(0, 1, (2, 120)).astype(np.float32)
    bi, bv = t_nms(torch.from_numpy(b), torch.from_numpy(s), 30, 0.5)
    for k in range(2):
        i, v = t_nms(torch.from_numpy(b[k]), torch.from_numpy(s[k]), 30, 0.5)
        np.testing.assert_array_equal(bi[k].numpy(), i.numpy())
        np.testing.assert_array_equal(bv[k].numpy(), v.numpy())


_EDGE_CASES = nms_edge_cases()


@pytest.mark.parametrize("case", _EDGE_CASES,
                         ids=[c[0].replace(" ", "_") for c in _EDGE_CASES])
def test_nms_edge_cases_match_jax(case):
    """The seeded edge cases that the argmax kernel is held to on the card
    (``slam_maskrcnn_tpu_torch.testing.nms_edge_cases``: sizes 1 to 8192,
    max_output above n, nothing over the score threshold, identical boxes,
    exact score ties, IoUs exactly on the threshold and a few ulp beside
    it, a batch): here the plain version against the JAX package, indices
    and validity equal in every image."""
    name, boxes, scores, cap, thr, sthr = case
    ti, tv = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), cap,
                   thr, sthr)
    assert ti.shape == tv.shape == (boxes.shape[0], cap)
    for i in range(boxes.shape[0]):
        ji, jv = j_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), cap,
                       thr, sthr)
        np.testing.assert_array_equal(np.asarray(jv), tv[i].numpy(), name)
        np.testing.assert_array_equal(np.asarray(ji), ti[i].numpy(), name)
    if "under the threshold" in name:
        assert int(tv.sum()) == 0
    elif "the same" in name:
        assert int(tv.sum()) == 1
    elif "on the threshold" in name:
        # of the 9 pairs placed around the threshold some are kept and
        # some are suppressed
        assert boxes.shape[1] - 9 < int(tv.sum()) < boxes.shape[1]


def test_nms_kernel_size_limit():
    """The argmax kernel keeps every box in a register of one block: the
    wrapper's check takes 8192 boxes an image and refuses 8193."""
    assert NMS_MAX_N == 8192
    check_nms_size(1)
    check_nms_size(NMS_MAX_N)
    with pytest.raises(ValueError, match="8192"):
        check_nms_size(NMS_MAX_N + 1)


@pytest.mark.parametrize("n,cap,thr,sthr", [
    (300, 64, 0.7, float("-inf")),     # n not a multiple of 128
    (200, 200, 0.3, 0.4),              # a score threshold, cap > kept count
    (130, 10, 0.5, float("-inf"))])
def test_nms_sorted_variant_matches_argmax_and_jax(n, cap, thr, sthr):
    """variant="sorted" (stable sort, suppression mask, cut) selects what
    variant="argmax" selects and what the JAX package's sorted Pallas
    kernel (interpret mode) selects: indices and validity exactly equal,
    with exact score ties (to the lower index on every side)."""
    rng = np.random.default_rng(n)
    b = _boxes(rng, n)
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[rng.choice(n, n // 3, replace=False)] = 0.5     # a block of exact ties
    s[:20] = s[20:40]                                  # pairwise ties
    tb, ts = torch.from_numpy(b), torch.from_numpy(s)
    si, sv = t_nms(tb, ts, cap, thr, sthr, variant="sorted")
    ai, av = t_nms(tb, ts, cap, thr, sthr, variant="argmax")
    ji, jv = j_nms_pallas(jnp.asarray(b), jnp.asarray(s), cap, thr, sthr,
                          variant="sorted")
    assert si.dtype == torch.int64 and sv.dtype == torch.bool
    assert torch.equal(sv, av) and torch.equal(si, ai)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    assert 0 < int(sv.sum()) and (cap != 200 or int(sv.sum()) < cap)
    bi, bv = t_nms(tb[None].repeat(2, 1, 1), ts[None].repeat(2, 1), cap, thr,
                   sthr, variant="sorted")
    assert torch.equal(bi[1], si) and torch.equal(bv[0], sv)
    with pytest.raises(ValueError, match="variant"):
        t_nms(tb, ts, cap, thr, sthr, variant="other")


def test_nms_sorted_suppression_mask():
    """The kernel's plain version on sorted boxes: a box is suppressed iff
    an earlier kept box overlaps it; a suppressed box suppresses nothing."""
    b = torch.tensor([[0.0, 0.0, 1.0, 1.0],      # kept
                      [0.0, 0.0, 1.0, 0.9],      # killed by 0 (IoU 0.9)
                      [0.0, 0.0, 1.0, 0.55],     # IoU 0.55 with 0, 0.61 w/ 1
                      [2.0, 2.0, 3.0, 3.0]])     # apart
    assert nms_sorted_suppression_plain(b, 0.6).tolist() == [0, 1, 0, 0]
    assert nms_sorted_suppression_plain(b, 0.5).tolist() == [0, 1, 1, 0]


def test_box_ops_match_jax():
    rng = np.random.default_rng(1)
    b1, b2 = _boxes(rng, 30), _boxes(rng, 40)
    d = rng.normal(0, 0.3, (30, 4)).astype(np.float32)
    win = np.array([0.1, 0.05, 0.9, 0.95], np.float32)
    np.testing.assert_allclose(
        tboxes.compute_iou_matrix(torch.from_numpy(b1),
                                  torch.from_numpy(b2)).numpy(),
        np.asarray(jboxes.compute_iou_matrix(jnp.asarray(b1),
                                             jnp.asarray(b2))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tboxes.apply_box_deltas(torch.from_numpy(b1),
                                torch.from_numpy(d)).numpy(),
        np.asarray(jboxes.apply_box_deltas(jnp.asarray(b1), jnp.asarray(d))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tboxes.clip_boxes(torch.from_numpy(b1 * 1.2 - 0.1),
                          torch.from_numpy(win)).numpy(),
        np.asarray(jboxes.clip_boxes(jnp.asarray(b1 * 1.2 - 0.1),
                                     jnp.asarray(win))))


def _roi_boxes(rng, n):
    """Boxes of every FPN level, some partly outside [0, 1], some with an
    aspect ratio above 4."""
    c = rng.uniform(-0.1, 1.1, (n, 2))
    size = np.exp(rng.uniform(np.log(0.02), np.log(1.2), (n, 1)))
    aspect = np.exp(rng.uniform(-1.0, 1.0, (n, 1)))
    aspect[: n // 4] = rng.choice([0.15, 6.0], (n // 4, 1))   # aspect > 4
    hw = np.concatenate([size * np.sqrt(aspect), size / np.sqrt(aspect)], 1)
    return np.concatenate([c - hw / 2, c + hw / 2], 1).astype(np.float32)


@pytest.mark.parametrize("pool", [7, 14])
def test_pyramid_roi_align_matches_jax(pool):
    """4 levels, C = 16: atol 1e-5 against ops/roi_align.pyramid_roi_align
    as the JAX package runs it, jitted. XLA folds the sample grid's
    division by (pool - 1) and the level's by 224 / sqrt(area) into
    multiplications by f32 constants and fuses the grid's origin + k *
    step into one rounding; the port computes the grid alike
    (``sample_grid``)."""
    rng = np.random.default_rng(pool)
    shape = (512, 1024)
    feats = [rng.normal(0, 1, (shape[0] // s, shape[1] // s, 16))
             .astype(np.float32) for s in (4, 8, 16, 32)]
    b = _roi_boxes(rng, 120)
    want = np.asarray(j_roi(tuple(jnp.asarray(f) for f in feats),
                            jnp.asarray(b), pool, shape))
    got = t_roi(tuple(torch.from_numpy(f) for f in feats),
                torch.from_numpy(b), pool, shape).numpy()
    assert got.dtype == np.float32 and got.shape == (120, pool, pool, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    lv = np.asarray(j_level(jnp.asarray(b), shape))
    assert len(np.unique(lv)) == 4, "fixture must reach every level"


def test_pyramid_roi_align_bf16_features():
    """bf16 features are read as stored and summed in f32: the same as
    feeding their f32 upcast."""
    rng = np.random.default_rng(5)
    shape = (64, 64)
    feats = [torch.from_numpy(rng.normal(0, 1, (64 // s, 64 // s, 8))
                              .astype(np.float32)).to(torch.bfloat16)
             for s in (4, 8, 16, 32)]
    b = torch.from_numpy(_roi_boxes(rng, 40))
    got = t_roi(tuple(feats), b, 7, shape)
    want = t_roi(tuple(f.float() for f in feats), b, 7, shape)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("size", [(768, 1024), (24, 32), (60, 50)])
def test_resize_bilinear_matches_jax_image_resize(size):
    """Device molding's resize: upscaling (no antialias) and downscaling
    (antialias) against jax.image.resize(..., "bilinear")."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), size + (3,),
                                       method="bilinear"))
    got = resize_bilinear(torch.from_numpy(img), *size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
