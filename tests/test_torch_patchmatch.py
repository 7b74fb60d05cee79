"""The port's PatchMatch (sfm/patchmatch.py) against the JAX package's on
the CPU, on tests/test_samples.py's two fixtures (a 40 x 80 constant
shift, patch 7, 4 iterations; a 40 x 96 slanted plane, patch 7, 6
iterations), both seeded.

Bars: the same plane initialisation bit for bit (the draws are the
reference's); ``disp`` within 1e-3 px of the JAX module's on at least 99%
of pixels (the bilateral weight's exp may differ by an ulp between numpy
and torch, which can flip a near-tied plane choice); each fixture's own
recovery assertion holds for the port.
"""

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.sfm import PatchMatch as JPatchMatch
from slam_maskrcnn_tpu_torch.sfm import PatchMatch

torch.set_num_threads(2)

DISP_TOL = 1e-3        # px
MIN_SHARE = 0.99


def _shift():
    rng = np.random.default_rng(3)
    right = (rng.random((40, 80)) * 255).astype(np.float32)
    right = cv2.GaussianBlur(right, (5, 5), 1.2)
    return np.roll(right, 6, axis=1), right, 4


def _slant():
    rng = np.random.default_rng(5)
    right = (rng.random((40, 96)) * 255).astype(np.float32)
    right = cv2.GaussianBlur(right, (5, 5), 1.2)
    xs = np.arange(96, dtype=np.float32)
    d_true = 3.0 + xs * 0.08
    left = np.empty_like(right)
    for y in range(right.shape[0]):
        left[y] = np.interp(xs - d_true, xs, right[y],
                            left=right[y, 0], right=right[y, -1])
    return left, right, 6


FIXTURES = {"shift": _shift, "slant": _slant}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def pair(request):
    left, right, iters = FIXTURES[request.param]()
    j = JPatchMatch(left, right, patch=7, max_disp=16, seed=0)
    t = PatchMatch(left, right, patch=7, max_disp=16, seed=0, device="cpu")
    init = (j.fp.copy(), t.fp.numpy().copy())
    jd = j.run(iters=iters)
    td = t.run(iters=iters).numpy()
    return request.param, init, jd, td


def test_same_initial_planes(pair):
    _, (jf, tf), _, _ = pair
    np.testing.assert_array_equal(tf, jf)


def test_disp_matches_jax(pair):
    name, _, jd, td = pair
    assert td.dtype == np.float32 and td.shape == jd.shape
    share = float((np.abs(td - jd) <= DISP_TOL).mean())
    assert share >= MIN_SHARE, (name, share)


def test_recovers_the_fixture(pair):
    name, _, _, td = pair
    if name == "shift":
        assert abs(np.median(td[10:-10, 20:-10]) - 6) < 1.5
    else:
        d_true = 3.0 + np.arange(96, dtype=np.float32) * 0.08
        err = np.abs(td[8:-8, 16:-8] - d_true[None, 16:-8])
        assert np.median(err) < 1.2


def test_cost_and_laplacian_match_jax():
    """One cost call on the initial planes, and the Laplacians, with the
    color (3-channel) path."""
    rng = np.random.default_rng(7)
    left = (rng.random((24, 40, 3)) * 255).astype(np.float32)
    right = np.roll(left, 3, axis=1)
    j = JPatchMatch(left, right, patch=5, max_disp=8, alpha=0.3, seed=1)
    t = PatchMatch(left, right, patch=5, max_disp=8, alpha=0.3, seed=1,
                   device="cpu")
    np.testing.assert_array_equal(t.lap_l.numpy(), j.lap_l)
    np.testing.assert_array_equal(t.fp.numpy(), j.fp)
    np.testing.assert_allclose(t._cost(t.fp).numpy(), j._cost(j.fp),
                               rtol=1e-5, atol=1e-3)


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PatchMatch(np.zeros((8, 8)), np.zeros((8, 8)))
