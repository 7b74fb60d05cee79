"""The port's two-view SfM (sfm/two_view.py) against the JAX package's on
the CPU, on the synthetic three-plane scene (sfm/scene.py, 480 x 640).

Bars: ``triangulate`` equal to the JAX function's to 1e-9 (DLT and
Gauss-Newton, and without refinement); with the JAX package's own E,
``estimate_rt_from_e`` gives its (R, t) to 1e-9 and the same votes;
end to end, ``slam_two_view`` against the JAX one: the match counts
within 5%, R within 0.5 degree, t within 1 degree, the positive-depth
votes within 2%, the ground truth recovered (R within 1 degree, t within
2), and the disparity's median |difference| at most 0.5 px where both
are valid (each after its own rectification); the sfm modules import
with jax, cv2 and the JAX package blocked.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.sfm import estimate_rt_from_e as j_rt
from slam_maskrcnn_tpu.sfm import slam_two_view as j_two_view
from slam_maskrcnn_tpu.sfm import triangulate as j_tri
from slam_maskrcnn_tpu_torch.sfm import (estimate_rt_from_e, slam_two_view,
                                         triangulate)
from slam_maskrcnn_tpu_torch.sfm.scene import rotation, two_view_scene

torch.set_num_threads(2)


def _deg(R1, R2):
    c = (np.trace(R1.T @ R2) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def _tdeg(a, b):
    a, b = np.ravel(a) / np.linalg.norm(a), np.ravel(b) / np.linalg.norm(b)
    return float(np.degrees(np.arccos(np.clip(abs(a @ b), -1, 1))))


@pytest.fixture(scope="module")
def runs():
    img1, img2, K, R, t = two_view_scene(0)
    j = j_two_view(img1, img2, K)
    p = slam_two_view(img1, img2, K, device="cpu")
    return dict(K=K, R=R, t=t, jax=j, port=p)


def test_end_to_end_against_jax(runs):
    j, p = runs["jax"], runs["port"]
    nj, nport = len(j["matches"][0]), len(p["matches"][0])
    assert abs(nport - nj) <= 0.05 * nj and nj >= 100
    assert _deg(p["R"], j["R"]) <= 0.5
    assert _tdeg(p["t"], j["t"]) <= 1.0
    vj, vp = j["positive_depth_votes"], p["positive_depth_votes"]
    assert abs(vp - vj) <= 0.02 * vj
    assert _deg(p["R"], runs["R"]) <= 1.0 and _tdeg(p["t"], runs["t"]) <= 2.0
    assert p["points"].shape == (nport, 3)
    assert np.isfinite(p["points"]).all()


def test_disparity_against_jax(runs):
    """SGBM's disparity after each package's own rectification: the median
    |difference| at most 0.5 px where both are valid."""
    dj = runs["jax"]["disparity"]
    dp = runs["port"]["disparity"].numpy()
    assert dp.shape == dj.shape == (480, 640) and dp.dtype == np.float32
    both = (dj >= 0) & (dp >= 0)
    assert both.mean() > 0.3
    assert np.median(np.abs(dp[both] - dj[both])) <= 0.5


def test_rt_from_the_jax_e(runs):
    """The JAX package's E and inliers fed to the port's
    estimate_rt_from_e: its (R, t) and votes."""
    j = runs["jax"]
    p1, p2 = j["matches"]
    import cv2
    E, m = cv2.findEssentialMat(p1, p2, runs["K"], method=cv2.RANSAC,
                                prob=0.999, threshold=1.0)
    sel = m.ravel() > 0
    Rj, tj, vj = j_rt(E, p1[sel], p2[sel], runs["K"])
    Rp, tp, vp = estimate_rt_from_e(E, p1[sel], p2[sel], runs["K"],
                                    device="cpu")
    assert vp == vj
    np.testing.assert_allclose(Rp, Rj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-9)


@pytest.mark.parametrize("gn_iters", [0, 5])
def test_triangulate_equals_jax(gn_iters):
    rng = np.random.default_rng(6)
    X = rng.uniform([-1, -1, 2], [1, 1, 5], (200, 3))
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([rotation(0.05, -0.1, 0.02), [[-0.4], [0.05], [0.1]]])
    proj = lambda P: ((np.column_stack([X, np.ones(len(X))]) @ P.T)[:, :2]
                      / (np.column_stack([X, np.ones(len(X))]) @ P.T)[:, 2:])
    x1 = proj(P1) + rng.normal(0, 1e-3, (200, 2))
    x2 = proj(P2) + rng.normal(0, 1e-3, (200, 2))
    want = j_tri(P1, P2, x1, x2, gn_iters=gn_iters)
    got = triangulate(P1, P2, x1, x2, gn_iters=gn_iters, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_too_few_matches_raise():
    blank = np.zeros((64, 64), np.uint8)
    with pytest.raises(ValueError, match="too few matches"):
        slam_two_view(blank, blank, np.eye(3), depth_estimate=False,
                      device="cpu")


def test_sfm_imports_without_jax_or_cv2():
    code = (
        "import sys\n"
        "for m in ('jax', 'cv2', 'slam_maskrcnn_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import slam_maskrcnn_tpu_torch.sfm\n"
        "import slam_maskrcnn_tpu_torch.sfm.two_view\n"
        "import slam_maskrcnn_tpu_torch.sfm.scene\n"
        "import slam_maskrcnn_tpu_torch.ops.sift\n"
        "import slam_maskrcnn_tpu_torch.ops.match\n"
        "import slam_maskrcnn_tpu_torch.ops.essential\n"
        "import slam_maskrcnn_tpu_torch.ops.rectify\n"
        "import slam_maskrcnn_tpu_torch.ops.sgbm\n"
        "import slam_maskrcnn_tpu_torch.ops.warp\n"
        "import slam_maskrcnn_tpu_torch.parallel.sharding\n"
        "import slam_maskrcnn_tpu_torch.fusion.raycast\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m == 'slam_maskrcnn_tpu' or m.startswith('slam_maskrcnn_tpu.'))]\n"
        "assert not bad, bad\nprint('OK')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
