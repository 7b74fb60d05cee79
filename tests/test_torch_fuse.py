"""PyTorch port's TSDF fuse vs the JAX package's blocked Pallas fuse
(fuse_frame_blocked_impl, interpret mode on the CPU), at 64^3 with a K=32
u16 histogram.

Bars: weight, histogram and color bit-equal and |diff delta| <= 2e-6 on
every voxel but a few (< 0.1%), each of them ambiguous: in some fused
frame its projection lies within 1e-4 px of a pixel edge, or its distance
within 1e-5 of the cull or color-gate threshold. There one rounding
decides, and
the two sides round differently: XLA:CPU contracts the projection's
multiply-adds into FMAs (the port and its --fmad=false kernel do not), and
at the image border the JAX kernel's per-block visibility test (block
corners projected in XLA) can drop a voxel that its per-voxel arithmetic
would fuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import default_scene, make_sequence
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion.state import make_intrinsic
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import (
    fuse_frame_blocked_impl, init_blocked_from_first_frame, to_dense as j_dense)
from slam_maskrcnn_tpu_torch.fusion.fuse import (fuse_frame, fuse_params,
                                                 from_dense,
                                                 init_from_first_frame,
                                                 to_dense)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

H, W = 96, 128
K4 = make_intrinsic(100.0, 100.0, W / 2, H / 2)
JCFG = JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16)
TCFG = FusionConfig(vol_dim=(64,) * 3)
EDGE_PX = 1e-4     # projection this close to a pixel edge is ambiguous
EDGE_D = 1e-5      # distance this close to a threshold is ambiguous


@pytest.fixture(scope="module")
def frames():
    return make_sequence(default_scene(), K4, H, W, n_frames=4)


@pytest.fixture(scope="module")
def j_fuse():
    return jax.jit(lambda b, d, c, m, e: fuse_frame_blocked_impl(
        b, d, c, m, e, jnp.asarray(K4), JCFG))


def _ambiguous_voxels(vol, e2i, depth):
    """Voxels where one rounding decides the update (see the module
    docstring), from the kernel's f32 constants evaluated in f64."""
    p = fuse_params(vol, e2i, K4, TCFG).astype(np.float64)
    g = np.arange(64, dtype=np.float64)
    gx, gy, gz = g[:, None, None], g[None, :, None], g[None, None, :]
    px, py, pz = (p[9 + r] + p[r] * gx + p[3 + r] * gy + p[6 + r] * gz
                  for r in range(3))
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (p[12] * px + p[14] * pz) / pz
        v = (p[13] * py + p[15] * pz) / pz
    edge = lambda a: np.abs(a - np.round(a)) < EDGE_PX
    amb = (edge(u) | edge(v)) & (pz > 0)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (pz > 0)
    ui = np.clip(np.floor(np.where(inside, u, 0)), 0, W - 1).astype(int)
    vi = np.clip(np.floor(np.where(inside, v, 0)), 0, H - 1).astype(int)
    dm = depth[vi, ui] / TCFG.depth_scale - pz
    mu = float(vol.mu)
    dn = np.minimum(dm, mu) / mu
    amb |= inside & ((np.abs(dm + mu) < EDGE_D)
                     | (np.abs(dn - TCFG.color_diff_gate) < EDGE_D))
    return amb


def _assert_same(jstate, tvol, ambiguous):
    """Every voxel where the two sides differ is ambiguous, and they are a
    tiny fraction of the volume."""
    jd, td = j_dense(jstate, JCFG), to_dense(tvol)
    differ = ((np.asarray(jd.weight) != td.weight)
              | (np.asarray(jd.hist) != td.hist).any(-1)
              | (np.asarray(jd.color) != td.color).any(-1)
              | (np.abs(np.asarray(jd.diff) - td.diff) > 2e-6))
    unexplained = np.argwhere(differ & ~ambiguous)
    assert len(unexplained) == 0, f"voxels differ: {unexplained[:10]}"
    assert differ.mean() < 1e-3, f"{differ.sum()} voxels differ"
    assert int(jd.n_obs) == td.n_obs


def test_geometry_matches_jax(frames):
    f0 = frames[0]
    b = init_blocked_from_first_frame(JCFG, f0["depth"], K4,
                                      f0["mean_depth"])
    v = init_from_first_frame(TCFG, f0["depth"], K4, f0["mean_depth"],
                              device="cpu")
    np.testing.assert_array_equal(np.asarray(b.vol_start), v.vol_start)
    np.testing.assert_array_equal(np.asarray(b.voxel), v.voxel)
    assert np.float32(np.asarray(b.mu)) == v.mu
    np.testing.assert_array_equal(np.asarray(j_dense(b, JCFG).diff),
                                  to_dense(v).diff)


def test_fuse_sequence_matches_jax(frames, j_fuse):
    f0 = frames[0]
    b = init_blocked_from_first_frame(JCFG, f0["depth"], K4,
                                      f0["mean_depth"])
    v = init_from_first_frame(TCFG, f0["depth"], K4, f0["mean_depth"],
                              device="cpu")
    E0i = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    edge = np.zeros((64,) * 3, bool)
    for fr in frames[1:]:
        e = (fr["extrinsic"] @ E0i).astype(np.float32)
        b, miss = j_fuse(b, jnp.asarray(fr["depth"]), jnp.asarray(fr["color"]),
                         jnp.asarray(fr["mask"]), jnp.asarray(e))
        assert int(miss) == 0
        edge |= _ambiguous_voxels(v, e, fr["depth"])
        fuse_frame(v, torch.from_numpy(fr["depth"]),
                   torch.from_numpy(fr["color"]),
                   torch.from_numpy(fr["mask"]), e, K4, TCFG)
    td = to_dense(v)
    assert (td.weight > 0).mean() > 0.1, "fixture must fuse"
    assert len(np.unique(td.hist.argmax(-1))) >= 3, "several ids voted"
    _assert_same(b, v, edge)


def test_camera_inside_volume_matches_jax(frames, j_fuse):
    """Camera at the volume centre: blocks straddle the camera plane (the
    JAX kernel's escalation passes); the port's z > 0 guard is per voxel."""
    f0 = frames[0]
    b = init_blocked_from_first_frame(JCFG, f0["depth"], K4,
                                      f0["mean_depth"])
    v = init_from_first_frame(TCFG, f0["depth"], K4, f0["mean_depth"],
                              device="cpu")
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = -0.5 * (v.vol_start + v.vol_end)
    b, miss = j_fuse(b, jnp.asarray(f0["depth"]), jnp.asarray(f0["color"]),
                     jnp.asarray(f0["mask"]), jnp.asarray(E))
    assert int(miss) == 0
    edge = _ambiguous_voxels(v, E, f0["depth"])
    fuse_frame(v, torch.from_numpy(f0["depth"]), torch.from_numpy(f0["color"]),
               torch.from_numpy(f0["mask"]), E, K4, TCFG)
    assert (to_dense(v).weight > 0).sum() > 1000
    _assert_same(b, v, edge)


def test_dense_round_trip_from_jax_state(frames, j_fuse):
    """from_dense(JAX TSDFState) -> to_dense is lossless, histogram counts
    above 32767 included (u16 counts stored in int16 bits)."""
    f0 = frames[0]
    b = init_blocked_from_first_frame(JCFG, f0["depth"], K4,
                                      f0["mean_depth"])
    b, _ = j_fuse(b, jnp.asarray(f0["depth"]), jnp.asarray(f0["color"]),
                  jnp.asarray(f0["mask"]), jnp.asarray(np.eye(4, dtype=np.float32)))
    jd = j_dense(b, JCFG)
    hist = np.asarray(jd.hist).copy()
    hist[0, 0, 0, :3] = (40000, 65535, 32768)
    jd = jd.replace(hist=jnp.asarray(hist))
    td = to_dense(from_dense(jd, device="cpu"))
    for f in ("diff", "color", "weight", "hist"):
        np.testing.assert_array_equal(getattr(td, f),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    assert td.hist.dtype == np.uint16 and td.n_obs == int(jd.n_obs)
