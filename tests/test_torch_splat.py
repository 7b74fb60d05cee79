"""PyTorch port's splat render, probes and march oracle vs the JAX
package's, on the CPU at 64^3.

One volume is fused by the JAX package (XLA backend, ground-truth masks)
and carried into the port with ``from_dense``, so both sides render the
same state; a second, analytic sphere volume is the fixture of
tests/test_splat.py. The port enumerates the shell in the JAX package's
blocked order with the same budgets, so winners agree wherever the
projection agrees. Bars: exact where the JAX side is evaluated op by op
(``jax.disable_jit``); under jit XLA:CPU contracts the projection's
multiply-adds, so a voxel whose projected pixel centre lies within ~1e-4
px of .5 may land in the neighbouring pixel: renders are held to > 99.9%
of pixels there, counters to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import default_scene, make_sequence
from slam_maskrcnn_tpu.fusion import (FusionConfig as JFusionConfig,
                                      SemanticFusion as JFusion,
                                      init_state as j_init_state)
from slam_maskrcnn_tpu.fusion import raycast as jray
from slam_maskrcnn_tpu.fusion import splat as jsplat
from slam_maskrcnn_tpu.fusion.state import make_intrinsic
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import to_blocked
from slam_maskrcnn_tpu_torch.fusion import raycast as tray
from slam_maskrcnn_tpu_torch.fusion import splat as tsplat
from slam_maskrcnn_tpu_torch.fusion.fuse import from_dense
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

H, W = 96, 128
K4 = make_intrinsic(110.0, 110.0, W / 2, H / 2)
JCFG = JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16)
TCFG = FusionConfig(vol_dim=(64,) * 3)


def _cfgs(**kw):
    return (JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16, **kw),
            FusionConfig(vol_dim=(64,) * 3, **kw))


@pytest.fixture(scope="module")
def fused():
    """(JAX dense state, blocked state, port volume, e2i of a later frame)
    after 5 frames of the default scene."""
    frames = make_sequence(default_scene(), K4, H, W, n_frames=6)
    f = JFusion(K4, JCFG, backend="xla")
    for fr in frames[:5]:
        f.parse_frame(fr["depth"], fr["color"], fr["mask"], fr["extrinsic"],
                      fr["mean_depth"])
    state = f.dense_state()
    E0i = np.linalg.inv(frames[0]["extrinsic"]).astype(np.float32)
    e2i = (frames[5]["extrinsic"] @ E0i).astype(np.float32)
    return (state, to_blocked(state, JCFG), from_dense(state, device="cpu"),
            e2i, frames[0]["mean_depth"])


@pytest.fixture(scope="module")
def sphere():
    """The analytic sphere volume of tests/test_splat.py on both sides."""
    state = j_init_state(JCFG, [-0.6, -0.6, 0.4], [0.6, 0.6, 1.6])
    vs, vx = np.asarray(state.vol_start), np.asarray(state.voxel)
    ii, jj, kk = np.meshgrid(*[np.arange(64)] * 3, indexing="ij")
    pts = vs + np.stack([ii, jj, kk], -1) * vx
    sdf = np.linalg.norm(pts - np.array([0.0, 0.0, 1.0]), axis=-1) - 0.25
    sdfn = np.clip(sdf / float(state.mu), -1, 1).astype(np.float32)
    hist = np.asarray(state.hist).copy()
    hist[sdfn < 0, 1] = 7
    hist[0, 0, 0, 3] = 40000             # a count above the int16 range
    color = np.asarray(state.color).copy()
    color[sdfn < 0] = [10, 200, 30]
    state = state.replace(diff=jnp.asarray(sdfn), hist=jnp.asarray(hist),
                          color=jnp.asarray(color),
                          n_obs=jnp.asarray(5, jnp.int32))
    return state, to_blocked(state, JCFG), from_dense(state, device="cpu")


def _dense_ids(vid_blocked, shape=(64, 64, 64)):
    """JAX blocked voxel ids (blk * 2048 + vlin) -> dense linear ids."""
    v = np.asarray(vid_blocked).astype(np.int64)
    nby, nbz = shape[1] // 8, shape[2] // 32
    blk, vlin = np.maximum(v, 0) // 2048, np.maximum(v, 0) % 2048
    gx = (blk // (nbz * nby)) * 8 + vlin // 256
    gy = ((blk // nbz) % nby) * 8 + (vlin // 32) % 8
    gz = (blk % nbz) * 32 + vlin % 32
    return np.where(v >= 0, (gx * shape[1] + gy) * shape[2] + gz, -1)


@pytest.mark.parametrize("angle,dist", [(0.0, 1.0), (0.35, 1.5),
                                        (-0.2, 0.8)])
def test_pinhole_of_orbit_matches_jax(angle, dist):
    jM, jm4 = jsplat.pinhole_of_orbit(angle, dist, jnp.asarray(K4))
    tM, tm4 = tsplat.pinhole_of_orbit(angle, dist, K4)
    # f32 sin/cos and a 3-term sum in another order: a few ulp of ~100
    np.testing.assert_allclose(tM, np.asarray(jM), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tM / 110.0, np.asarray(jM) / 110.0, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tm4 / 110.0, np.asarray(jm4) / 110.0, rtol=0,
                               atol=1e-6)
    jE = jsplat.pinhole_of_extrinsic(jnp.eye(4), jnp.asarray(K4))
    tE = tsplat.pinhole_of_extrinsic(np.eye(4), K4)
    np.testing.assert_array_equal(tE[0], np.asarray(jE[0]))
    np.testing.assert_array_equal(tE[1], np.asarray(jE[1]))


def test_zbuffer_winners_exact_op_by_op(fused):
    """With the JAX side evaluated op by op (no FMA contraction) the
    z-buffer, the winner voxels and the counters are equal: the blocked
    enumeration order and the tie-break are reproduced."""
    _, b, vol, e2i, _ = fused
    M, m4 = tsplat.pinhole_of_extrinsic(e2i, K4)
    for row_cap in (0, 24):
        with jax.disable_jit():
            jz, jv, jo, jc = jsplat.splat_zbuffer(
                b, jnp.asarray(M), jnp.asarray(m4), H, W, 2048, 256 * 1024,
                16384, 0.999, row_cap, fill=True)
        tz, tv, to, tc = tsplat.splat_zbuffer(vol, M, m4, H, W, 2048,
                                              256 * 1024, 16384, 0.999,
                                              row_cap, fill=True)
        assert (np.asarray(jv) >= 0).sum() > 2000
        np.testing.assert_array_equal(tv.numpy(), _dense_ids(jv))
        # the dequantized depth only feeds emptiness tests: one ulp
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6)
        assert int(to) == int(jo) == 0 and int(tc) == int(jc)
        assert (int(tc) > 0) == (row_cap > 0)


@pytest.mark.parametrize("mode", ["instance", "color"])
@pytest.mark.parametrize("row_cap", [0, 24])
def test_splat_render_matches_jax(fused, mode, row_cap):
    """Jitted JAX render, sensor camera and orbit camera: > 99.9% of the
    pixels equal (see the module docstring), and something is drawn."""
    _, b, vol, e2i, dist = fused
    jcfg, tcfg = _cfgs(splat_row_cap=row_cap)
    M, m4 = tsplat.pinhole_of_extrinsic(e2i, K4)
    want = np.asarray(jsplat.splat_render(b, jnp.asarray(M), jnp.asarray(m4),
                                          H, W, jcfg, mode=mode))
    got = tsplat.splat_render(vol, M, m4, H, W, tcfg, mode=mode).numpy()
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert (want.max(-1) > 0).mean() > 0.1
    assert (got == want).all(-1).mean() > 0.999
    want = np.asarray(jsplat.splat_render_orbit(b, 0.2, dist, jnp.asarray(K4),
                                                H, W, jcfg, mode=mode))
    got = tsplat.splat_render_orbit(vol, 0.2, dist, K4, H, W, tcfg,
                                    mode=mode).numpy()
    assert (want.max(-1) > 0).mean() > 0.1
    assert (got == want).all(-1).mean() > 0.999


def test_candidates_match_jax(fused):
    """select_candidates + splat_from_candidates: the candidate set and the
    winners it renders at a later angle (op by op: exact)."""
    _, b, vol, _, dist = fused
    cap = 20
    M0, m40 = tsplat.pinhole_of_orbit(0.0, dist, K4)
    M1, m41 = tsplat.pinhole_of_orbit(0.03, dist, K4)
    with jax.disable_jit():
        jrows = jsplat._compact_shell(b.diff, b.vol_start, b.voxel, b.nby,
                                      b.nbz, 2048, 16384, 0.999)
        jcodes, jovf, jclip = jsplat.select_candidates(
            jrows, jnp.asarray(M0), jnp.asarray(m40), cap)
        jz, jv = jsplat.splat_from_candidates(
            jcodes, b.vol_start, b.voxel, b.nby, b.nbz, jnp.asarray(M1),
            jnp.asarray(m41), H, W)
    trows = tsplat._compact_shell(vol, 2048, 16384, 0.999)
    tcodes, tovf, tclip = tsplat.select_candidates(trows, M0, m40, cap)
    assert tcodes.shape == (16384 * cap,) and int((tcodes >= 0).sum()) > 5000
    np.testing.assert_array_equal(tcodes.numpy(), _dense_ids(jcodes))
    assert int(tovf) == int(jovf) == 0 and int(tclip) == int(jclip) > 0
    dec = tsplat.decode_candidates(tcodes, vol)
    tz, tv = tsplat.splat_from_candidates(tcodes, vol, M1, m41, H, W,
                                          decoded=dec)
    np.testing.assert_array_equal(tv.numpy(), _dense_ids(jv))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6)
    tz2, tv2 = tsplat.splat_from_candidates(tcodes, vol, M1, m41, H, W)
    assert torch.equal(tv2, tv) and torch.equal(tz2, tz)


def test_splat_probe_matches_jax(fused):
    """splat_probe under jit: probs equal on > 99.9% of the pixels, the
    box masks follow, no overflow."""
    _, b, vol, e2i, _ = fused
    jp, jb, jo, _ = jsplat.splat_probe(b, jnp.asarray(e2i), jnp.asarray(K4),
                                       H, W, JCFG)
    tp, tb, to, _ = tsplat.splat_probe(vol, e2i, K4, H, W, TCFG)
    assert tp.shape == (H, W, 32) and tp.dtype == torch.float32
    same = (tp.numpy() == np.asarray(jp)).all(-1)
    assert same.mean() > 0.999 and np.asarray(jp).sum() > 1000
    assert (tb.numpy() == np.asarray(jb)).all(-1).mean() > 0.999
    assert int(to) == int(jo) == 0


@pytest.mark.parametrize("max_rows,max_blocks", [(8, 4096), (4096, 4096),
                                                 (4096, 20)])
def test_budget_overflow_counts_match_jax(sphere, max_rows, max_blocks):
    """No silent caps: with a budget set too small the overflow equals the
    JAX count (and feeds the miss channel); with room it is 0."""
    _, b, vol = sphere
    M, m4 = tsplat.pinhole_of_extrinsic(np.eye(4), K4)
    for row_cap in (0, 8):
        _, _, jo, jc = jsplat.splat_zbuffer(
            b, jnp.asarray(M), jnp.asarray(m4), H, W, max_blocks=max_blocks,
            max_rows=max_rows, row_cap=row_cap)
        _, _, to, tc = tsplat.splat_zbuffer(vol, M, m4, H, W,
                                            max_blocks=max_blocks,
                                            max_rows=max_rows,
                                            row_cap=row_cap)
        assert int(to) == int(jo) and int(tc) == int(jc)
        assert (int(to) > 0) == ((max_rows, max_blocks) != (4096, 4096))


def test_orbit_renderer_equals_uncached(sphere):
    _, b, vol = sphere
    orb = tsplat.OrbitRenderer(vol, K4, H, W, TCFG)
    jorb = jsplat.OrbitRenderer(b, K4, H, W, JCFG)
    for k, mode in ((1, "instance"), (3, "color")):
        want = tsplat.splat_render_orbit(vol, 0.05 * k, 1.5, K4, H, W, TCFG,
                                         mode=mode)
        got = orb.render(0.05 * k, 1.5, mode=mode)
        assert torch.equal(got, want) and int((got.max(-1)[0] > 0).sum()) > 200
        jgot = np.asarray(jorb.render(0.05 * k, 1.5, mode=mode))
        assert (got.numpy() == jgot).all(-1).mean() > 0.999
    centre = orb.render(0.0, 1.0, mode="color")[H // 2, W // 2]
    assert centre.tolist() == [30, 200, 10]     # stored BGR, rendered RGB


def test_splat_silhouette_against_own_march(sphere):
    """The bar of tests/test_splat.py: the splat and the port's own
    ray-march render agree on the sphere's silhouette and color."""
    _, _, vol = sphere
    march = tray.render_orbit(vol, 0.35, 1.0, np.linalg.inv(K4), H, W,
                              TCFG).numpy()
    M, m4 = tsplat.pinhole_of_orbit(0.35, 1.0, K4)
    splat = tsplat.splat_render(vol, M, m4, H, W, TCFG).numpy()
    a, s = march.max(-1) > 0, splat.max(-1) > 0
    assert (a | s).sum() > 200
    assert (a & s).sum() / (a | s).sum() > 0.85
    both = a & s
    assert (march[both] == splat[both]).all(-1).mean() > 0.95
    zb, vid, _, _ = tsplat.splat_zbuffer(
        vol, *tsplat.pinhole_of_extrinsic(np.eye(4), K4), H, W)
    patch = zb.view(H, W)[H // 2 - 2:H // 2 + 3, W // 2 - 2:W // 2 + 3]
    assert abs(float(patch.min()) - 0.75) < 0.05    # sphere front, 1 - 0.25
    # the 1-px hole fill only adds winners
    _, hv, _, _ = tsplat.splat_zbuffer(
        vol, *tsplat.pinhole_of_extrinsic(np.eye(4), K4), H, W, fill=True)
    assert int((hv >= 0).sum()) > int((vid >= 0).sum())
    assert torch.equal(hv[vid >= 0], vid[vid >= 0])


def test_march_oracle_matches_jax(sphere, fused):
    """trilinear, ray_march, the march probe and the march render against
    the JAX ones (atol 1e-5: the same f32 formulas, summed in one order)."""
    state, _, vol = sphere
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.3, 1.7, (500, 3)).astype(np.float32) \
        * np.array([1, 1, 1], np.float32) - np.array([0.9, 0.9, 0], np.float32)
    for jv, tv, kw in ((state.diff, vol.diff, {}),
                       (state.hist, vol.hist, dict(unsigned=True)),
                       (state.color.astype(jnp.float32),
                        vol.color.float(), {})):
        want = jray.trilinear(jv, state.vol_start, state.voxel,
                              jnp.asarray(pos))
        got = tray.trilinear(tv, vol.vol_start, vol.voxel,
                             torch.from_numpy(pos), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5 * max(1.0, float(
                                       np.abs(want).max())))
    Ki = np.linalg.inv(K4).astype(np.float32)
    d = tray.camera_rays(Ki, H, W, device="cpu")
    np.testing.assert_allclose(d.numpy(),
                               np.asarray(jray.camera_rays(jnp.asarray(Ki),
                                                           H, W)), atol=1e-6)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.zeros(3)
    jhit, jt = jray.ray_march(state, jnp.zeros(3), jnp.asarray(d.numpy()),
                              JCFG)
    thit, tt = tray.ray_march(vol, o, d, TCFG)
    assert int(thit.sum()) > 500
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    jp, jb = jray.back_project_probe(state, jnp.eye(4), jnp.asarray(Ki), H, W,
                                     JCFG)
    tp, tb = tray.back_project_probe(vol, np.eye(4), Ki, H, W, TCFG)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-3)
    assert (tb.numpy() == np.asarray(jb)).mean() > 0.9999
    # the march render of the fused volume, both modes
    fstate, _, fvol, _, dist = fused
    for mode in ("instance", "color"):
        want = np.asarray(jray.render_orbit(fstate, 0.1, dist,
                                            jnp.asarray(Ki), H, W, JCFG,
                                            mode=mode))
        got = tray.render_orbit(fvol, 0.1, dist, Ki, H, W, TCFG,
                                mode=mode).numpy()
        assert (want.max(-1) > 0).mean() > 0.2
        assert (got == want).all(-1).mean() > 0.995
