"""The port's dense ("xla") fusion path against the JAX package's on the
CPU: ``SemanticFusion(backend="xla")`` at 64^3 with a u16 and a u32
histogram, ``fuse_frame_dense`` in majority-vote mode, ``fuse_sequence``
and ``fuse_sequence_blocked`` against their per-frame steps, volume
snapshots of either package loaded by the other (u32 and majority-vote
included), and the u16 store's refusal of a count above 65535.

Bars: relabeled masks, weight, color, histogram and the majority-vote
fields bit-equal; |diff delta| <= 2e-6. The dense path mirrors the JAX
``fuse_frame`` operation by operation; on these sequences no voxel lies
close enough to a pixel edge for XLA:CPU's FMA contraction to move it.
The JAX ``fuse_frame`` jitted alone contracts otherwise: there the few
voxels that differ (< 0.1%) must each be ambiguous, their projection
within 1e-4 px of a pixel edge or their distance within 1e-5 of the cull
or color gate, as tests/test_torch_fuse.py holds the kernel path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import (default_scene, hard_scene,
                                              hard_sequence, make_sequence)
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion import SemanticFusion as JFusion
from slam_maskrcnn_tpu.fusion.checkpoint import (load_volume as j_load_vol,
                                                 save_volume as j_save_vol)
from slam_maskrcnn_tpu.fusion.fuse import fuse_frame as j_fuse_frame
from slam_maskrcnn_tpu.fusion.state import (
    init_from_first_frame as j_init_first, make_intrinsic)
from slam_maskrcnn_tpu_torch.fusion import state as tstate
from slam_maskrcnn_tpu_torch.fusion.checkpoint import load_volume, save_volume
from slam_maskrcnn_tpu_torch.fusion.fuse import (fuse_frame_dense,
                                                 init_from_first_frame,
                                                 to_dense)
from slam_maskrcnn_tpu_torch.fusion.pipeline import (SemanticFusion,
                                                     fuse_sequence,
                                                     fuse_sequence_blocked,
                                                     fusion_step,
                                                     fusion_step_dense)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

H, W = 96, 128
K4 = make_intrinsic(100.0, 100.0, W / 2, H / 2)
DIM = (64,) * 3
DIFF_TOL = 2e-6
HIST = {"u16": (jnp.uint16, np.uint16), "u32": (jnp.uint32, np.uint32)}


@pytest.fixture(scope="module")
def hard_frames():
    return hard_sequence(hard_scene(), K4, H, W, n_frames=6)


@pytest.fixture(scope="module")
def fused(hard_frames):
    """Both packages' xla SemanticFusion over the stress sequence (ids that
    churn, a camera pushing into the volume), per histogram dtype: the
    JAX fusion, the port's, and the relabeled masks of each frame."""
    out = {}
    for name, (jd, td) in HIST.items():
        jf = JFusion(K4, JFusionConfig(vol_dim=DIM, hist_dtype=jd),
                     backend="xla")
        tf = SemanticFusion(K4, FusionConfig(vol_dim=DIM, hist_dtype=td),
                            backend="xla", device="cpu")
        masks = []
        for fr in hard_frames:
            args = (fr["depth"], fr["color"], fr["mask"], fr["extrinsic"],
                    fr["mean_depth"])
            masks.append((jf.parse_frame(*args), tf.parse_frame(*args)))
        out[name] = jf, tf, masks
    return out


def _assert_state_equal(jstate, td, fields=("color", "weight", "hist")):
    for f in fields:
        a, b = np.asarray(getattr(jstate, f)), getattr(td, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert np.abs(td.diff - np.asarray(jstate.diff)).max() <= DIFF_TOL
    assert td.n_obs == int(jstate.n_obs)
    assert td.num_objs == int(jstate.num_objs)


@pytest.mark.parametrize("hist", ["u16", "u32"])
def test_semantic_fusion_xla_matches_jax(fused, hist):
    jf, tf, masks = fused[hist]
    assert masks[0] == (None, None)
    ids = set()
    for jm, tm in masks[1:]:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        ids |= set(np.unique(np.asarray(jm)).tolist())
    assert len(ids) >= 10, f"association must see the churning ids: {ids}"
    td = tf.dense_state()
    assert td.hist.dtype == HIST[hist][1]
    assert tf.state.hist.dtype == tstate.HIST_STORE[np.dtype(HIST[hist][1])]
    _assert_state_equal(jf.state, td)
    assert (td.weight > 0).sum() > 10000


def _ambiguous_dense(state, e2i, depth, cfg):
    """Voxels of the dense path where one rounding decides the update: the
    JAX fuse_frame's projection evaluated in f64."""
    E = np.asarray(e2i, np.float64)
    g = [np.asarray(state.vol_start[a], np.float64)
         + np.arange(n) * np.float64(state.voxel[a])
         for a, n in enumerate(state.diff.shape)]
    gx, gy, gz = g[0][:, None, None], g[1][None, :, None], g[2][None, None]
    px, py, pz = (E[r, 0] * gx + E[r, 1] * gy + E[r, 2] * gz + E[r, 3]
                  for r in range(3))
    Kd = np.asarray(K4, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (Kd[0, 0] * px + Kd[0, 2] * pz) / pz
        v = (Kd[1, 1] * py + Kd[1, 2] * pz) / pz
    edge = lambda a: np.abs(a - np.round(a)) < 1e-4
    amb = (edge(u) | edge(v)) & (pz > 0)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (pz > 0)
    ui = np.clip(np.floor(np.where(inside, u, 0)), 0, W - 1).astype(int)
    vi = np.clip(np.floor(np.where(inside, v, 0)), 0, H - 1).astype(int)
    dm = depth[vi, ui] / cfg.depth_scale - pz
    mu = float(state.mu)
    dn = np.minimum(dm, mu) / mu
    return amb | (inside & ((np.abs(dm + mu) < 1e-5)
                            | (np.abs(dn - cfg.color_diff_gate) < 1e-5)))


def test_majority_vote_fuse_matches_jax():
    """fuse_frame_dense in majority-vote mode against the JAX fuse_frame
    (jitted alone) over a sequence whose mask ids change from frame to
    frame: mv_id, mv_cnt, color and weight equal but on ambiguous voxels
    (see the module docstring), the placeholder hist, and the Boyer-Moore
    counter both rising and falling."""
    frames = make_sequence(default_scene(), K4, H, W, n_frames=5)
    jcfg = JFusionConfig(vol_dim=DIM, majority_vote=True)
    tcfg = FusionConfig(vol_dim=DIM, majority_vote=True)
    f0 = frames[0]
    js = j_init_first(jcfg, f0["depth"], K4, f0["mean_depth"])
    ts = tstate.init_from_first_frame(tcfg, f0["depth"], K4,
                                      f0["mean_depth"], device="cpu")
    assert tuple(ts.hist.shape) == (1, 1, 1, 1)
    e0 = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    j_fuse = jax.jit(j_fuse_frame, static_argnames=("cfg",))
    cnt_prev = None
    ambiguous = np.zeros(DIM, bool)
    for k, fr in enumerate(frames):
        # ids shift with the frame so that voxels see disagreeing votes
        mask = np.where(fr["mask"] > 0, (fr["mask"] + k % 2) % 32,
                        0).astype(np.uint8)
        e2i = (fr["extrinsic"] @ e0).astype(np.float32)
        ambiguous |= _ambiguous_dense(ts, e2i, fr["depth"], tcfg)
        js = j_fuse(js, jnp.asarray(fr["depth"]), jnp.asarray(fr["color"]),
                    jnp.asarray(mask), jnp.asarray(e2i), jnp.asarray(K4),
                    cfg=jcfg)
        fuse_frame_dense(ts, torch.from_numpy(fr["depth"]),
                         torch.from_numpy(fr["color"]),
                         torch.from_numpy(mask), e2i, K4, tcfg)
        cnt = ts.mv_cnt.numpy().copy()
        if cnt_prev is not None:
            assert (cnt > cnt_prev).any() and (cnt < cnt_prev).any()
        cnt_prev = cnt
    td = to_dense(ts)
    differ = np.abs(td.diff - np.asarray(js.diff)) > DIFF_TOL
    for f in ("color", "weight", "mv_id", "mv_cnt"):
        a, b = np.asarray(getattr(js, f)), getattr(td, f)
        assert a.dtype == b.dtype, f
        differ |= (a != b).reshape(DIM + (-1,)).any(-1)
    assert not (differ & ~ambiguous).any(), np.argwhere(differ & ~ambiguous)
    assert differ.mean() < 1e-3
    np.testing.assert_array_equal(td.hist, np.asarray(js.hist))
    assert td.n_obs == int(js.n_obs) == 5
    assert len(np.unique(td.mv_id)) >= 3


def test_majority_vote_semantic_fusion_raises():
    with pytest.raises(ValueError, match="majority-vote"):
        SemanticFusion(K4, FusionConfig(vol_dim=DIM, majority_vote=True),
                       device="cpu")
    with pytest.raises(ValueError, match="backend"):
        SemanticFusion(K4, FusionConfig(vol_dim=DIM), backend="dense",
                       device="cpu")


def _stack(frames, e0):
    t = lambda k, dt=None: torch.from_numpy(np.stack([f[k] for f in frames]))
    e2i = np.stack([(f["extrinsic"] @ e0).astype(np.float32)
                    for f in frames])
    return t("depth"), t("color"), t("mask"), e2i


def test_fuse_sequence_matches_steps(hard_frames):
    """fuse_sequence (dense) and fuse_sequence_blocked (kernel path) equal
    their per-frame steps bit for bit, relabeled masks included."""
    f0 = hard_frames[0]
    e0 = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    Ki = np.linalg.inv(K4).astype(np.float32)
    d, c, m, e2i = _stack(hard_frames[1:5], e0)
    cfg = FusionConfig(vol_dim=(32,) * 3)
    a = tstate.init_from_first_frame(cfg, f0["depth"], K4, f0["mean_depth"],
                                     device="cpu")
    b = a.clone()
    a, seq_masks = fuse_sequence(a, d, c, m, e2i, K4, Ki, cfg)
    step_masks = []
    for i in range(4):
        b, g = fusion_step_dense(b, d[i], c[i], m[i], e2i[i], K4, Ki, cfg)
        step_masks.append(g)
    np.testing.assert_array_equal(seq_masks.numpy(),
                                  torch.stack(step_masks).numpy())

    pcfg = FusionConfig(vol_dim=(32,) * 3, probe_mode="depth")
    p = init_from_first_frame(pcfg, f0["depth"], K4, f0["mean_depth"],
                              device="cpu")
    q = p.clone()
    p, pm, misses = fuse_sequence_blocked(p, d, c, m, e2i, K4, pcfg)
    assert misses.shape == (4,) and int(misses.sum()) == 0
    qm = [fusion_step(q, d[i], c[i], m[i], e2i[i], K4, pcfg)[1]
          for i in range(4)]
    np.testing.assert_array_equal(pm.numpy(), torch.stack(qm).numpy())
    for x, y in ((a, b), (p, q)):
        dx, dy = to_dense(x), to_dense(y)
        for f in ("diff", "color", "weight", "hist"):
            np.testing.assert_array_equal(getattr(dx, f), getattr(dy, f))
        assert (dx.n_obs, dx.num_objs) == (dy.n_obs, dy.num_objs) == \
            (4, dx.num_objs)


def test_checkpoint_u32_across_packages(fused, tmp_path):
    """A JAX u32 snapshot loads into the port's xla store bit for bit and
    back; the port's snapshot has the JAX file's keys, dtypes and shapes
    and loads in the JAX package unchanged."""
    jf, tf, _ = fused["u32"]
    jcfg = JFusionConfig(vol_dim=DIM)
    tcfg = FusionConfig(vol_dim=DIM)
    q = j_save_vol(str(tmp_path / "jax.npz"), jf.state, jcfg)
    back = load_volume(q, tcfg, device="cpu", backend="xla")
    assert back.hist.dtype == torch.int32
    _assert_state_equal(jf.state, to_dense(back),
                        ("diff", "color", "weight", "hist"))
    p = save_volume(str(tmp_path / "port.npz"), tf.state, tcfg)
    zj, zp = np.load(q), np.load(p)
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape, k
    js = j_load_vol(p, jcfg)
    _assert_state_equal(js, tf.dense_state())


def test_checkpoint_majority_vote_across_packages(tmp_path):
    """Majority-vote snapshots both ways; the kernel store refuses one."""
    frames = make_sequence(default_scene(), K4, H, W, n_frames=3)
    f0 = frames[0]
    tcfg = FusionConfig(vol_dim=(32,) * 3, majority_vote=True)
    jcfg = JFusionConfig(vol_dim=(32,) * 3, majority_vote=True)
    ts = tstate.init_from_first_frame(tcfg, f0["depth"], K4,
                                      f0["mean_depth"], device="cpu")
    e0 = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    for fr in frames[1:]:
        fuse_frame_dense(ts, torch.from_numpy(fr["depth"]),
                         torch.from_numpy(fr["color"]),
                         torch.from_numpy(fr["mask"]),
                         (fr["extrinsic"] @ e0).astype(np.float32), K4, tcfg)
    assert int(ts.mv_cnt.max()) == 2
    p = save_volume(str(tmp_path / "mv_port.npz"), ts, tcfg)
    js = j_load_vol(p, jcfg)
    td = to_dense(ts)
    _assert_state_equal(js, td, ("diff", "color", "weight", "hist",
                                 "mv_id", "mv_cnt"))
    q = j_save_vol(str(tmp_path / "mv_jax.npz"), js, jcfg)
    back = to_dense(load_volume(q, tcfg, device="cpu", backend="xla"))
    for f in ("diff", "color", "weight", "hist", "mv_id", "mv_cnt"):
        np.testing.assert_array_equal(getattr(back, f), getattr(td, f))
    with pytest.raises(ValueError, match="majority-vote"):
        load_volume(q, tcfg, device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="majority-vote"):
        load_volume(q, FusionConfig(vol_dim=(32,) * 3), device="cpu",
                    backend="xla")


def test_u32_count_above_u16_raises_on_kernel_store(fused, tmp_path):
    """A JAX u32 snapshot whose largest count is 70000: the kernel path's
    u16 store raises a ValueError naming the count instead of wrapping it
    to 4464; the xla path loads it bit for bit."""
    jf, _, _ = fused["u32"]
    hist = np.asarray(jf.state.hist).copy()
    hist[3, 4, 5, 6] = 70000
    hist[7, 8, 9, 1] = 65536
    state = jf.state.replace(hist=jnp.asarray(hist))
    jcfg = JFusionConfig(vol_dim=DIM)
    q = j_save_vol(str(tmp_path / "big.npz"), state, jcfg)
    with pytest.raises(ValueError, match="70000"):
        load_volume(q, FusionConfig(vol_dim=DIM), device="cpu")
    back = load_volume(q, FusionConfig(vol_dim=DIM), device="cpu",
                       backend="xla")
    got = to_dense(back).hist
    assert got.dtype == np.uint32 and got[3, 4, 5, 6] == 70000
    np.testing.assert_array_equal(got, hist)
    # a u16 dense config is a u16 store too
    with pytest.raises(ValueError, match="70000"):
        load_volume(q, FusionConfig(vol_dim=DIM, hist_dtype=np.uint16),
                    device="cpu", backend="xla")


def test_fusion_demo_xla_backend(tmp_path):
    """fusion_demo --backend xla: the dense path reads a TUM sequence from
    disk into a u32 volume equal to SemanticFusion(backend="xla") fed from
    memory, and its viewer ray-marches the dense volume."""
    from chip_smoke import write_tum
    from slam_maskrcnn_tpu_torch.samples import fusion_demo

    frames = make_sequence(default_scene(), K4, H, W, n_frames=4)
    write_tum(str(tmp_path / "seq"), frames)
    intr = (float(K4[0, 0]), float(K4[1, 1]), float(K4[0, 2]),
            float(K4[1, 2]))
    demo, views = fusion_demo.run(str(tmp_path / "seq"), begin=-np.inf,
                                  end=np.inf, vol_dim=32, backend="xla",
                                  intrinsics=intr, orbit_frames=1,
                                  verbose=False, device="cpu")
    mem = SemanticFusion(K4, FusionConfig(vol_dim=(32,) * 3), backend="xla",
                         device="cpu")
    for fr in frames:
        mem.parse_frame(fr["depth"], fr["color"], fr["mask"], fr["extrinsic"],
                        fr["mean_depth"])
    a, b = demo.dense_state(), mem.dense_state()
    assert a.hist.dtype == np.uint32 and a.n_obs == 3
    for f in ("diff", "color", "weight", "hist"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(views) == 1 and views[0].shape == (H, W, 3)
    assert views[0].any()
