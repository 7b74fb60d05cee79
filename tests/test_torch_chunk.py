"""PyTorch port's north-star chunk forms, on the CPU: the tiny Mask R-CNN
of test_torch_north_star (weights carried across by load_jax_params),
96x128 frames, a 64^3 volume.

* ``run_chunk`` equals per-call ``step`` (state and renders exact);
* ``run_chunk_batched`` within the bounds of tests/test_north_star.py
  (batch-N convolutions may flip a few mask border pixels);
* ``shell_refresh_every=3`` leaves state and masks identical and the
  renders within 2%, and per-call ``step`` follows the same schedule;
* ``run_chunk_paired`` against ``run_chunk_batched`` as the JAX test
  holds them (state and masks exact, pair-second renders exact);
* the slice as a whole against the JAX ``run_chunk_paired`` on the same
  frames: masks >= 99.9% equal, the state under the bar of
  test_torch_fuse, renders > 99.9% of the pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import default_scene, make_sequence
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion.state import make_intrinsic
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import (
    init_blocked_from_first_frame, to_dense as j_dense)
from slam_maskrcnn_tpu.samples.north_star import NorthStar as JNorthStar
from slam_maskrcnn_tpu_torch.fusion.fuse import init_from_first_frame, to_dense
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.samples.north_star import NorthStar
from test_torch_fuse import _ambiguous_voxels
from test_torch_north_star import models  # noqa: F401  (module fixture)

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

H, W = 96, 128
K4 = make_intrinsic(100.0, 100.0, W / 2, H / 2)
VOL = (64,) * 3


@pytest.fixture(scope="module")
def seq():
    """Frames, the staged stack after frame 0 and the orbit distance."""
    frames = make_sequence(default_scene(), K4, H, W, n_frames=6)
    E0i = np.linalg.inv(frames[0]["extrinsic"]).astype(np.float32)
    depths = torch.stack([torch.from_numpy(f["depth"]) for f in frames[1:]])
    colors = torch.stack([torch.from_numpy(f["color"]) for f in frames[1:]])
    es = np.stack([(f["extrinsic"] @ E0i).astype(np.float32)
                   for f in frames[1:]])
    angles = np.array([0.01 * (i + 1) for i in range(5)], np.float32)
    return frames, depths, colors, es, angles, float(frames[0]["mean_depth"])


def _volume(cfg, frames):
    return init_from_first_frame(cfg, frames[0]["depth"], K4,
                                 frames[0]["mean_depth"], device="cpu")


def _same_state(a, b):
    for f in ("diff", "weight", "color", "hist"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.n_obs == b.n_obs and int(a.num_objs) == int(b.num_objs)


@pytest.mark.parametrize("mode,probe", [("instance", "splat"),
                                        ("color", "depth"),
                                        ("splatonly", "depth"),
                                        ("none", "depth")])
def test_run_chunk_equals_per_call_steps(models, seq, mode, probe):
    _, tm, _ = models
    frames, depths, colors, es, angles, dist = seq
    cfg = FusionConfig(vol_dim=VOL, probe_mode=probe)
    ns = NorthStar(tm, K4, cfg, H, W, render_mode=mode)
    a = _volume(cfg, frames)
    renders = []
    for i in range(3):
        a, r, mg, miss = ns.step(a, depths[i], colors[i], es[i], angles[i],
                                 dist)
        assert r.shape == (H, W, 3) and r.dtype == torch.uint8
        assert mg.shape == (H, W) and int(miss) == 0
        renders.append(r)
    b, rb, mb, misses = ns.run_chunk(_volume(cfg, frames), depths[:3],
                                     colors[:3], es[:3], angles[:3], dist)
    _same_state(a, b)
    assert torch.equal(torch.stack(renders), rb) and int(misses.sum()) == 0
    assert rb.shape == (3, H, W, 3) and mb.shape == (3, H, W)
    assert bool(rb.any()) == (mode != "none")


def test_share_shell_false_renders_the_fused_frame(models, seq):
    """share_shell=False recompacts after the fuse: same state, a render
    that differs from the shared-shell one only by the fresh shell."""
    _, tm, _ = models
    frames, depths, colors, es, angles, dist = seq
    cfg = FusionConfig(vol_dim=VOL, probe_mode="depth")
    outs = []
    for share in (True, False):
        ns = NorthStar(tm, K4, cfg, H, W, share_shell=share,
                       render_mode="color")
        outs.append(ns.run_chunk(_volume(cfg, frames), depths[:3],
                                 colors[:3], es[:3], angles[:3], dist))
    _same_state(outs[0][0], outs[1][0])
    r0, r1 = outs[0][1], outs[1][1]
    assert not r0[0].any() and r1[0].any()   # frame 1: empty pre-fuse shell
    assert (r0[2] != r1[2]).any(-1).float().mean() <= 0.05


def test_run_chunk_batched_within_bounds(models, seq):
    _, tm, _ = models
    frames, depths, colors, es, angles, dist = seq
    cfg = FusionConfig(vol_dim=VOL, probe_mode="depth")
    ns = NorthStar(tm, K4, cfg, H, W)
    a, ra, ma, _ = ns.run_chunk(_volume(cfg, frames), depths, colors, es,
                                angles, dist)
    c, rc, mc, misses = ns.run_chunk_batched(_volume(cfg, frames), depths,
                                             colors, es, angles, dist)
    assert torch.equal(a.weight, c.weight) and int(misses.sum()) == 0
    ha = (a.hist.to(torch.int64) & 0xFFFF)
    hc = (c.hist.to(torch.int64) & 0xFFFF)
    assert int((ha != hc).sum()) <= ha.numel() * 1e-4
    assert int((ha - hc).abs().max()) <= depths.shape[0]
    assert (ma != mc).float().mean() <= 1e-3
    for i in range(depths.shape[0]):
        assert (ra[i] != rc[i]).float().mean() <= 2e-3
    assert len(torch.unique(mc)) >= 2 and rc.any()


def test_shell_refresh_amortization(models, seq):
    """On a warmed volume (a refresh from an empty one carries an empty
    candidate set): refresh every 3 frames leaves state and masks as
    refresh every frame and changes < 2% of the render."""
    _, tm, _ = models
    frames, depths, colors, es, angles, dist = seq
    cfg1 = FusionConfig(vol_dim=VOL, probe_mode="depth")
    cfg3 = FusionConfig(vol_dim=VOL, probe_mode="depth",
                        shell_refresh_every=3)
    ns1, ns3 = NorthStar(tm, K4, cfg1, H, W), NorthStar(tm, K4, cfg3, H, W)
    warm, _, _, _ = ns1.step(_volume(cfg1, frames), depths[0], colors[0],
                             es[0], angles[0], dist)
    rest = (depths[1:], colors[1:], es[1:], angles[1:], dist)
    st1, r1, m1, _ = ns1.run_chunk_batched(warm.clone(), *rest)
    st3, r3, m3, miss3 = ns3.run_chunk_batched(warm.clone(), *rest)
    _same_state(st1, st3)
    assert torch.equal(m1, m3) and int(miss3.sum()) == 0
    frac = (r1 != r3).float().mean()
    assert frac <= 0.02, f"stale-shell render delta {frac}"
    assert all(r3[i].any() for i in range(4))

    # per-call step caches candidates on the same schedule (calls 0, 3)
    ns3.reset_candidates()
    st = warm.clone()
    for i in range(4):
        st, r, mg, miss = ns3.step(st, depths[i + 1], colors[i + 1],
                                   es[i + 1], angles[i + 1], dist)
        assert (r != r3[i]).float().mean() <= 2e-3
    assert torch.equal(st.weight, st3.weight)
    assert ns3._step_i == 4
    ns3.reset_candidates()
    assert ns3._cands is None and ns3._step_i == 0
    with pytest.raises(ValueError, match="probe_mode"):
        NorthStar(tm, K4, FusionConfig(vol_dim=VOL, shell_refresh_every=3),
                  H, W)


def test_refresh_overflow_lands_in_the_refresh_frames_miss(models, seq):
    """No silent caps: with a row budget too small, the candidate
    refresh's overflow shows in the misses of the frames that refresh, in
    the chunk forms and in per-call ``step`` alike: at refresh 2 the
    per-call steps from a reset cache equal ``run_chunk`` in state,
    renders and misses."""
    _, tm, _ = models
    frames, depths, colors, es, angles, dist = seq
    cfg = FusionConfig(vol_dim=VOL, probe_mode="depth", shell_refresh_every=2,
                       splat_max_rows=8, splat_row_cap=16)
    ns = NorthStar(tm, K4, cfg, H, W)
    st, _, _, _ = ns.step(_volume(cfg, frames), depths[0], colors[0], es[0],
                          angles[0], dist)
    ns.reset_candidates()
    _, _, _, misses = ns.run_chunk_batched(st.clone(), depths[1:], colors[1:],
                                           es[1:], angles[1:], dist)
    m = misses.tolist()
    assert m[0] > 0 and m[2] > 0 and m[1] == 0 and m[3] == 0
    a, ra, _, mi_a = ns.run_chunk(st.clone(), depths[1:4], colors[1:4],
                                  es[1:4], angles[1:4], dist)
    assert mi_a.tolist() == m[:3]
    ns.reset_candidates()
    b = st.clone()
    for i in range(3):
        b, r, _, miss = ns.step(b, depths[i + 1], colors[i + 1], es[i + 1],
                                angles[i + 1], dist)
        assert torch.equal(r, ra[i]) and int(miss) == m[i], i
    _same_state(a, b)


def test_paired_chunk_matches_batched(models, seq):
    _, tm, _ = models
    frames, depths, colors, es, angles, dist = seq
    cfg = FusionConfig(vol_dim=VOL, probe_mode="depth", shell_refresh_every=2)
    ns = NorthStar(tm, K4, cfg, H, W)
    with pytest.raises(ValueError, match="warmed"):
        ns.run_chunk_paired(_volume(cfg, frames), depths[1:], colors[1:],
                            es[1:], angles[1:], dist)
    st_b, _, _, _ = ns.step(_volume(cfg, frames), depths[0], colors[0],
                            es[0], angles[0], dist)
    st_p = st_b.clone()
    st_b, r_b, m_b, mi_b = ns.run_chunk_batched(st_b, depths[1:], colors[1:],
                                                es[1:], angles[1:], dist)
    st_p, r_p, m_p, mi_p = ns.run_chunk_paired(st_p, depths[1:], colors[1:],
                                               es[1:], angles[1:], dist)
    _same_state(st_p, st_b)
    assert st_p.n_obs == 5 and torch.equal(m_p, m_b)
    assert torch.equal(mi_p, mi_b.view(-1, 2).sum(1)) and mi_p.shape == (2,)
    assert r_p.shape == r_b.shape == (4, H, W, 3)
    for i in (1, 3):   # pair-second frames: the same post-fuse state
        assert torch.equal(r_p[i], r_b[i]), i
    # pair-first frames see one frame ahead; on a volume of 1-3 fused
    # frames one more frame changes much of the lit surface (measured
    # 9.2% and less of the render's bytes on this fixture)
    for i in (0, 2):
        assert (r_p[i] != r_b[i]).float().mean() <= 0.12, i
    with pytest.raises(ValueError, match="even"):
        ns.run_chunk_paired(st_p, depths[:3], colors[:3], es[:3], angles[:3],
                            dist)


def test_paired_chunk_matches_jax(models, seq):
    """The slice as a whole: one warm-up step, then run_chunk_paired over
    4 frames on both sides (probe_mode="depth", probe_stride=2, refresh
    every 2, render mode "instance")."""
    jm, tm, _ = models
    frames, depths, colors, es, angles, dist = seq
    kw = dict(probe_mode="depth", probe_stride=2, shell_refresh_every=2)
    jcfg = JFusionConfig(vol_dim=VOL, hist_dtype=jnp.uint16, **kw)
    tcfg = FusionConfig(vol_dim=VOL, **kw)
    jns = JNorthStar(jm, K4, jcfg, H, W)
    tns = NorthStar(tm, K4, tcfg, H, W)
    js = init_blocked_from_first_frame(jcfg, frames[0]["depth"], K4,
                                       frames[0]["mean_depth"])
    ts = _volume(tcfg, frames)
    ambiguous = np.zeros(VOL, bool)
    for i in range(5):
        ambiguous |= _ambiguous_voxels(ts, es[i], frames[i + 1]["depth"])
    jd, jc, je = (jnp.asarray(depths.numpy()), jnp.asarray(colors.numpy()),
                  jnp.asarray(es))
    js, _, _, _ = jns.step(js, jd[0], jc[0], je[0], angles[0], dist)
    ts, _, _, _ = tns.step(ts, depths[0], colors[0], es[0], angles[0], dist)
    js, jr, jmg, jmiss = jns.run_chunk_paired(js, jd[1:], jc[1:], je[1:],
                                              jnp.asarray(angles[1:]), dist)
    ts, tr, tmg, tmiss = tns.run_chunk_paired(ts, depths[1:], colors[1:],
                                              es[1:], angles[1:], dist)
    assert int(jnp.sum(jmiss)) == 0 and int(tmiss.sum()) == 0
    jmg, jr = np.asarray(jmg), np.asarray(jr)
    assert len(np.unique(jmg)) >= 2, "fixture must label an instance"
    assert (tmg.numpy() == jmg).mean() >= 0.999
    assert (jr.max(-1) > 0).mean() > 0.01, "fixture must render something"
    for i in range(4):
        assert (tr[i].numpy() == jr[i]).all(-1).mean() > 0.999, i
    jdn, tdn = j_dense(js, jcfg), to_dense(ts)
    assert int(jdn.num_objs) == tdn.num_objs and tdn.n_obs == int(jdn.n_obs)
    differ = ((tdn.weight != np.asarray(jdn.weight))
              | (tdn.color != np.asarray(jdn.color)).any(-1)
              | (np.abs(tdn.diff - np.asarray(jdn.diff)) > 2e-6))
    assert not (differ & ~ambiguous).any() and differ.mean() < 1e-3
    assert (tdn.hist == np.asarray(jdn.hist)).all(-1).mean() >= 0.999
