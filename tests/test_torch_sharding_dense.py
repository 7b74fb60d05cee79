"""The dense ("xla") volume-sharded fusion step (parallel/sharding.py
``make_sharded_fusion_step(..., backend="xla")``) on the CPU, over gloo
ranks spawned by ``launch`` (one launch a world for the whole module), on
two fixtures:

* tests/test_volume_sharding.py's: the sphere scene on identity-ish poses,
  48 x 64 frames, a 32^3 volume, u16 histogram, 3 fused frames;
* the stress sequence of tests/test_torch_fusion_xla.py: ``hard_sequence``
  at 48 x 64 into a 64^3 volume with a u32 histogram, 5 fused frames,
  the camera inside the volume by the last ones.

Bars: at world 2 and 4 the gathered state is bit-equal to the port's
one-rank ``fusion_step_dense`` (diff, color, weight, hist, num_objs,
n_obs) and every rank's relabeled masks equal one rank's; against the JAX
package's ``fusion_step`` on the whole volume, the bar that
tests/test_torch_fusion_xla.py holds the one-rank dense path to (color,
weight and hist equal, |diff delta| <= 2e-6, num_objs and n_obs equal)
and the masks equal.

Also here: the slab-aware trilinear sample and the halo, the sharded probe
at a mesh of one, and the mesh and ``launch`` refusing to run without a
card unless the caller passes the CPU (no rank is spawned there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import (default_scene, hard_scene,
                                              hard_sequence,
                                              identity_pose_sequence,
                                              render_frame)
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion import fusion_step as j_step
from slam_maskrcnn_tpu.fusion import init_from_first_frame as j_init
from slam_maskrcnn_tpu_torch.fusion import raycast
from slam_maskrcnn_tpu_torch.fusion.fuse import from_dense, to_dense
from slam_maskrcnn_tpu_torch.fusion.pipeline import fusion_step_dense
from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                  init_from_first_frame,
                                                  make_intrinsic)
from slam_maskrcnn_tpu_torch.parallel import (launch, make_mesh,
                                              shard_volume_state,
                                              single_mesh)
from slam_maskrcnn_tpu_torch.parallel import sharding
import torch_sharding_ranks as ranks

torch.set_num_threads(2)

DIFF_TOL = 2e-6     # tests/test_torch_fusion_xla.py's bar for the dense path
WORLDS = (2, 4)


def _case(name):
    """(cfg kwargs, intrinsic, first depth, its mean depth, the fused
    frames [(depth, color, mask, e2i)]) of a fixture."""
    if name == "spheres32":
        H, W = 48, 64
        K4 = make_intrinsic(52.0, 52.0, W / 2, H / 2)
        raw = [render_frame(default_scene(), E, K4, H, W) + (E,)
               for E in identity_pose_sequence(4)]
        kw = dict(vol_dim=(32,) * 3, hist_dtype=np.uint16)
    else:
        H, W = 48, 64
        K4 = make_intrinsic(50.0, 50.0, W / 2, H / 2)
        raw = [(f["depth"], f["color"], f["mask"], f["extrinsic"])
               for f in hard_sequence(hard_scene(), K4, H, W, n_frames=6)]
        kw = dict(vol_dim=(64,) * 3, hist_dtype=np.uint32)
    E0inv = np.linalg.inv(np.asarray(raw[0][3], np.float64)).astype(
        np.float32)
    frames = [(d, c, m, (np.asarray(E, np.float32) @ E0inv).astype(
        np.float32)) for d, c, m, E in raw[1:]]
    d0 = raw[0][0]
    md = float((d0[d0 > 0].astype(np.float64) / 5000.0).mean())
    return kw, K4, d0, md, frames


CASES = ("spheres32", "hard64")


@pytest.fixture(scope="module")
def one_rank():
    """Per fixture: the port's one-rank dense run (state after the last
    frame, masks), the volume's geometry and the JAX package's run."""
    out = {}
    for name in CASES:
        kw, K4, d0, md, frames = _case(name)
        cfg = FusionConfig(**kw)
        Kinv = np.linalg.inv(K4).astype(np.float32)
        vol = init_from_first_frame(cfg, d0, K4, md, device="cpu")
        geometry = (vol.vol_start.copy(), vol.vol_end.copy())
        masks = []
        for d, c, m, e2i in frames:
            vol, mg = fusion_step_dense(
                vol, torch.from_numpy(d), torch.from_numpy(c),
                torch.from_numpy(m), e2i, K4, Kinv, cfg)
            masks.append(mg.numpy().copy())
        jcfg = JFusionConfig(vol_dim=kw["vol_dim"],
                             hist_dtype=getattr(jnp, np.dtype(
                                 kw["hist_dtype"]).name))
        js = j_init(jcfg, d0, K4, md)
        jmasks = []
        for d, c, m, e2i in frames:
            js, jm = j_step(js, jnp.asarray(d), jnp.asarray(c),
                            jnp.asarray(m), jnp.asarray(e2i),
                            jnp.asarray(K4), jnp.asarray(Kinv), jcfg)
            jmasks.append(np.asarray(jm))
        out[name] = dict(kw=kw, K4=K4, frames=frames, geometry=geometry,
                         state=to_dense(vol), masks=np.stack(masks),
                         jax=js, jax_masks=np.stack(jmasks))
    return out


@pytest.fixture(scope="module")
def sharded(one_rank):
    """Every fixture through the dense sharded step at each world: one
    launch a world."""
    cases = [(o["kw"], o["geometry"], o["frames"], o["K4"])
             for o in (one_rank[n] for n in CASES)]
    return {n: launch(ranks.sharded_fuse_dense, n, devices=["cpu"] * n,
                      args=(cases,)) for n in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_dense_sharded_bit_equal_to_one_rank(one_rank, sharded, world,
                                             case):
    i = CASES.index(case)
    want = one_rank[case]
    got = sharded[world][0][i]["state"]
    for k in ("diff", "color", "weight", "hist"):
        a, b = got[k], getattr(want["state"], k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got["num_objs"] == want["state"].num_objs >= 2
    assert got["n_obs"] == want["state"].n_obs == len(want["frames"])
    for r in range(world):
        np.testing.assert_array_equal(sharded[world][r][i]["masks"],
                                      want["masks"])
        assert sharded[world][r][i]["misses"] == [0] * len(want["frames"])
    # every slab fused votes, so the march crossed slab edges
    X = got["hist"].shape[0]
    for r in range(world):
        assert got["weight"][r * X // world:(r + 1) * X // world].max() > 0


@pytest.mark.parametrize("case", CASES)
def test_dense_sharded_matches_jax_fusion_step(one_rank, sharded, case):
    want = one_rank[case]
    js = want["jax"]
    got = sharded[4][0][CASES.index(case)]
    np.testing.assert_array_equal(got["masks"], want["jax_masks"])
    for f in ("color", "weight", "hist"):
        a = np.asarray(getattr(js, f))
        assert a.dtype == got["state"][f].dtype, f
        np.testing.assert_array_equal(got["state"][f], a, err_msg=f)
    assert np.abs(got["state"]["diff"] - np.asarray(js.diff)).max() \
        <= DIFF_TOL
    assert got["state"]["n_obs"] == int(js.n_obs)
    assert got["state"]["num_objs"] == int(js.num_objs)


def test_slab_trilinear_and_probe_at_one_rank(one_rank):
    """A slab with its halo samples as the whole volume wherever it owns
    the corner base; the sharded probe on a mesh of one equals
    back_project_probe bit for bit."""
    o = one_rank["hard64"]
    cfg = FusionConfig(**o["kw"])
    vol = from_dense(o["state"], device="cpu", hist_dtype=np.uint32)
    rng = np.random.default_rng(0)
    lo, hi = vol.vol_start - 2 * vol.voxel, vol.vol_end + 2 * vol.voxel
    pos = torch.from_numpy((lo + rng.random((4000, 3)) * (hi - lo))
                           .astype(np.float32))
    dims = tuple(vol.diff.shape)
    fl, _ = raycast.grid_floor(pos, vol.vol_start, vol.voxel, dims)
    base = fl[:, 0].clamp(0, dims[0] - 1)
    for t, unsigned in ((vol.diff, False), (vol.hist, True)):
        whole = raycast.trilinear(t, vol.vol_start, vol.voxel, pos,
                                  unsigned=unsigned)
        for x0, x1 in ((0, 16), (16, 48), (48, 64)):
            halo = t[x1] if x1 < dims[0] else None
            part = raycast.trilinear(t[x0:x1], vol.vol_start, vol.voxel, pos,
                                     unsigned=unsigned, x0=x0, dims=dims,
                                     halo=halo)
            own = (base >= x0) & (base < x1)
            assert own.sum() > 100
            assert torch.equal(part[own], whole[own])
    d, c, m, e2i = o["frames"][-1]
    H, W = d.shape
    Kinv = np.linalg.inv(o["K4"]).astype(np.float32)
    want = raycast.back_project_probe(vol, e2i, Kinv, H, W, cfg)
    got = sharding.sharded_back_project_probe(vol, e2i, Kinv, H, W, cfg,
                                              single_mesh("cpu"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[1].any()


def test_mesh_and_launch_refuse_without_a_card(monkeypatch):
    """With no CUDA device the defaults raise, and launch raises before
    spawning a rank; the CPU is taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        single_mesh()
    assert single_mesh("cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch(ranks.sharded_fuse_dense, 2, args=([],))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch(ranks.sharded_fuse_dense, 2, devices=["cuda:0"] * 2,
               args=([],))
    monkeypatch.setattr(sharding.dist, "is_available", lambda: True)
    monkeypatch.setattr(sharding.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(sharding.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(sharding.dist, "get_rank", lambda: 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)
    assert make_mesh(2, "cpu") == sharding.Mesh(1, 2, torch.device("cpu"))


def test_xla_backend_refuses_majority_vote():
    cfg = FusionConfig(vol_dim=(32,) * 3, majority_vote=True)
    with pytest.raises(ValueError, match="majority-vote"):
        sharding.make_sharded_fusion_step(cfg, single_mesh("cpu"),
                                          backend="xla")
    with pytest.raises(ValueError, match="backend"):
        sharding.make_sharded_fusion_step(cfg, single_mesh("cpu"),
                                          backend="dense")


def test_shard_of_the_dense_state_keeps_its_dtype(one_rank):
    """shard_volume_state cuts a u32 dense state into slabs of its own
    store type, whole bricks each."""
    o = one_rank["hard64"]
    vol = init_from_first_frame(FusionConfig(**o["kw"]), o["frames"][0][0],
                                o["K4"], 1.0, device="cpu")
    slab = shard_volume_state(vol, sharding.Mesh(3, 4, torch.device("cpu")))
    assert slab.hist.dtype == torch.int32 and slab.diff.shape[0] == 16
    assert torch.equal(slab.diff, vol.diff[48:])
