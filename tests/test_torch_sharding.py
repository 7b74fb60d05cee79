"""Volume sharding (parallel/sharding.py) on the CPU, over gloo ranks
spawned by ``launch``, on tests/test_volume_sharding.py's fixture: the
synthetic sphere scene on identity-ish poses, 48 x 64 frames, a 32 x 32 x
128 volume with a u16 histogram, 3 fused frames.

* The sharded fusion step at world 2 and 4 is bit-equal to the port's
  one-rank ``fusion_step`` with the splat probe: diff, color, weight,
  hist, every relabeled mask, num_objs and the misses.
* It is within the known fuse rounding (ROADMAP.md "Known roundings") of
  the JAX package's ``make_sharded_fusion_step`` on a 4-device mesh (the
  virtual CPU devices of tests/conftest.py): every voxel where the two
  differ is ambiguous (within 1e-4 px of a pixel edge or 1e-5 of the cull
  or color gate, from the kernel's constants in float64), fewer than 0.1%
  of them, |diff| within 2e-6 elsewhere; the masks and num_objs equal.
* The sharded render at world 4 differs from the one-rank
  ``splat_render_orbit`` on at most 1% of pixels in both modes (the JAX
  test's bar), every rank returning the same image.
* Slabs and the gather: the round trip is exact; a slab must hold whole
  bricks. On a slab at x0, the fuse's plain version and the brick classes
  equal the whole volume's: every voxel is computed from its global x.
* The new modules import without JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion import init_from_first_frame as j_init
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import (to_blocked,
                                                      to_dense as j_dense)
from slam_maskrcnn_tpu.parallel import make_mesh as j_mesh
from slam_maskrcnn_tpu.parallel import (
    make_sharded_fusion_step as j_sharded_step,
    shard_volume_state as j_shard)
from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                    identity_pose_sequence,
                                                    render_frame)
from slam_maskrcnn_tpu_torch.fusion.fuse import (brick_classes_plain,
                                                 depth_tiles_plain,
                                                 fuse_frame_plain,
                                                 fuse_params,
                                                 init_from_first_frame,
                                                 to_dense)
from slam_maskrcnn_tpu_torch.fusion.pipeline import fusion_step
from slam_maskrcnn_tpu_torch.fusion.splat import splat_render_orbit
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, make_intrinsic
from slam_maskrcnn_tpu_torch.parallel import (gather_volume_state, launch,
                                              shard_volume_state, single_mesh)
from test_torch_fuse import EDGE_D, EDGE_PX
import torch_sharding_ranks as ranks

torch.set_num_threads(2)

H, W = 48, 64
K4 = make_intrinsic(52.0, 52.0, W / 2, H / 2)
CFG = dict(vol_dim=(32, 32, 128), hist_dtype=np.uint16)
MAX_BLOCKS = 1024


def _copy(ns) -> dict:
    return {k: (np.copy(v) if isinstance(v, np.ndarray) else v)
            for k, v in vars(ns).items()}


@pytest.fixture(scope="module")
def one_rank():
    """The frames, the initial volume, and the port's one-rank run: the
    state, masks and misses after each frame, and the voxels ambiguous
    under each frame's update."""
    scene = default_scene()
    frames = []
    for E in identity_pose_sequence(4):
        d, c, m = render_frame(scene, E, K4, H, W)
        frames.append((d, c, m, E))
    E0inv = np.linalg.inv(frames[0][3])
    staged = [(d, c, m, (E @ E0inv).astype(np.float32))
              for d, c, m, E in frames]
    d0 = frames[0][0]
    md = float((d0[d0 > 0] / 5000.0).mean())
    cfg = FusionConfig(**CFG)
    vol = init_from_first_frame(cfg, d0, K4, md, device="cpu")
    init = _copy(to_dense(vol))
    masks, misses = [], []
    ambiguous = np.zeros(cfg.vol_dim, bool)
    for d, c, m, e2i in staged[1:]:
        ambiguous |= _ambiguous(vol, e2i, d, cfg)
        vol, mask_g, miss = fusion_step(
            vol, torch.from_numpy(d), torch.from_numpy(c),
            torch.from_numpy(m), e2i, K4, cfg)
        masks.append(mask_g.numpy().copy())
        misses.append(int(miss))
    return dict(frames=staged[1:], d0=d0, md=md, init=init, vol=vol,
                state=_copy(to_dense(vol)), masks=np.stack(masks),
                misses=misses, ambiguous=ambiguous)


def _ambiguous(vol, e2i, depth, cfg):
    """Voxels where one rounding decides the update (test_torch_fuse.py's
    rule at this volume's size)."""
    p = fuse_params(vol, e2i, K4, cfg).astype(np.float64)
    X, Y, Z = cfg.vol_dim
    gx = np.arange(X, dtype=np.float64)[:, None, None]
    gy = np.arange(Y, dtype=np.float64)[None, :, None]
    gz = np.arange(Z, dtype=np.float64)[None, None, :]
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
    dm = depth[vi, ui] / cfg.depth_scale - pz
    mu = float(vol.mu)
    dn = np.minimum(dm, mu) / mu
    amb |= inside & ((np.abs(dm + mu) < EDGE_D)
                     | (np.abs(dn - cfg.color_diff_gate) < EDGE_D))
    return amb


@pytest.fixture(scope="module")
def sharded(one_rank):
    """The sharded run at world 2 and 4."""
    return {n: launch(ranks.sharded_fuse, n, devices=["cpu"] * n, args=(
        CFG, one_rank["init"], one_rank["frames"], K4, MAX_BLOCKS))[0]
        for n in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fuse_bit_equal_to_one_rank(one_rank, sharded, world):
    out = sharded[world]
    want = one_rank["state"]
    for k in ("diff", "color", "weight", "hist"):
        np.testing.assert_array_equal(out["state"][k], want[k], err_msg=k)
    assert out["state"]["num_objs"] == want["num_objs"] >= 2
    assert out["state"]["n_obs"] == want["n_obs"] == 3
    np.testing.assert_array_equal(out["masks"], one_rank["masks"])
    assert out["misses"] == one_rank["misses"]
    # the histogram carries votes on every slab
    X = want["hist"].shape[0]
    for r in range(world):
        part = out["state"]["hist"][r * X // world:(r + 1) * X // world]
        assert part.sum() > 0, r


def test_sharded_fuse_within_rounding_of_jax(one_rank, sharded):
    """The JAX package's volume-sharded step on its 4-device mesh, fed the
    same frames."""
    jcfg = JFusionConfig(vol_dim=CFG["vol_dim"], hist_dtype=jnp.uint16,
                         pallas_rect=(128, 256))
    mesh = j_mesh(4)
    step = j_sharded_step(jcfg, mesh, max_blocks=MAX_BLOCKS)
    st = j_shard(to_blocked(j_init(jcfg, one_rank["d0"], K4, one_rank["md"]),
                            jcfg), mesh)
    Kj = jnp.asarray(K4)
    jmasks = []
    for d, c, m, e2i in one_rank["frames"]:
        st, mask_g, miss = step(st, jnp.asarray(d), jnp.asarray(c),
                                jnp.asarray(m), jnp.asarray(e2i), Kj)
        assert int(miss) == 0
        jmasks.append(np.asarray(mask_g))
    jd = j_dense(st, jcfg)
    td = sharded[4]["state"]
    np.testing.assert_array_equal(sharded[4]["masks"], np.stack(jmasks))
    assert td["num_objs"] == int(jd.num_objs)
    differ = ((np.asarray(jd.weight) != td["weight"])
              | (np.asarray(jd.hist) != td["hist"]).any(-1)
              | (np.asarray(jd.color) != td["color"]).any(-1)
              | (np.abs(np.asarray(jd.diff) - td["diff"]) > 2e-6))
    unexplained = np.argwhere(differ & ~one_rank["ambiguous"])
    assert len(unexplained) == 0, f"voxels differ: {unexplained[:10]}"
    assert differ.mean() < 1e-3, f"{differ.sum()} voxels differ"


def test_sharded_render_within_one_percent(one_rank):
    cfg = FusionConfig(**CFG)
    imgs = launch(ranks.sharded_render, 4, devices=["cpu"] * 4, args=(
        CFG, one_rank["state"], 0.05, one_rank["md"], K4, H, W, MAX_BLOCKS))
    for mode in ("instance", "color"):
        one = splat_render_orbit(one_rank["vol"], 0.05, one_rank["md"], K4,
                                 H, W, cfg, mode=mode).numpy()
        sh = imgs[0][mode]
        assert sh.shape == one.shape == (H, W, 3)
        for other in imgs[1:]:
            np.testing.assert_array_equal(other[mode], sh)
        mismatch = (sh != one).any(-1).mean()
        assert mismatch <= 0.01, (mode, float(mismatch))
        assert (sh.sum(-1) > 0).mean() > 0.05, mode


def test_slabs_and_gather(one_rank):
    """A slab keeps the volume's geometry; a mesh of one gathers its own
    slab back; a slab of part of a brick raises."""
    vol = one_rank["vol"]
    mesh = single_mesh("cpu")
    slab = shard_volume_state(vol, mesh)
    assert slab.diff.shape == vol.diff.shape
    np.testing.assert_array_equal(slab.vol_start, vol.vol_start)
    back = gather_volume_state(slab, mesh)
    for k in ("diff", "color", "weight", "hist"):
        assert torch.equal(getattr(back, k), getattr(vol, k)), k
    bad = type(mesh)(0, 8, mesh.device)     # 32 / 8 = 4 planes
    with pytest.raises(ValueError, match="whole"):
        shard_volume_state(vol, bad)


def test_slab_fuse_and_classes_at_x0(one_rank):
    """The fuse's plain version and the brick classes on an x-slab at
    x0 = 16 equal the whole volume's planes 16..31: every voxel computed
    from its global x."""
    cfg = FusionConfig(**CFG)
    d, c, m, e2i = one_rank["frames"][1]
    whole = init_from_first_frame(cfg, one_rank["d0"], K4, one_rank["md"],
                                  device="cpu")
    p = fuse_params(whole, e2i, K4, cfg)
    slab = shard_volume_state(whole, type(single_mesh("cpu"))(
        1, 2, torch.device("cpu")))
    args = (torch.from_numpy(d), torch.from_numpy(c), torch.from_numpy(m), p)
    fuse_frame_plain(whole, *args)
    fuse_frame_plain(slab, *args, x0=16)
    for k in ("diff", "color", "weight", "hist"):
        assert torch.equal(getattr(slab, k), getattr(whole, k)[16:]), k
    assert int((slab.weight > 0).sum()) > 0
    tiles = depth_tiles_plain(args[0])
    np.testing.assert_array_equal(
        brick_classes_plain(slab, p, *tiles, H, W, x0=16).numpy(),
        brick_classes_plain(whole, p, *tiles, H, W)[2:].numpy())


def test_new_modules_import_without_jax():
    """parallel/, models/inspect.py and utils/ import with jax blocked and
    load no module of the JAX package."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\nsys.modules['flax'] = None\n"
        "import slam_maskrcnn_tpu_torch.parallel\n"
        "import slam_maskrcnn_tpu_torch.models.inspect\n"
        "import slam_maskrcnn_tpu_torch.utils\n"
        "import slam_maskrcnn_tpu_torch.train.trainer\n"
        "bad = [m for m in sys.modules if m == 'slam_maskrcnn_tpu' "
        "or m.startswith('slam_maskrcnn_tpu.')]\n"
        "assert not bad, bad\nprint('OK')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
