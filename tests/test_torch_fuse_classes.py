"""The brick classification of the port's fuse kernel (skip / free / full,
fusion/fuse.py ``depth_tiles_plain`` and ``brick_classes_plain``, the plain
versions of what csrc/fuse.cu does per 8 x 8 x 32 brick) held against the
dense per-voxel update ``fuse_frame_plain``, which knows nothing of
classes, on the CPU.

Bars, all exact: no voxel of a skip brick is updated; every voxel of a free
brick is updated with dn == 1 and is not gated; a class-aware update written
here (skip: nothing, free: closed form, full: per voxel in numpy float32)
equals the dense update bit for bit in diff, weight, color and histogram,
for one frame and for a pair. Poses: camera outside and inside the volume,
looking away, grazing (chip_smoke.seeded_poses, which the kernel is held to
on the card); depth with holes; a wall nearer than the volume and one behind
it; volumes whose sizes no brick divides."""

import numpy as np
import pytest
import torch

from chip_smoke import seeded_poses
from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                    make_sequence)
from slam_maskrcnn_tpu_torch.fusion.fuse import (BRICK, FREE, FULL, SKIP,
                                                 brick_classes_plain,
                                                 brick_slacks,
                                                 depth_tiles_plain,
                                                 fuse_frame_plain,
                                                 fuse_frames2_plain,
                                                 fuse_params,
                                                 init_from_first_frame)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, make_intrinsic

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

H, W = 90, 130                 # no multiple of the 32-px depth tile
K4 = make_intrinsic(100.0, 100.0, W / 2, H / 2)
DIMS = [(40, 24, 72), (64, 64, 64)]
POSES = ["outside", "inside", "away", "grazing", "holes", "wall_near",
         "wall_far"]
FIELDS = ("diff", "weight", "color", "hist")


@pytest.fixture(scope="module")
def frames():
    return make_sequence(default_scene(), K4, H, W, n_frames=4)


def _warm_volume(frames, dim, max_objects=32):
    """A volume that two frames have already been fused into, so that
    weights, colors and histograms are not all zero."""
    cfg = FusionConfig(vol_dim=dim, max_objects=max_objects)
    f0 = frames[0]
    vol = init_from_first_frame(cfg, f0["depth"], K4, f0["mean_depth"],
                                device="cpu")
    E0i = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    for fr in frames[1:3]:
        e = (fr["extrinsic"] @ E0i).astype(np.float32)
        fuse_frame_plain(vol, *_tensors(fr["depth"], fr["color"], fr["mask"]),
                         fuse_params(vol, e, K4, cfg))
    return vol, cfg


def _tensors(depth, color, mask):
    return (torch.from_numpy(np.ascontiguousarray(depth)),
            torch.from_numpy(np.ascontiguousarray(color)),
            torch.from_numpy(np.ascontiguousarray(mask)))


def _case(pose, frames, vol, cfg):
    """(depth, color, mask, extrinsic2init) of a seeded pose."""
    fr = frames[3]
    depth, color, mask = fr["depth"].copy(), fr["color"], fr["mask"]
    E0i = np.linalg.inv(frames[0]["extrinsic"]).astype(np.float64)
    e = fr["extrinsic"].astype(np.float64) @ E0i
    if pose in ("inside", "away", "grazing"):
        # the poses the kernel is held to on the card
        e = seeded_poses(vol.vol_start, vol.vol_end, e)[pose]
    elif pose == "holes":           # zeros inside otherwise free tiles
        rng = np.random.default_rng(5)
        depth[rng.integers(0, H, 12), rng.integers(0, W, 12)] = 0
        depth[40:44, 70:90] = 0
    elif pose == "wall_near":       # a wall before the volume's near face
        depth[:] = 1 + int(max(float(vol.vol_start[2]) - 1.5 * float(vol.mu),
                               0.0) * cfg.depth_scale)
    elif pose == "wall_far":        # a wall behind its far face
        depth[:] = int((float(vol.vol_end[2]) + 1.0) * cfg.depth_scale)
    return depth, color, mask, np.asarray(e, np.float32)


def _classes(vol, params, depth):
    tmin, tmax = depth_tiles_plain(torch.from_numpy(depth))
    return brick_classes_plain(vol, params, tmin, tmax, H, W)


def _per_voxel(cls, dim):
    """Brick classes [nbx, nby, nbz] -> one class per voxel [X, Y, Z]."""
    c = cls
    for axis, b in enumerate(BRICK):
        c = c.repeat_interleave(b, dim=axis)
    return c[:dim[0], :dim[1], :dim[2]]


def _free_closed_form(diff, weight):
    wt = weight.float()
    return (diff * wt + 1.0) / (wt + 1.0), weight + 1


def _full_numpy(vol, sel, depth, color, mask, p):
    """The per-voxel update of the voxels ``sel`` (bool [X, Y, Z]) in numpy
    float32, written from the kernel's description, in place on the numpy
    views of ``vol``."""
    f = np.float32
    p = np.asarray(p, f)
    K = vol.hist.shape[-1]
    x, y, z = (a.astype(f) for a in np.nonzero(sel))
    cam = [((p[9 + r] + p[r] * x) + p[3 + r] * y) + p[6 + r] * z
           for r in range(3)]
    px, py, pz = cam
    safe = np.where(np.abs(pz) < f(1e-9), f(1e-9), pz)
    with np.errstate(all="ignore"):
        u = np.floor((p[12] * px + p[14] * pz) / safe)
        v = np.floor((p[13] * py + p[15] * pz) / safe)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (pz > 0)
    ui = np.where(ok, u, 0).astype(np.int64)
    vi = np.where(ok, v, 0).astype(np.int64)
    d = depth[vi, ui]
    dm = d.astype(f) / p[17] - pz
    ok &= (d > 0) & (dm > -p[16])
    dn = np.minimum(dm, p[16]) / p[16]
    idx = tuple(a[ok] for a in np.nonzero(sel))
    dn, ui, vi = dn[ok], ui[ok], vi[ok]
    diff, weight = vol.diff.numpy(), vol.weight.numpy()
    colr, hist = vol.color.numpy(), vol.hist.numpy()
    w = weight[idx]
    wt = w.astype(f)
    diff[idx] = (diff[idx] * wt + dn) / (wt + f(1.0))
    weight[idx] = w + 1
    g = dn < p[18]
    gidx = tuple(a[g] for a in idx)
    wg = w[g].astype(np.int32)[:, None]
    colr[gidx] = ((colr[gidx].astype(np.int32) * wg
                   + color[vi[g], ui[g]].astype(np.int32))
                  // (wg + 1)).astype(np.uint8)
    m = np.minimum(mask[vi[g], ui[g]].astype(np.int64), K - 1)
    hist[gidx + (m,)] += 1


def _class_aware(vol, cls, depth, color, mask, p):
    """One frame into ``vol`` in place, brick class by brick class."""
    c = _per_voxel(cls, vol.diff.shape)
    free = c == FREE
    d, w = _free_closed_form(vol.diff[free], vol.weight[free])
    vol.diff[free], vol.weight[free] = d, w
    _full_numpy(vol, (c == FULL).numpy(), depth, color, mask, p)


def _equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _check_case(frames, pose, vol, cfg):
    """(a), (b) and (e) for one pose on ``vol`` (updated in place by the
    dense version). Returns ({class: bricks}, voxels updated, state
    before)."""
    return _check_frame(vol, cfg, *_case(pose, frames, vol, cfg))


def _check_frame(vol, cfg, depth, color, mask, e):
    """(a), (b) and (e) for one frame on ``vol``; see ``_check_case``."""
    dim = tuple(vol.diff.shape)
    p = fuse_params(vol, e, K4, cfg)
    cls = _classes(vol, p, depth)
    assert cls.dtype == torch.int8 and cls.shape == tuple(
        -(-n // b) for n, b in zip(dim, BRICK))
    before, aware = vol.clone(), vol.clone()
    fuse_frame_plain(vol, *_tensors(depth, color, mask), p)
    c = _per_voxel(cls, dim)

    skip, free = c == SKIP, c == FREE
    assert torch.equal(vol.weight[skip], before.weight[skip])
    assert torch.equal(vol.diff[skip], before.diff[skip])
    d, w = _free_closed_form(before.diff[free], before.weight[free])
    assert torch.equal(vol.weight[free], w)
    assert torch.equal(vol.diff[free], d)
    assert torch.equal(vol.color[free], before.color[free])
    assert torch.equal(vol.hist[free], before.hist[free])

    _class_aware(aware, cls, depth, color, mask, p)
    _equal(aware, vol)
    n = {k: int((cls == k).sum()) for k in (SKIP, FULL, FREE)}
    return n, int((vol.weight != before.weight).sum()), before


@pytest.mark.parametrize("dim", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("pose", POSES)
def test_classes_against_dense_update(frames, pose, dim):
    """(a) skip bricks untouched, (b) free bricks updated with dn == 1 and
    not gated, (e) the class-aware update equals the dense one bit for bit."""
    vol, cfg = _warm_volume(frames, dim)
    n, updated, before = _check_case(frames, pose, vol, cfg)
    if pose == "away":
        assert n[FULL] == n[FREE] == 0 and updated == 0
    elif pose == "wall_near":       # every voxel lies behind the wall
        assert n[FREE] == 0 and updated == 0
    elif pose == "wall_far":        # every voxel in view is free space
        assert n[FREE] > 0
        assert torch.equal(vol.hist, before.hist)
    else:
        assert updated > 0 and n[FULL] > 0


@pytest.mark.parametrize("pose", ["outside", "grazing"])
def test_classes_are_useful_on_the_default_scene(frames, pose):
    """(c) at 128^3, where a brick is small against the scene, the camera
    that sees the default scene finds bricks of each class, and they pass
    the same checks; looking away, every brick is skip."""
    vol, cfg = _warm_volume(frames, (128,) * 3, max_objects=2)
    n, updated, _ = _check_case(frames, pose, vol, cfg)
    assert min(n.values()) > 0 and updated > 0, n
    n, updated, _ = _check_case(frames, "away", vol, cfg)
    assert n[FULL] == n[FREE] == 0 and updated == 0


@pytest.mark.parametrize("seed", range(12))
def test_random_poses_are_conservative(frames, seed):
    """(a), (b) and (e) on a random camera (any rotation, inside or up to
    1.5 volume extents away) and a random kind of depth image (the scene, a
    flat wall, noise with holes, a ramp)."""
    rng = np.random.default_rng(100 + seed)
    vol, cfg = _warm_volume(frames, [(40, 24, 72), (64, 64, 128),
                                     (72, 72, 40)][seed % 3], max_objects=2)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    q[:, 0] *= np.linalg.det(q)                   # a proper rotation
    centre = 0.5 * (vol.vol_start + vol.vol_end).astype(np.float64)
    extent = (vol.vol_end - vol.vol_start).astype(np.float64)
    cam = centre + rng.uniform(-1, 1, 3) * extent * rng.choice([0.3, 0.8, 1.5])
    e = np.eye(4)
    e[:3, :3], e[:3, 3] = q, -q @ cam
    fr = frames[3]
    depth = fr["depth"].copy()
    kind = seed % 4
    if kind == 1:
        depth[:] = rng.integers(2000, 30000)
    elif kind == 2:
        depth = rng.integers(500, 20000, depth.shape).astype(np.uint16)
        depth[rng.integers(0, H, 20), rng.integers(0, W, 20)] = 0
    elif kind == 3:
        depth = (3000 + 60 * np.arange(W)[None, :]
                 + 20 * np.arange(H)[:, None]).astype(np.uint16)
    _check_frame(vol, cfg, depth, fr["color"], fr["mask"],
                 e.astype(np.float32))


@pytest.mark.parametrize("first,second", [("outside", "holes"),
                                          ("inside", "grazing"),
                                          ("wall_far", "outside"),
                                          ("away", "wall_near")])
def test_pair_class_aware_equals_dense(frames, first, second):
    """(e) for a pair: frame 1's classes then frame 2's on the same state
    equal ``fuse_frames2_plain`` bit for bit."""
    vol, cfg = _warm_volume(frames, DIMS[0])
    aware = vol.clone()
    args = []
    for pose in (first, second):
        depth, color, mask, e = _case(pose, frames, vol, cfg)
        p = fuse_params(vol, e, K4, cfg)
        _class_aware(aware, _classes(vol, p, depth), depth, color, mask, p)
        args += [*_tensors(depth, color, mask), p]
    fuse_frames2_plain(vol, *args)
    _equal(aware, vol)


@pytest.mark.parametrize("shape", [(90, 130), (64, 96), (33, 31)])
def test_depth_tiles_match_numpy(shape):
    """(d) tile min and max against a loop over the tiles, on images whose
    sizes are no multiples of 32, with holes and values above 32767."""
    rng = np.random.default_rng(shape[0])
    depth = rng.integers(1, 65536, shape).astype(np.uint16)
    depth[rng.integers(0, shape[0], 5), rng.integers(0, shape[1], 5)] = 0
    tmin, tmax = depth_tiles_plain(torch.from_numpy(depth))
    th, tw = -(-shape[0] // 32), -(-shape[1] // 32)
    assert tmin.shape == tmax.shape == (th, tw) and tmin.dtype == torch.int32
    for i in range(th):
        for j in range(tw):
            tile = depth[32 * i:32 * i + 32, 32 * j:32 * j + 32]
            assert int(tmin[i, j]) == int(tile.min())
            assert int(tmax[i, j]) == int(tile.max())
    assert int((tmin == 0).sum()) > 0


def test_gate_above_one_leaves_no_free_brick(frames):
    """dn == 1 passes a gate above 1, so such a configuration has no free
    brick; and the slacks grow with the size of the camera constants."""
    vol, cfg = _warm_volume(frames, DIMS[1])
    depth, _, _, e = _case("wall_far", frames, vol, cfg)
    p = fuse_params(vol, e, K4, cfg)
    assert int((_classes(vol, p, depth) == FREE).sum()) > 0
    p_open = p.copy()
    p_open[18] = 1.5
    assert int((_classes(vol, p_open, depth) == FREE).sum()) == 0
    s = brick_slacks(p, DIMS[1])
    far = p.copy()
    far[9:12] *= 1000.0
    assert s.dtype == np.float32 and s[0] >= 1e-4 and s[1] > s[0]
    assert (brick_slacks(far, DIMS[1])[:2] > s[:2]).all()
