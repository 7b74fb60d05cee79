"""PyTorch port's paired fusion vs the JAX package's, on the CPU at 64^3.

* ``fuse_frames2`` (its plain version here) equals two ``fuse_frame``
  calls bit for bit in every field: the pair is the same per-voxel update
  applied twice (on the card both kernels call one device function).
* Against ``fuse_frames2_blocked_impl`` (Pallas, interpret mode) under the
  single-frame bar of test_torch_fuse: integers equal and |diff delta| <=
  2e-6 on every voxel but the ambiguous ones (< 0.1%), where XLA:CPU's
  contracted multiply-adds round the other way.

The pair step with its associations is held to the JAX package in
test_torch_pair_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import (default_scene,
                                              identity_pose_sequence,
                                              render_frame)
from slam_maskrcnn_tpu.fusion.state import make_intrinsic
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import (
    fuse_frame_blocked, fuse_frames2_blocked_impl,
    init_blocked_from_first_frame)
from slam_maskrcnn_tpu_torch.fusion.fuse import (fuse_frame, fuse_frames2,
                                                 init_from_first_frame)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
import test_torch_fuse as ttf

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

H, W = 120, 160
K4 = make_intrinsic(130.0, 130.0, W / 2, H / 2)


def _frames(n):
    scene = default_scene()
    out = []
    for E in identity_pose_sequence(n):
        d, c, m = render_frame(scene, E, K4, H, W)
        out.append((d, c, m, E))
    return out


def _staged(frames):
    """(depth, color, mask, e2i) tensors / arrays per frame after frame 0."""
    E0inv = np.linalg.inv(frames[0][3])
    return [(torch.from_numpy(d), torch.from_numpy(c), torch.from_numpy(m),
             (E @ E0inv).astype(np.float32)) for d, c, m, E in frames]


def _volume(cfg, frames):
    d0 = frames[0][0]
    md = float((d0[d0 > 0] / 5000.0).mean())
    return init_from_first_frame(cfg, d0, K4, md, device="cpu"), md


def _equal(a, b):
    for f in ("diff", "weight", "color", "hist"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.n_obs == b.n_obs


@pytest.mark.parametrize("inside", [False, True])
def test_pair_equals_two_single_fuses(inside):
    """All four fields bit-equal, also with frame 2's camera at the volume
    centre (voxels behind and on the camera plane)."""
    frames = _frames(3)
    cfg = FusionConfig(vol_dim=(64,) * 3)
    seq, _ = _volume(cfg, frames)
    st = _staged(frames)
    if inside:
        E = np.eye(4, dtype=np.float32)
        E[:3, 3] = -0.5 * (seq.vol_start + seq.vol_end)
        st[2] = st[2][:3] + (E,)
    fuse_frame(seq, *st[0], K4, cfg)
    par = seq.clone()
    fuse_frame(seq, *st[1], K4, cfg)
    fuse_frame(seq, *st[2], K4, cfg)
    fuse_frames2(par, *st[1], *st[2], K4, cfg)
    assert par.n_obs == 3 and int((par.weight > 1).sum()) > 1000
    assert int((par.hist != 0).sum()) > 1000
    _equal(par, seq)


def test_pair_matches_jax_pair_kernel():
    """vs fuse_frames2_blocked_impl at 64^3, 96x128 frames (the fixture of
    test_torch_fuse, whose bar and ambiguous-voxel set are reused)."""
    frames = ttf.make_sequence(default_scene(), ttf.K4, ttf.H, ttf.W,
                               n_frames=4)
    f0 = frames[0]
    b = init_blocked_from_first_frame(ttf.JCFG, f0["depth"], ttf.K4,
                                      f0["mean_depth"])
    v = init_from_first_frame(ttf.TCFG, f0["depth"], ttf.K4,
                              f0["mean_depth"], device="cpu")
    E0i = np.linalg.inv(f0["extrinsic"]).astype(np.float32)
    es = [(fr["extrinsic"] @ E0i).astype(np.float32) for fr in frames]
    jarg = lambda k: (jnp.asarray(frames[k]["depth"]),
                      jnp.asarray(frames[k]["color"]),
                      jnp.asarray(frames[k]["mask"]), jnp.asarray(es[k]))
    targ = lambda k: (torch.from_numpy(frames[k]["depth"]),
                      torch.from_numpy(frames[k]["color"]),
                      torch.from_numpy(frames[k]["mask"]), es[k])
    Kj = jnp.asarray(ttf.K4)
    b, _ = fuse_frame_blocked(b, *jarg(1), Kj, ttf.JCFG)
    edge = ttf._ambiguous_voxels(v, es[1], frames[1]["depth"])
    fuse_frame(v, *targ(1), ttf.K4, ttf.TCFG)
    b, miss = jax.jit(lambda b, a1, a2: fuse_frames2_blocked_impl(
        b, *a1, *a2, Kj, ttf.JCFG))(b, jarg(2), jarg(3))
    assert int(miss) == 0
    for k in (2, 3):
        edge |= ttf._ambiguous_voxels(v, es[k], frames[k]["depth"])
    fuse_frames2(v, *targ(2), *targ(3), ttf.K4, ttf.TCFG)
    assert v.n_obs == 3
    ttf._assert_same(b, v, edge)
