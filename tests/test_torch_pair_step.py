"""PyTorch port's paired fusion step vs the JAX package's, on the CPU at
64^3 (the kernel-level tests are in test_torch_fuse_pair.py).

``fusion_step_pair`` / ``fuse_pair_sequence`` against
``fusion_step_pair_blocked_impl`` (Pallas in interpret mode) on the fixture
of tests/test_fuse_pair.py, where every object is visible from frame 0:
relabeled masks equal, with the pair-probe boost on and off, and equal to
the port's own sequential steps, state included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion.pipeline import (fusion_step_blocked,
                                               fusion_step_pair_blocked_impl)
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import (
    init_blocked_from_first_frame)
from slam_maskrcnn_tpu_torch.fusion.pipeline import (fuse_pair_sequence,
                                                     fusion_step,
                                                     fusion_step_pair)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from test_torch_fuse_pair import K4, _equal, _frames, _staged, _volume

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)


def _cfgs(boost):
    return (JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16,
                          pallas_rect=(128, 256), probe_mode="depth",
                          pair_probe_boost=boost),
            FusionConfig(vol_dim=(64,) * 3, probe_mode="depth",
                         pair_probe_boost=boost))


@pytest.fixture(scope="module")
def warmed():
    """(frames staged, JAX blocked state, port volume) after frame 0's
    single step, shared by both boost cases: the boost only enters the
    pair step, and the JAX state is immutable (the port's is cloned)."""
    frames = _frames(5)
    jcfg, tcfg = _cfgs(True)
    vol, md = _volume(tcfg, frames)
    b = init_blocked_from_first_frame(jcfg, frames[0][0], K4, md)
    st = _staged(frames)
    b, _, _ = fusion_step_blocked(
        b, *(jnp.asarray(np.asarray(x)) for x in st[0]), jnp.asarray(K4),
        jcfg)
    vol, _, _ = fusion_step(vol, *st[0], K4, tcfg)
    return st, b, vol


@pytest.mark.parametrize("boost", [True, False])
def test_pair_step_matches_jax_pair_step(warmed, boost):
    """The pair step, associations included, on the fixture of
    tests/test_fuse_pair.py (every object visible from frame 0): relabeled
    masks equal to the JAX pair step's, and to the port's own sequential
    steps."""
    st, b, vol = warmed
    jcfg, tcfg = _cfgs(boost)
    vol = vol.clone()
    Kj = jnp.asarray(K4)
    jarg = lambda k: tuple(jnp.asarray(np.asarray(x)) for x in st[k])
    seq = vol.clone()

    jpair = jax.jit(lambda b, f1, f2: fusion_step_pair_blocked_impl(
        b, *f1, *f2, Kj, jcfg))
    depths, colors, masks = (torch.stack([st[k][i] for k in (1, 2, 3, 4)])
                             for i in range(3))
    es = [st[k][3] for k in (1, 2, 3, 4)]
    vol, masks_g, misses = fuse_pair_sequence(vol, depths, colors, masks, es,
                                              K4, tcfg)
    assert int(misses.sum()) == 0 and vol.n_obs == 5
    ids = set()
    for p, (k1, k2) in enumerate(((1, 2), (3, 4))):
        b, (jg1, jg2), jmiss = jpair(b, jarg(k1), jarg(k2))
        assert int(jmiss) == 0
        np.testing.assert_array_equal(masks_g[2 * p].numpy(),
                                      np.asarray(jg1))
        np.testing.assert_array_equal(masks_g[2 * p + 1].numpy(),
                                      np.asarray(jg2))
        ids |= set(np.unique(np.asarray(jg2)).tolist())
    assert ids == {0, 1, 2} and int(vol.num_objs) == int(b.num_objs) == 3

    # and the port's sequential steps give the same masks and state
    for k in (1, 2, 3, 4):
        seq, mg, _ = fusion_step(seq, *st[k], K4, tcfg)
        assert torch.equal(mg, masks_g[k - 1])
    _equal(vol, seq)


def test_pair_step_splat_probe_chains_ids():
    """probe_mode="splat" in the pair step: both probes see the pre-pair
    volume, ids stay stable, num_objs chains on the device."""
    frames = _frames(5)
    cfg = FusionConfig(vol_dim=(64,) * 3)
    assert cfg.probe_mode == "splat"
    vol, _ = _volume(cfg, frames)
    st = _staged(frames)
    vol, _, _ = fusion_step(vol, *st[0], K4, cfg)
    vol, (g1, g2), miss = fusion_step_pair(vol, *st[1], *st[2], K4, cfg)
    assert int(miss) == 0 and vol.n_obs == 3 and int(vol.num_objs) == 3
    assert set(np.unique(g1.numpy())) == set(np.unique(g2.numpy())) \
        == {0, 1, 2}
