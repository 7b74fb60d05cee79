"""PyTorch port vs the JAX package: instance association, relabel and the
fusion pipeline (SemanticFusion.parse_frame, depth probe) on synthetic
ground-truth masks; plus the port's import rules and device defaults."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data.synthetic import hard_scene, hard_sequence
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion.associate import (
    apply_relabel as j_relabel, associate_instances as j_assoc)
from slam_maskrcnn_tpu.fusion.pipeline import SemanticFusion as JFusion
from slam_maskrcnn_tpu.ops.pallas.fuse_kernel import to_dense as j_dense
from slam_maskrcnn_tpu_torch.fusion.associate import (
    apply_relabel as t_relabel, associate_instances as t_assoc)
from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from test_torch_fuse import K4, H, W, _ambiguous_voxels

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assoc_inputs(seed, K=32, Hs=48, Ws=64):
    """A label image of a few blobs and histogram votes that partly agree
    with it (some ids match a global id, some are new)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((Hs, Ws), np.uint8)
    n_ids = int(rng.integers(3, 7))
    for i in range(1, n_ids + 1):
        y, x = rng.integers(0, Hs - 12), rng.integers(0, Ws - 16)
        mask[y:y + 12, x:x + 16] = i
    n_obs = int(rng.integers(2, 6))
    probs = rng.integers(0, 2, (Hs, Ws, K)).astype(np.float32)
    for i in range(1, n_ids + 1):
        if rng.uniform() < 0.6:                        # matches global id g
            g = int(rng.integers(1, 10))
            probs[mask == i, g] += n_obs
    return probs, probs > 0.3, mask, n_obs, int(rng.integers(2, 10))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_associate_and_relabel_match_jax(seed):
    probs, bm, mask, n_obs, num_objs = _assoc_inputs(seed)
    jcfg = JFusionConfig(vol_dim=(8, 8, 32))
    tcfg = FusionConfig(vol_dim=(8, 8, 32))
    jr, jn = j_assoc(jnp.asarray(probs), jnp.asarray(bm), jnp.asarray(mask),
                     jnp.asarray(n_obs, jnp.int32),
                     jnp.asarray(num_objs, jnp.int32), jcfg)
    tr, tn = t_assoc(torch.from_numpy(probs), torch.from_numpy(bm),
                     torch.from_numpy(mask), n_obs,
                     torch.tensor(num_objs, dtype=torch.int32), tcfg)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(tn) == int(jn)
    assert int(jn) > num_objs or (np.asarray(jr)[1:7] != np.arange(1, 7)).any()
    np.testing.assert_array_equal(
        t_relabel(torch.from_numpy(mask), tr).numpy(),
        np.asarray(j_relabel(jnp.asarray(mask), jr)))


def test_semantic_fusion_matches_jax():
    """Stage 2 alone on the stress sequence (per-frame local ids that churn,
    camera pushing into the volume): relabeled masks >= 99.9% equal, the
    volume as in test_torch_fuse, histogram >= 99.9%, same num_objs."""
    frames = hard_sequence(hard_scene(), K4, H, W, n_frames=6)
    jcfg = JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16,
                         probe_mode="depth", probe_stride=2)
    tcfg = FusionConfig(vol_dim=(64,) * 3, probe_mode="depth", probe_stride=2)
    jf = JFusion(K4, jcfg, backend="pallas", miss_check_every=0)
    tf = SemanticFusion(K4, tcfg, backend="pallas", device="cpu")
    ambiguous = np.zeros((64,) * 3, bool)
    ids = set()
    for k, fr in enumerate(frames):
        args = (fr["depth"], fr["color"], fr["mask"], fr["extrinsic"],
                fr["mean_depth"])
        if k > 0:
            e2i = (fr["extrinsic"] @ tf.init_extrinsic_inv).astype(np.float32)
            ambiguous |= _ambiguous_voxels(tf.state, e2i, fr["depth"])
        jm, tm = jf.parse_frame(*args), tf.parse_frame(*args)
        if k == 0:
            assert jm is None and tm is None
            continue
        assert (tm.numpy() == np.asarray(jm)).mean() >= 0.999
        assert int(jf.last_misses) == 0
        ids |= set(np.unique(np.asarray(jm)).tolist())
    assert len(ids) >= 4, f"association must see several ids: {ids}"
    jd, td = j_dense(jf.state, jcfg), tf.dense_state()
    assert td.num_objs == int(jd.num_objs) and td.n_obs == int(jd.n_obs)
    differ = ((td.weight != np.asarray(jd.weight))
              | (td.color != np.asarray(jd.color)).any(-1)
              | (np.abs(td.diff - np.asarray(jd.diff)) > 2e-6))
    assert not (differ & ~ambiguous).any() and differ.mean() < 1e-3
    assert (td.hist == np.asarray(jd.hist)).all(-1).mean() >= 0.999


def test_port_imports_no_jax_and_defaults_to_cuda():
    """With jax blocked, the port and chip_smoke.py import; no module of the
    JAX package is loaded; entry points without device= raise when CUDA is
    absent."""
    code = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import torch
import chip_smoke
import slam_maskrcnn_tpu_torch
from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, make_intrinsic
from slam_maskrcnn_tpu_torch.models.config import Config
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
from slam_maskrcnn_tpu_torch.samples.north_star import NorthStar
import slam_maskrcnn_tpu_torch.ops.nms, slam_maskrcnn_tpu_torch.ops.roi_align
import slam_maskrcnn_tpu_torch.fusion.raycast, slam_maskrcnn_tpu_torch.fusion.splat
bad = [m for m in sys.modules if m.startswith("slam_maskrcnn_tpu.")
       or m == "slam_maskrcnn_tpu"]
assert not bad, bad
assert not torch.cuda.is_available()
K = make_intrinsic(100., 100., 64., 48.)
class C(Config):
    NAME = "c"
    BACKBONE = "resnet50"
    NUM_CLASSES = 2
    IMAGES_PER_GPU = 1
raised = []
for make in (lambda: MaskRCNN("inference", C()),
             lambda: SemanticFusion(K, FusionConfig(vol_dim=(8, 8, 32)))):
    try:
        make()
    except RuntimeError as e:
        raised.append("CUDA" in str(e))
m = MaskRCNN("inference", C(), device="cpu")
for call in (lambda: load_jax_params({}, m),
             lambda: NorthStar(MaskRCNN("inference", C()), K,
                               FusionConfig(vol_dim=(8, 8, 32)), 48, 64)):
    try:
        call()
    except RuntimeError as e:
        raised.append("CUDA" in str(e))
assert raised == [True] * 4, raised
print("OK")
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
