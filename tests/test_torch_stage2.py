"""The port's two-stage drivers against the JAX package on the CPU: the
TUM frontend (data/tum.py, frames read by data/png.py) on a cv2-written
sequence; ``fusion_demo.run`` at 64^3 against the JAX driver's "pallas"
backend, with its orbit frames and their PNGs; the volume checkpoint read
across both packages; the host dmask functions; and stage 1
(``batch_mask_process``) with the trained detector on the parity scenes
written as PNGs.

Bars as tests/test_torch_fusion.py: weight, histogram and color equal
outside the ambiguous voxels, |diff delta| <= 2e-6, fewer than 0.1%
differing; orbit frames > 99.9% of pixels equal; stage-1 label PNGs equal
on >= 99.5% of pixels."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data import tum as jtum
from slam_maskrcnn_tpu.data.synthetic import default_scene, render_frame
from slam_maskrcnn_tpu.fusion import FusionConfig as JFusionConfig
from slam_maskrcnn_tpu.fusion.checkpoint import (load_volume as j_load_vol,
                                                 save_volume as j_save_vol)
from slam_maskrcnn_tpu.fusion.state import init_state as j_init_state
from slam_maskrcnn_tpu.models import mask_ops as jops
from slam_maskrcnn_tpu.samples.fusion_demo import run as j_run
from slam_maskrcnn_tpu_torch.data import tum as ttum
from slam_maskrcnn_tpu_torch.data.png import read_png
from slam_maskrcnn_tpu_torch.fusion.checkpoint import load_volume, save_volume
from slam_maskrcnn_tpu_torch.fusion.fuse import to_dense
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.models import mask_ops as tops
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.samples.fusion_demo import run as t_run
from slam_maskrcnn_tpu_torch.samples.train_shapes import detect_scenes
from test_torch_detect import TF32, TRAINED, JF32, _jax_trained
from test_torch_fuse import H, K4, TCFG, W, _ambiguous_voxels

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

INTRINSICS = (float(K4[0, 0]), float(K4[1, 1]), float(K4[0, 2]),
              float(K4[1, 2]))


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A synthetic TUM sequence written by cv2: rgb/ depth/ mask/ and a
    groundtruth.txt with a comment and unsorted, slightly offset stamps."""
    root = tmp_path_factory.mktemp("tum")
    for d in ("rgb", "depth", "mask"):
        os.makedirs(root / d)
    scene = default_scene()
    base_ts = 1311868164.0  # -> fmod 68164.x, inside the reference window
    lines = []
    for i in range(6):
        ts = base_ts + i * 0.05
        pose = [0.02 * i, 0.005 * i, 0, 0, np.sin(0.01 * i), 0,
                np.cos(0.01 * i)]
        E = np.linalg.inv(jtum.pose_matrix(pose))  # world->camera
        depth, color, mask = render_frame(scene, E, K4, H, W)
        name = f"{ts:.6f}.png"
        cv2.imwrite(str(root / "depth" / name), depth)
        cv2.imwrite(str(root / "rgb" / name), color)
        cv2.imwrite(str(root / "mask" / name), mask)
        lines.append(f"{ts - 0.001:.6f} " + " ".join(str(v) for v in pose))
    (root / "groundtruth.txt").write_text(
        "# ground truth trajectory\n" + "\n".join(lines[::-1]) + "\n")
    return str(root)


@pytest.mark.parametrize("kw", [dict(), dict(interpolate_poses=True),
                                dict(begin=68164.07, end=68164.2,
                                     max_frames=2)])
def test_tum_sequence_equals_jax(tum_dir, kw):
    js, ts = jtum.TUMSequence(tum_dir, **kw), ttum.TUMSequence(tum_dir, **kw)
    assert len(ts) == len(js) > 0 and ts.pairs == js.pairs
    for f in ("rgb_files", "depth_files", "mask_files", "has_masks"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.depth_ts, js.depth_ts)
    np.testing.assert_array_equal(ts.trajectory.timestamps,
                                  js.trajectory.timestamps)
    np.testing.assert_array_equal(ts.trajectory.poses, js.trajectory.poses)
    for k in range(len(js)):
        a, b = js[k], ts[k]
        assert a.keys() == b.keys()
        for key in a:
            assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_tum_frames_of_other_png_kinds_equal_jax(tum_dir, tmp_path):
    """The same sequence with its frames saved as other PNG kinds (rgb as
    RGBA, the masks as colour labels): every field of every frame equals
    the JAX frontend's, dtype and shape included."""
    import shutil

    from PIL import Image

    root = tmp_path / "tum"
    shutil.copytree(tum_dir, root)
    for name in sorted(os.listdir(root / "rgb")):
        bgr = cv2.imread(str(root / "rgb" / name))
        alpha = np.full(bgr.shape[:2] + (1,), 200, np.uint8)
        Image.fromarray(np.concatenate([bgr[:, :, ::-1], alpha], 2)).save(
            root / "rgb" / name)
        m = cv2.imread(str(root / "mask" / name), cv2.IMREAD_UNCHANGED)
        colour = np.stack([m * 40, m * 3, 255 - m * 50], -1).astype(np.uint8)
        colour[m == 0] = 0
        cv2.imwrite(str(root / "mask" / name), colour)
    js, ts = jtum.TUMSequence(str(root)), ttum.TUMSequence(str(root))
    assert len(ts) == len(js) > 0
    for k in range(len(js)):
        a, b = js[k], ts[k]
        for key in a:
            assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        assert b["mask"].ndim == 2 and b["color"].shape[2] == 3


def test_tum_helpers_equal_jax(tum_dir):
    rng = np.random.default_rng(0)
    q1, q2 = rng.normal(size=4), rng.normal(size=4)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(ttum.slerp(q1, q2, t),
                                      jtum.slerp(q1, q2, t))
    np.testing.assert_array_equal(ttum.slerp(q1, q1 * 1.0001, 0.5),
                                  jtum.slerp(q1, q1 * 1.0001, 0.5))
    pose = np.concatenate([rng.normal(size=3), q1])
    for f in ("quaternion_matrix", "pose_matrix", "parse_extrinsic"):
        arg = q1 if f == "quaternion_matrix" else pose
        np.testing.assert_array_equal(getattr(ttum, f)(arg),
                                      getattr(jtum, f)(arg))
    assert (ttum.filename_timestamp("/a/1311871923.004312.png")
            == jtum.filename_timestamp("/a/1311871923.004312.png"))
    depth = rng.integers(0, 9000, (40, 50)).astype(np.uint16)
    depth[5, 5] = 60000
    assert ttum.mean_depth(depth) == jtum.mean_depth(depth)
    for it in (1, 2):
        (a, ma), (b, mb) = (ttum.filter_gaussian(depth, it),
                            jtum.filter_gaussian(depth, it))
        np.testing.assert_array_equal(a, b)
        assert ma == mb
    d_ts = np.sort(rng.uniform(0, 10, 30))
    m_ts = np.sort(np.concatenate([d_ts[::2], rng.uniform(0, 10, 8)]))
    assert (ttum.match_timestamps(d_ts, m_ts, 1.0, 9.0, 7)
            == jtum.match_timestamps(d_ts, m_ts, 1.0, 9.0, 7))


@pytest.fixture(scope="module")
def demo(tum_dir, tmp_path_factory):
    save = str(tmp_path_factory.mktemp("orbit"))
    kw = dict(begin=68164.0, end=68170.0, max_frames=100, vol_dim=64,
              intrinsics=INTRINSICS, orbit_frames=2, verbose=False)
    jf, jframes = j_run(tum_dir, backend="pallas", **kw)
    tf, tframes = t_run(tum_dir, device="cpu", save_dir=save, **kw)
    return jf, jframes, tf, tframes, save


def test_fusion_demo_matches_jax(tum_dir, demo):
    jf, _, tf, _, _ = demo
    seq = ttum.TUMSequence(tum_dir)
    ambiguous = np.zeros((64,) * 3, bool)
    for k in range(1, len(seq)):
        fr = seq[k]
        e2i = (fr["extrinsic"] @ tf.init_extrinsic_inv).astype(np.float32)
        ambiguous |= _ambiguous_voxels(tf.state, e2i, fr["depth"])
    jd, td = jf.dense_state(), tf.dense_state()
    assert td.n_obs == int(jd.n_obs) == 5
    assert td.num_objs == int(jd.num_objs) >= 3
    differ = ((td.weight != np.asarray(jd.weight))
              | (td.hist != np.asarray(jd.hist)).any(-1)
              | (td.color != np.asarray(jd.color)).any(-1)
              | (np.abs(td.diff - np.asarray(jd.diff)) > 2e-6))
    assert not (differ & ~ambiguous).any() and differ.mean() < 1e-3
    assert (td.weight > 0).mean() > 0.05


def test_fusion_demo_orbit_frames(demo):
    _, jframes, _, tframes, save = demo
    assert len(tframes) == len(jframes) == 2
    for a, b in zip(jframes, tframes):
        assert b.shape == a.shape and b.dtype == np.uint8
        assert (a == b).all(-1).mean() > 0.999
        assert (b.max(-1) > 0).sum() > 20
    files = sorted(os.listdir(save))
    assert files == ["orbit_00000.png", "orbit_00001.png"]
    for f, img in zip(files, tframes):
        # cv2 reads BGR: the file holds the RGB frame
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(save, f))[:, :, ::-1], img)
        np.testing.assert_array_equal(read_png(os.path.join(save, f)),
                                      img[:, :, ::-1])


def test_checkpoint_across_packages(demo, tmp_path):
    """Port -> JAX and JAX -> port: every array equal; the restored volume
    fuses on. A majority-vote snapshot, another vol_dim or another bin
    count raise."""
    _, _, tf, _, _ = demo
    jcfg = JFusionConfig(vol_dim=(64,) * 3, hist_dtype=jnp.uint16)
    p = save_volume(str(tmp_path / "port.npz"), tf.state, TCFG)
    js = j_load_vol(p, jcfg)
    td = to_dense(tf.state)
    for f in ("diff", "color", "weight", "hist", "vol_start", "vol_end",
              "voxel"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(td, f), err_msg=f)
    assert int(js.n_obs) == td.n_obs and int(js.num_objs) == td.num_objs
    assert float(js.mu) == float(td.mu)

    q = j_save_vol(str(tmp_path / "jax.npz"), js, jcfg)
    zj, zp = np.load(q), np.load(p)
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape, k
    back = load_volume(q, TCFG, device="cpu")
    bd = to_dense(back)
    for f in ("diff", "color", "weight", "hist"):
        np.testing.assert_array_equal(getattr(bd, f), getattr(td, f))
    assert (bd.n_obs, bd.num_objs) == (td.n_obs, td.num_objs)

    with pytest.raises(ValueError, match="vol_dim"):
        load_volume(q, FusionConfig(vol_dim=(32,) * 3), device="cpu")
    with pytest.raises(ValueError, match="bins"):
        load_volume(q, FusionConfig(vol_dim=(64,) * 3, max_objects=16),
                    device="cpu")
    mv_cfg = JFusionConfig(vol_dim=(8, 8, 32), majority_vote=True)
    mv = j_save_vol(str(tmp_path / "mv.npz"),
                    j_init_state(mv_cfg, [0, 0, 0], [1, 1, 1]), mv_cfg)
    with pytest.raises(ValueError, match="majority-vote"):
        load_volume(mv, FusionConfig(vol_dim=(8, 8, 32)), device="cpu")


def _masks(rng, H, W, n):
    yy, xx = np.mgrid[:H, :W]
    out = np.zeros((H, W, n), bool)
    for i in range(n):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        r = rng.uniform(5, 30)
        out[..., i] = np.hypot(yy - cy, xx - cx) < r
    out[..., n - 1] = out[..., n - 2]              # an exact area tie
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_dmask_functions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    m = _masks(rng, 60, 80, 7)
    depth = rng.normal(3000, 300, (60, 80)).astype(np.uint16)
    depth[::7, ::5] = 20000
    np.testing.assert_array_equal(tops.depth_filter(depth, m),
                                  jops.depth_filter(depth, m))
    np.testing.assert_array_equal(tops.filter_tiny_objects(m, 300),
                                  jops.filter_tiny_objects(m, 300))
    np.testing.assert_array_equal(tops.preserve_small_objs(m.copy()),
                                  jops.preserve_small_objs(m.copy()))


def test_batch_mask_process_matches_jax(tmp_path):
    """Stage 1 with the trained detector (float32) on six parity scenes
    written as PNGs: the port's label PNGs against the JAX package's."""
    rgb = tmp_path / "rgb"
    os.makedirs(rgb)
    scenes = detect_scenes()
    for k in (0, 3, 7, 12, 16, 19):
        cv2.imwrite(str(rgb / f"{k:02d}.png"), scenes[k][0][:, :, ::-1])
    jm = _jax_trained(JF32)
    tm = MaskRCNN("inference", TF32(), device="cpu").load_weights(TRAINED)
    assert jops.batch_mask_process(jm, str(rgb), str(tmp_path / "jm"),
                                   verbose=False) == 6
    assert tops.batch_mask_process(tm, str(rgb), str(tmp_path / "tm"),
                                   verbose=False) == 6
    agree, n_inst = [], 0
    for f in sorted(os.listdir(tmp_path / "jm")):
        a = cv2.imread(str(tmp_path / "jm" / f), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "tm" / f), cv2.IMREAD_UNCHANGED)
        assert b.dtype == np.uint8 and b.shape == a.shape
        agree.append((a == b).mean())
        n_inst += int(a.max())
    assert min(agree) >= 0.995, agree
    assert n_inst >= 1


def test_slice_imports_without_jax_cv2_h5py_pil():
    """The slice's modules and chip_smoke.py import with jax, flax, cv2,
    h5py and PIL blocked (none is installed where the port runs), and load
    no module of the JAX package; its entry points default to the card."""
    import subprocess
    import sys

    code = r"""
import sys
for m in ("jax", "flax", "cv2", "h5py", "PIL"):
    sys.modules[m] = None
import chip_smoke
import slam_maskrcnn_tpu_torch.data.png, slam_maskrcnn_tpu_torch.data.tum
import slam_maskrcnn_tpu_torch.data.shapes, slam_maskrcnn_tpu_torch.eval.metrics
import slam_maskrcnn_tpu_torch.fusion.checkpoint
import slam_maskrcnn_tpu_torch.models.h5, slam_maskrcnn_tpu_torch.models.mask_ops
import slam_maskrcnn_tpu_torch.ops.resize, slam_maskrcnn_tpu_torch.viz.viewer
import slam_maskrcnn_tpu_torch.samples.coco
import slam_maskrcnn_tpu_torch.samples.train_shapes
import slam_maskrcnn_tpu_torch.samples.mask_process
import slam_maskrcnn_tpu_torch.samples.fusion_demo
import slam_maskrcnn_tpu_torch.samples.live_pipeline
from slam_maskrcnn_tpu_torch.fusion.raycast import camera_rays
from slam_maskrcnn_tpu_torch.fusion.checkpoint import load_volume
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
bad = [m for m in sys.modules if m.startswith("slam_maskrcnn_tpu.")
       or m == "slam_maskrcnn_tpu"]
assert not bad, bad
raised = []
for call in (lambda: camera_rays([[1, 0, 0], [0, 1, 0], [0, 0, 1]], 4, 4),
             lambda: load_volume("none.npz", FusionConfig())):
    try:
        call()
    except RuntimeError as e:
        raised.append("CUDA" in str(e))
    except FileNotFoundError:
        raised.append("read the file before asking for the card")
print(raised)
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], cwd=env["PYTHONPATH"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[True, True]", out.stdout
