"""The port's Keras .h5 loader (slam_maskrcnn_tpu_torch/models/h5.py,
numpy only) against h5py and the JAX importer: every dataset of the
committed checkpoint bit-equal to h5py's read; the synthetic layouts of
tests/test_h5_import.py; a file written by the JAX ``save_h5_weights``;
the strict failures; the layouts it refuses; and the trained checkpoint
loaded into the port bit-equal to the JAX import, then detecting the 20
committed scenes in the default bf16 configuration."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.models.anchors import get_anchors as j_anchors
from slam_maskrcnn_tpu.models.import_h5 import (load_h5_weights as j_load,
                                                save_h5_weights)
from slam_maskrcnn_tpu.samples.train_shapes import \
    InferenceShapesConfig as JShapes
from slam_maskrcnn_tpu_torch.models.h5 import (H5Error, H5File,
                                               keras_layers, load_h5_weights)
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.weights import (_targets, flax_shape,
                                                    load_jax_params)
from slam_maskrcnn_tpu_torch.samples.train_shapes import (
    InferenceShapesConfig, detect_scenes, evaluate_map)
from test_torch_north_star import _configs, _variables

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "weights", "shapes_r2_f16.h5")


def _h5py_datasets(path):
    out = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.append((n, o[()]))
                     if isinstance(o, h5py.Dataset) else None)
    return out


def _port_tiny():
    return MaskRCNN("inference", _configs()[1], device="cpu")


def _shape(model, name):
    return flax_shape(model.module, name)


def _weights(model):
    return {k: v.detach().clone() for k, v in _targets(model.module).items()}


def test_every_dataset_equals_h5py():
    mine = list(H5File(TRAINED).datasets())
    ref = _h5py_datasets(TRAINED)
    assert [n for n, _ in mine] == [n for n, _ in ref]
    assert len(mine) == 384
    for (name, a), (_, b) in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    kinds = {str(a.dtype) for _, a in mine}
    assert kinds == {"float16", "float32"}


def test_synthetic_layout_maps_layers(tmp_path):
    """Nested groups (the rpn_model wrapper), a Conv2DTranspose kernel
    stored [kh, kw, cout, cin], Dense and BatchNorm: each lands in its port
    tensor; untouched layers keep their values (non-strict)."""
    m = _port_tiny()
    m.init_params(0)
    before = _weights(m)
    rng = np.random.default_rng(0)
    path = str(tmp_path / "w.h5")
    put = {}
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")

        def add(group, wname, name, shape=None):
            arr = rng.normal(size=shape or _shape(m, name)).astype(
                np.float32)
            g.require_group(group).create_dataset(wname, data=arr)
            put[name] = arr
        add("conv1/conv1", "kernel:0", "resnet.conv1.weight")
        add("conv1/conv1", "bias:0", "resnet.conv1.bias")
        add("bn_conv1/bn_conv1", "gamma:0", "resnet.bn_conv1.scale")
        add("bn_conv1/bn_conv1", "beta:0", "resnet.bn_conv1.bias")
        add("bn_conv1/bn_conv1", "moving_mean:0", "resnet.bn_conv1.mean")
        add("rpn_model/rpn_conv_shared", "kernel:0",
            "rpn_model.rpn_conv_shared.weight")
        add("mrcnn_class_logits/mrcnn_class_logits", "kernel:0",
            "fpn_classifier.mrcnn_class_logits.weight")
        kh, kw, cin, cout = _shape(m, "fpn_mask.mrcnn_mask_deconv.weight")
        add("mrcnn_mask_deconv/mrcnn_mask_deconv", "kernel:0",
            "fpn_mask.mrcnn_mask_deconv.weight", (kh, kw, cout, cin))
    load_h5_weights(path, m, device="cpu")
    after = _weights(m)
    w = after["resnet.conv1.weight"].numpy()
    np.testing.assert_array_equal(w, put["resnet.conv1.weight"]
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        after["fpn_classifier.mrcnn_class_logits.weight"].numpy(),
        put["fpn_classifier.mrcnn_class_logits.weight"].T)
    np.testing.assert_array_equal(
        after["rpn_model.rpn_conv_shared.weight"].numpy(),
        put["rpn_model.rpn_conv_shared.weight"].transpose(3, 2, 0, 1))
    for leaf in ("scale", "bias", "mean"):
        np.testing.assert_array_equal(
            after[f"resnet.bn_conv1.{leaf}"].numpy(),
            put[f"resnet.bn_conv1.{leaf}"])
    # Keras [kh, kw, cout, cin] -> Flax [kh, kw, cin, cout] -> the port's
    # flipped [cin, cout, kh, kw]
    deconv = put["fpn_mask.mrcnn_mask_deconv.weight"].transpose(0, 1, 3, 2)
    np.testing.assert_array_equal(
        after["fpn_mask.mrcnn_mask_deconv.weight"].numpy(),
        deconv.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    assert torch.equal(after["fpn.fpn_c5p5.weight"],
                       before["fpn.fpn_c5p5.weight"])
    assert torch.equal(after["resnet.bn_conv1.var"],
                       before["resnet.bn_conv1.var"])

    # exclude: the excluded layer keeps its values, the rest loads
    m2 = _port_tiny()
    m2.init_params(1)
    keep = _weights(m2)
    load_h5_weights(path, m2, exclude=["mrcnn_class_logits"], device="cpu")
    got = _weights(m2)
    assert torch.equal(got["fpn_classifier.mrcnn_class_logits.weight"],
                       keep["fpn_classifier.mrcnn_class_logits.weight"])
    assert torch.equal(got["resnet.conv1.weight"], after["resnet.conv1.weight"])


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A full-inventory file written by the JAX save_h5_weights from
    numpy-seeded variables (shapes by jax.eval_shape: nothing compiles)."""
    jcfg, _ = _configs()
    v = _variables(JMaskRCNN("inference", jcfg), 4)
    path = str(tmp_path_factory.mktemp("h5") / "full.h5")
    save_h5_weights(path, v)
    return path, v


def test_jax_saved_file_loads_strictly(jax_file):
    path, v = jax_file
    m = _port_tiny()
    m.load_weights(path)                         # strict: no exclude
    ref = _port_tiny()
    load_jax_params(v, ref, device="cpu")
    got, want = _weights(m), _weights(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_strict_failures_raise(jax_file, tmp_path):
    path, _ = jax_file
    missing = str(tmp_path / "missing.h5")
    with h5py.File(path, "r") as src, h5py.File(missing, "w") as dst:
        src.copy("model_weights", dst)
        del dst["model_weights/conv1"]
    with pytest.raises(ValueError, match="not written"):
        _port_tiny().load_weights(missing, strict=True)
    # ...unless the layer is excluded
    load_h5_weights(missing, _port_tiny(), exclude=["^conv1$"], strict=True,
                    device="cpu")

    extra = str(tmp_path / "extra.h5")
    with h5py.File(path, "r") as src, h5py.File(extra, "w") as dst:
        src.copy("model_weights", dst)
        dst.require_group("model_weights/not_a_layer/not_a_layer") \
            .create_dataset("kernel:0", data=np.zeros((1, 1, 1, 1),
                                                      np.float32))
    with pytest.raises(ValueError, match="not consumed"):
        _port_tiny().load_weights(extra)

    wrong = str(tmp_path / "wrong.h5")
    with h5py.File(path, "r") as src, h5py.File(wrong, "w") as dst:
        src.copy("model_weights", dst)
        del dst["model_weights/fpn_c5p5/fpn_c5p5/bias:0"]
        dst["model_weights/fpn_c5p5/fpn_c5p5"].create_dataset(
            "bias:0", data=np.zeros((7,), np.float32))
    with pytest.raises(ValueError, match="shape mismatch for fpn_c5p5"):
        _port_tiny().load_weights(wrong)
    # any other name is a training checkpoint (train/checkpoint.py)
    with pytest.raises(FileNotFoundError):
        _port_tiny().load_weights(str(tmp_path / "ckpt.msgpack"))


def test_deep_group_tree_and_compact_layout(tmp_path):
    """A group of 700 members (a B-tree with internal levels), continuation
    blocks (many attributes), a compact dataset and ints: equal to h5py."""
    path = str(tmp_path / "deep.h5")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        g = f.create_group("many")
        for i in range(700):
            g.create_dataset(f"d{i:04d}", data=rng.normal(size=(i % 5 + 1,)))
        for i in range(40):
            g.attrs[f"attr{i}"] = np.arange(i + 1)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        arr = rng.integers(-100, 100, (6, 5)).astype(np.int16)
        space = h5py.h5s.create_simple(arr.shape)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I16LE, space,
                             dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)
        f.create_dataset("scalar", data=np.float64(2.5))
        f.create_dataset("u32", data=np.arange(9, dtype=np.uint32))
    mine = list(H5File(path).datasets())
    ref = _h5py_datasets(path)
    assert [n for n, _ in mine] == [n for n, _ in ref] and len(mine) == 703
    for (name, a), (_, b) in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind,match", [
    ("chunked", "chunked"), ("gzip", "filtered"),
    ("new-style group", "new-style groups|version-2 object headers"),
    ("superblock 2", "superblock version"), ("big-endian", "big-endian")])
def test_unsupported_layouts_raise(tmp_path, kind, match):
    path = str(tmp_path / "x.h5")
    data = np.arange(64, dtype=np.float32).reshape(8, 8)
    if kind == "superblock 2":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("a", data=data)
    elif kind == "new-style group":      # in a superblock-0 file
        with h5py.File(path, "w") as f:
            f.create_group("g", track_order=True).create_dataset("a",
                                                                 data=data)
    else:
        with h5py.File(path, "w") as f:
            if kind == "chunked":
                f.create_dataset("a", data=data, chunks=(4, 4))
            elif kind == "gzip":
                f.create_dataset("a", data=data, compression="gzip")
            else:
                f.create_dataset("a", data=data.astype(">f4"))
    with pytest.raises(H5Error, match=match):
        list(H5File(path).datasets())


@pytest.fixture(scope="module")
def trained():
    m = MaskRCNN("inference", InferenceShapesConfig(), device="cpu")
    m.load_weights(TRAINED)
    return m


def test_trained_checkpoint_equals_jax_import(trained):
    """Strict load of the committed checkpoint: the port's tensors equal
    load_jax_params of the JAX importer's strict tree, bit for bit."""
    jm = JMaskRCNN("inference", JShapes())
    shape = tuple(int(s) for s in jm.config.IMAGE_SHAPE[:2])
    tree = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1,) + shape + (3,)),
                          jnp.asarray(j_anchors(jm.config,
                                                jm.config.IMAGE_SHAPE)),
                          jnp.zeros((1, 4)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    v = jax.tree.map(np.asarray, j_load(TRAINED, zeros, strict=True))
    ref = MaskRCNN("inference", InferenceShapesConfig(), device="cpu")
    load_jax_params(v, ref, device="cpu")
    got, want = _weights(trained), _weights(ref)
    assert got.keys() == want.keys() and len(got) > 300
    for k in want:
        assert torch.equal(got[k], want[k]), k
    layers = keras_layers(TRAINED)
    assert len(layers) == 133 and "rpn_conv_shared" in layers


def test_trained_bf16_map(trained):
    """The loaded checkpoint detects: mAP@50 over the 20 committed scenes
    in the default bf16 configuration (the JAX package's CPU path scores
    0.684 in f32, PARITY.json; random weights score about 0)."""
    assert trained.module.dtype == torch.bfloat16
    m_ap = evaluate_map(trained, detect_scenes())
    assert m_ap >= 0.64, m_ap
