"""Carry the JAX package's Flax variables into the port's modules.

``load_jax_params(variables, model)`` takes the variables as a nested dict
of numpy arrays (what ``jax.tree.map(np.asarray, model.params)`` gives)
and writes them into ``model.module``. It is strict, like
``import_h5.load_h5_weights(strict=True)``: every leaf must be used and
every parameter and buffer of the port written.

Layout mappings:
* Conv kernel HWIO -> OIHW.
* Dense kernel [in, out] -> [out, in].
* BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) by name; the Flax scope's inner ``bn`` level is dropped.
* ConvTranspose (the mask head's deconv): Flax's lax.conv_transpose does
  not flip the kernel and PyTorch's transposed convolution does, so the
  spatial dims are flipped and (in, out) move to the front.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.models.backbone import Conv
from slam_maskrcnn_tpu_torch.models.heads import ConvTranspose, Dense


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _convert(module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return arr
    if isinstance(module, ConvTranspose):
        return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if isinstance(module, Conv):
        return arr.transpose(3, 2, 0, 1)
    if isinstance(module, Dense):
        return arr.T
    raise TypeError(f"no kernel mapping for {type(module).__name__}")


def flax_array(module, name: str) -> np.ndarray:
    """The port tensor ``name`` of ``module`` as a numpy array in the Flax
    layout: the inverse of ``_convert``."""
    arr = _targets(module)[name].detach().cpu().numpy()
    if name.rsplit(".", 1)[-1] != "weight":
        return arr
    owner = module.get_submodule(name.rsplit(".", 1)[0])
    if isinstance(owner, ConvTranspose):
        return np.ascontiguousarray(
            arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    if isinstance(owner, Conv):
        return np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
    if isinstance(owner, Dense):
        return np.ascontiguousarray(arr.T)
    raise TypeError(f"no kernel mapping for {type(owner).__name__}")


def flax_path(module, name: str) -> tuple:
    """The Flax variable path of the port tensor ``name``: (collection,
    scope..., leaf), e.g. ("params", "resnet", "Bottleneck_0",
    "bn2a_branch2a", "bn", "scale") or ("batch_stats", ..., "mean"). The
    inverse of ``load_jax_params``' renaming."""
    from slam_maskrcnn_tpu_torch.models.backbone import BatchNorm

    scope, leaf = name.split(".")[:-1], name.split(".")[-1]
    owner = module.get_submodule(".".join(scope))
    if isinstance(owner, BatchNorm):
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        return (collection, *scope, "bn", leaf)
    return ("params", *scope, {"weight": "kernel"}.get(leaf, leaf))


def flax_variables(model) -> dict:
    """``model.module``'s tensors as a nested dict of numpy arrays in the
    Flax layout and tree (what ``load_jax_params`` takes)."""
    out: dict = {}
    for name in _targets(model.module):
        node = out
        *scope, leaf = flax_path(model.module, name)
        for k in scope:
            node = node.setdefault(k, {})
        node[leaf] = flax_array(model.module, name)
    return out


def flax_shape(module, name: str) -> tuple:
    """The Flax-layout shape of the port tensor ``name`` of ``module``:
    what ``_convert`` takes to give the tensor's shape."""
    shape = tuple(_targets(module)[name].shape)
    if name.rsplit(".", 1)[-1] != "weight":
        return shape
    owner = module.get_submodule(name.rsplit(".", 1)[0])
    if isinstance(owner, ConvTranspose):
        return shape[2:] + shape[:2]
    if isinstance(owner, Conv):
        return shape[2:] + (shape[1], shape[0])
    if isinstance(owner, Dense):
        return shape[::-1]
    raise TypeError(f"no kernel mapping for {type(owner).__name__}")


def _targets(module) -> dict:
    """Every parameter and buffer of ``module`` by name."""
    targets = dict(module.named_parameters())
    targets.update(dict(module.named_buffers()))
    return targets


def write_flax_arrays(model, arrays: dict, device):
    """Write {port tensor name: Flax-layout array} into ``model.module``
    (layouts converted by ``_convert``, values cast to each tensor's
    dtype), then move the module to ``device``. Shapes are checked."""
    dev = resolve_device(device)
    module = model.module
    targets = _targets(module)
    for name, arr in arrays.items():
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        val = _convert(owner, name.rsplit(".", 1)[-1], np.asarray(arr))
        t = targets[name]
        if tuple(val.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {val.shape} does not fit "
                             f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(val)).to(t.dtype))
    module.to(dev)
    model.device = dev
    model.initialized = True
    return module


def load_jax_params(variables, model, device="cuda"):
    """Write Flax ``variables`` ({"params": ..., "batch_stats": ...}) into
    ``model.module`` and move it to ``device``. Raises on any unused leaf,
    unwritten port tensor, or shape mismatch."""
    dev = resolve_device(device)
    targets = _targets(model.module)
    rename = {"kernel": "weight", "bias": "bias", "scale": "scale",
              "mean": "mean", "var": "var"}
    arrays, unused = {}, []
    for path, arr in _flatten(variables):
        collection, scope, leaf = path[0], list(path[1:-1]), path[-1]
        if collection not in ("params", "batch_stats"):
            unused.append("/".join(path))
            continue
        if scope and scope[-1] == "bn":   # Flax BatchNorm's inner scope
            scope = scope[:-1]
        name = ".".join(scope + [rename.get(leaf, leaf)])
        if name not in targets:
            unused.append("/".join(path))
            continue
        arrays[name] = arr
    missing = sorted(set(targets) - set(arrays))
    if unused or missing:
        raise KeyError(f"strict load: unused variables {unused[:10]} "
                       f"({len(unused)}), unwritten port tensors "
                       f"{missing[:10]} ({len(missing)})")
    return write_flax_arrays(model, arrays, dev)
