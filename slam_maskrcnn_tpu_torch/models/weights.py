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


def load_jax_params(variables, model, device="cuda"):
    """Write Flax ``variables`` ({"params": ..., "batch_stats": ...}) into
    ``model.module`` and move it to ``device``. Raises on any unused leaf,
    unwritten port tensor, or shape mismatch."""
    dev = resolve_device(device)
    module = model.module
    targets = dict(module.named_parameters())
    targets.update(dict(module.named_buffers()))
    rename = {"kernel": "weight", "bias": "bias", "scale": "scale",
              "mean": "mean", "var": "var"}
    written, unused = set(), []
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
        owner = module.get_submodule(".".join(scope))
        val = _convert(owner, rename[leaf], arr)
        t = targets[name]
        if tuple(val.shape) != tuple(t.shape):
            raise ValueError(f"{'/'.join(path)}: shape {val.shape} does not "
                             f"fit {name} {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(val)).to(t.dtype))
        written.add(name)
    missing = sorted(set(targets) - written)
    if unused or missing:
        raise KeyError(f"strict load: unused variables {unused[:10]} "
                       f"({len(unused)}), unwritten port tensors "
                       f"{missing[:10]} ({len(missing)})")
    module.to(dev)
    model.device = dev
    return module
