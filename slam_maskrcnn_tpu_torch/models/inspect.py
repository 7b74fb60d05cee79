"""Model inspection tools.

Port of slam_maskrcnn_tpu/models/inspect.py (the reference's
``run_graph``, ``Mask_RCNN/mrcnn/model.py:2623-2672``: intermediate
tensors by name, and the inspect_weights notebook's weight statistics).
Where the JAX package captures Flax intermediates, the port registers a
forward hook on every submodule; the names are the Flax ones, so that the
two packages' dumps line up key for key:

* an activation is ``<scope>/__call__/<call>`` (the module's Flax scope,
  its call index: the RPN head runs once a pyramid level), with
  ``/<i>`` or ``/<key>`` appended for the elements of a tuple or dict
  output; the graph's outputs also appear as ``out/<key>``;
* 4-D activations of the convolutional layers (NCHW in the port) are
  returned NHWC, as the JAX package has them;
* a weight is ``<collection>/<scope>/<leaf>`` in the Flax layout
  (models/weights.py ``flax_variables``), e.g.
  ``params/resnet/conv1/kernel`` or ``batch_stats/resnet/bn_conv1/bn/mean``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.models.backbone import (FPN, BatchNorm,
                                                     Bottleneck, Conv, ResNet)
from slam_maskrcnn_tpu_torch.models.heads import ConvTranspose

# modules whose 4-D outputs are NCHW
_NCHW = (Conv, BatchNorm, ConvTranspose, Bottleneck, ResNet, FPN)


def _numpy(t, nchw: bool):
    a = t.detach()
    if nchw and a.dim() == 4:
        a = a.permute(0, 2, 3, 1)
    return a.float().cpu().numpy() if a.is_floating_point() \
        else a.cpu().numpy()


def _flatten(value, prefix: str, nchw: bool, out: dict):
    if isinstance(value, torch.Tensor):
        out[prefix] = _numpy(value, nchw)
    elif isinstance(value, dict):
        for k, v in value.items():
            _flatten(v, f"{prefix}/{k}", nchw, out)
    elif isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            _flatten(v, f"{prefix}/{i}", nchw, out)


def run_graph(model, images, filter_fn=None) -> dict:
    """Run inference on ``images`` (a list of RGB arrays) capturing every
    submodule's output. Returns {name: numpy array} (names in the module
    docstring); ``filter_fn(name) -> bool`` narrows the capture."""
    module = model.module
    calls: dict = {}
    acts: dict = {}

    def hook_for(name: str, mod):
        scope = "/".join(name.split(".")) if name else ""
        nchw = isinstance(mod, _NCHW)

        def hook(_, __, output):
            i = calls.get(name, 0)
            calls[name] = i + 1
            key = f"{scope}/__call__/{i}" if scope else f"__call__/{i}"
            _flatten(output, key, nchw, acts)
        return hook

    handles = [m.register_forward_hook(hook_for(n, m))
               for n, m in module.named_modules()]
    try:
        with torch.no_grad():
            out, _, _ = model.run_graph(images)
    finally:
        for h in handles:
            h.remove()
    if filter_fn is not None:
        acts = {k: v for k, v in acts.items() if filter_fn(k)}
    _flatten(out, "out", False, acts)
    return acts


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def weight_stats(model, pattern: str | None = None) -> list:
    """One row a weight (name, shape, min, max, mean, std), the weights in
    the Flax names and layout; ``pattern`` (a regex) keeps the names it
    finds."""
    from slam_maskrcnn_tpu_torch.models.weights import flax_variables

    rows = []
    for path, a in _walk(flax_variables(model)):
        name = "/".join(path)
        if pattern and not re.search(pattern, name):
            continue
        a = np.asarray(a)
        rows.append(dict(name=name, shape=tuple(a.shape),
                         min=float(a.min()), max=float(a.max()),
                         mean=float(a.mean()), std=float(a.std())))
    return rows


def find_suspicious_weights(model, dead_std: float = 1e-5,
                            explode: float = 1e3) -> list:
    """The rows of ``weight_stats`` that look dead (std below
    ``dead_std``) or exploding (a magnitude above ``explode``), the check
    the inspect_weights notebook does by eye."""
    return [row for row in weight_stats(model)
            if row["std"] < dead_std
            or max(abs(row["min"]), abs(row["max"])) > explode]
