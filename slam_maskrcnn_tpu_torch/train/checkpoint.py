"""Parameter checkpoints of the training loop.

Port of slam_maskrcnn_tpu/train/checkpoint.py: the reference's per-epoch
checkpoint and filename-regex resume (``Mask_RCNN/mrcnn/model.py:
2054-2077, 2208-2242``), with the JAX package's conventions: a dated run
directory ``<model_dir>/<name><YYYYmmddTHHMM>``, checkpoints named
``mask_rcnn_<name>_<epoch:04d>``, ``find_last`` picking the newest of the
newest run. The file is the port's own (``torch.save`` of every parameter
and buffer by name); models/h5.py ``save_h5_weights`` is the format both
packages read.
"""

from __future__ import annotations

import datetime
import os
import re

import torch


def _tensors(model) -> dict:
    module = model.module
    out = dict(module.named_parameters())
    out.update(dict(module.named_buffers()))
    return out


def save_params(model, path: str) -> str:
    """Every parameter and buffer of ``model.module``, on the CPU, into
    ``path``."""
    path = os.path.abspath(path)
    torch.save({k: v.detach().cpu() for k, v in _tensors(model).items()},
               path)
    return path


def restore_params(path: str, model):
    """Load a ``save_params`` file into ``model.module`` (strict: the same
    names and shapes). Returns the module."""
    state = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    targets = _tensors(model)
    if set(state) != set(targets):
        raise KeyError(f"checkpoint {path} does not fit the model: missing "
                       f"{sorted(set(targets) - set(state))[:10]}, unused "
                       f"{sorted(set(state) - set(targets))[:10]}")
    with torch.no_grad():
        for k, t in targets.items():
            if tuple(state[k].shape) != tuple(t.shape):
                raise ValueError(f"{k}: checkpoint shape "
                                 f"{tuple(state[k].shape)} vs {tuple(t.shape)}")
            t.copy_(state[k])
    model.initialized = True
    return model.module


def run_dir(model_dir: str, name: str) -> str:
    """Dated run directory (model.py:2208-2220)."""
    now = datetime.datetime.now()
    d = os.path.join(model_dir, f"{name.lower()}{now:%Y%m%dT%H%M}")
    os.makedirs(d, exist_ok=True)
    return d


def checkpoint_path(run_directory: str, name: str, epoch: int) -> str:
    return os.path.join(run_directory,
                        f"mask_rcnn_{name.lower()}_{epoch:04d}")


def epoch_from_path(path: str) -> int:
    """The epoch a checkpoint's name carries, or 0: the checkpoint saved
    at the end of epoch N is ...NNNN, and training resumes at epoch N
    (model.py:2208-2242)."""
    m = re.search(r"mask_rcnn_[\w\-]+?_(\d{4})$", os.path.basename(path))
    return int(m.group(1)) if m else 0


def find_last(model_dir: str, name: str) -> str:
    """Newest checkpoint of the newest run (model.py:2054-2077)."""
    key = name.lower()
    runs = sorted(d for d in os.listdir(model_dir) if d.startswith(key))
    for run in reversed(runs):
        rd = os.path.join(model_dir, run)
        ckpts = sorted(f for f in os.listdir(rd) if re.match(r"mask_rcnn", f))
        if ckpts:
            return os.path.join(rd, ckpts[-1])
    raise FileNotFoundError(f"no checkpoints for {name} under {model_dir}")
