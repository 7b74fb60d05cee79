"""Rank functions of the multi-rank tests (tests/test_torch_sharding.py,
tests/test_torch_train_dp.py), run by parallel/sharding.py ``launch``.

A spawned rank imports this module in a fresh interpreter, so it imports
torch and the port only, never JAX; the tests hold the results against the
JAX package in their own bodies. Inputs arrive as numpy arrays and plain
values; each function returns numpy arrays (rank 0's, unless noted).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.fusion.fuse import from_dense, to_dense
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.parallel import (gather_volume_state,
                                              make_sharded_fusion_step,
                                              make_sharded_render,
                                              shard_volume_state)


def _state_arrays(vol) -> dict:
    d = to_dense(vol)
    return dict(diff=d.diff, color=d.color, weight=d.weight, hist=d.hist,
                num_objs=d.num_objs, n_obs=d.n_obs)


def sharded_fuse(mesh, cfg_kwargs: dict, init: dict, frames: list,
                 intrinsic: np.ndarray, max_blocks: int) -> dict | None:
    """The sharded fusion step over ``frames`` [(depth, color, mask, e2i)]
    from the dense ``init`` arrays; rank 0 returns the gathered state, the
    relabeled masks and the misses of every frame."""
    cfg = FusionConfig(**cfg_kwargs)
    full = from_dense(_Dense(init), device="cpu")
    vol = shard_volume_state(full, mesh)
    step = make_sharded_fusion_step(cfg, mesh, max_blocks=max_blocks)
    masks, misses = [], []
    for d, c, m, e2i in frames:
        vol, mask_g, miss = step(vol, torch.from_numpy(d),
                                 torch.from_numpy(c), torch.from_numpy(m),
                                 e2i, intrinsic)
        masks.append(mask_g.numpy())
        misses.append(int(miss))
    whole = gather_volume_state(vol, mesh)
    if mesh.rank != 0:
        return None
    return dict(state=_state_arrays(whole), masks=np.stack(masks),
                misses=misses)


def sharded_render(mesh, cfg_kwargs: dict, state: dict, angle: float,
                   dist: float, intrinsic: np.ndarray, H: int, W: int,
                   max_blocks: int) -> dict:
    """Both render modes of the sharded render of the dense ``state``;
    every rank returns its images (they must agree)."""
    cfg = FusionConfig(**cfg_kwargs)
    vol = shard_volume_state(from_dense(_Dense(state), device="cpu"), mesh)
    return {mode: make_sharded_render(cfg, mesh, max_blocks=max_blocks,
                                      mode=mode)(vol, angle, dist, intrinsic,
                                                 H, W).numpy()
            for mode in ("instance", "color")}


class _Dense:
    """A dict of dense arrays as the attribute object ``from_dense``
    reads."""

    def __init__(self, d: dict):
        self.__dict__.update(d)


def train_config(overrides: dict):
    """A ShapesConfig with ``overrides`` (class attributes)."""
    from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig

    return type("DPConfig", (ShapesConfig,), dict(overrides))()


def dp_step(mesh, overrides: dict, state: dict, batch: dict, pos, neg,
            lr: float, layers: str) -> dict:
    """One data-parallel training step of the global ``batch`` (numpy,
    with the global draws ``pos`` / ``neg``) from the module tensors
    ``state``: this rank's slice through ``Trainer.make_step`` with the
    mesh. Returns the global loss and parts, the module's tensors after the
    step, and the positive rois and the local mask-loss mean of this
    rank's slice."""
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.parallel import shard_batch
    from slam_maskrcnn_tpu_torch.samples.sample_train_smoke import \
        attach_diagnostics
    from slam_maskrcnn_tpu_torch.train.trainer import (BATCH_KEYS,
                                                       LAYER_REGEX, Trainer)

    cfg = train_config(overrides)
    model = MaskRCNN("training", cfg, device=mesh.device)
    model.module.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in state.items()})
    model.module.to(mesh.device)
    model.initialized = True
    records = attach_diagnostics(model)
    step = Trainer(model, cfg).make_step(lr, LAYER_REGEX[layers], mesh)
    local = shard_batch(dict({k: batch[k] for k in BATCH_KEYS},
                             pos=pos, neg=neg), mesh)
    p, n = local.pop("pos"), local.pop("neg")
    local["anchors"] = torch.from_numpy(get_anchors(cfg, cfg.IMAGE_SHAPE))
    loss, parts = step(local, p, n)
    return dict(loss=float(loss), parts={k: float(v) for k, v in
                                         parts.items()},
                state={k: v.detach().cpu().numpy().copy() for k, v in
                       model.module.state_dict().items()},
                positive_rois=records[-1]["positive_rois"],
                local_mask_loss=records[-1]["mask_loss"])


def dp_train(mesh, overrides: dict, state: dict, model_dir: str) -> dict:
    """``Trainer.train`` for one step with GPU_COUNT = mesh.size from the
    module tensors ``state`` on a seeded shapes set, logging and writing
    its checkpoint under ``model_dir``: the history, the module's tensors
    after it (every rank must end with the same), what the rank printed
    and its run directory."""
    import contextlib
    import io

    from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.train.trainer import Trainer

    cfg = train_config(dict(overrides, GPU_COUNT=mesh.size))
    model = MaskRCNN("training", cfg, model_dir=model_dir, device=mesh.device)
    # rank 0's tensors reach the others through the trainer's broadcast
    model.module.load_state_dict({k: torch.from_numpy(v) * (mesh.rank + 1)
                                  for k, v in state.items()})
    model.initialized = True
    ds = ShapesDataset()
    ds.load_shapes(8, 128, 128, seed=3)
    ds.prepare()
    trainer = Trainer(model, cfg)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        history = trainer.train(ds, learning_rate=0.002, epochs=1,
                                layers="heads", steps_per_epoch=1)
    return dict(history=history, printed=printed.getvalue(),
                run_directory=trainer.run_directory,
                state={k: v.detach().cpu().numpy().copy() for k, v in
                       model.module.state_dict().items()})


def dp_steps(mesh, cases: list, train_case: tuple) -> tuple:
    """``dp_step`` for each of ``cases`` (tuples of its arguments after
    the mesh), then ``dp_train(mesh, *train_case)``, in one launch."""
    return [dp_step(mesh, *case) for case in cases], dp_train(mesh,
                                                             *train_case)


def sharded_fuse_dense(mesh, cases: list) -> list:
    """The dense ("xla") sharded fusion step over each case's frames:
    ``cases`` holds (cfg kwargs, the volume's (vol_start, vol_end), frames
    [(depth, color, mask, e2i)], intrinsic), fused into an empty volume.
    Per case, rank 0 returns the gathered state, and every rank its
    relabeled masks and misses."""
    from slam_maskrcnn_tpu_torch.fusion.state import init_state

    out = []
    for cfg_kwargs, (vs, ve), frames, intrinsic in cases:
        cfg = FusionConfig(**cfg_kwargs)
        vol = shard_volume_state(init_state(cfg, vs, ve, device="cpu"), mesh)
        step = make_sharded_fusion_step(cfg, mesh, backend="xla")
        masks, misses = [], []
        for d, c, m, e2i in frames:
            vol, mask_g, miss = step(vol, torch.from_numpy(d),
                                     torch.from_numpy(c),
                                     torch.from_numpy(m), e2i, intrinsic)
            masks.append(mask_g.numpy().copy())
            misses.append(int(miss))
        whole = gather_volume_state(vol, mesh)
        out.append(dict(masks=np.stack(masks), misses=misses,
                        state=None if whole is None else
                        _state_arrays(whole)))
    return out
