"""Volume snapshot and restore.

Port of slam_maskrcnn_tpu/fusion/checkpoint.py. The reference never saves
the fused volume (it renders and exits); the JAX package writes one
compressed .npz in the dense layout, and this module reads and writes the
same file: the same keys and dtypes (diff f32, color u8, weight i32, hist
u16 or u32, geometry f32, n_obs and num_objs i32, the majority-vote fields
``mv_id`` / ``mv_cnt`` i32, as [1, 1, 1] placeholders in a histogram
volume and a (1, 1, 1, 1) placeholder hist in a majority-vote one,
``vol_dim`` i64), so a snapshot written by either package loads in the
other.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.fusion.fuse import from_dense, to_dense
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, TSDFState


def save_volume(path: str, state: TSDFState, cfg: FusionConfig) -> str:
    """Snapshot a volume (read back from its device) into ``path``."""
    d = to_dense(state)
    np.savez_compressed(
        path,
        vol_dim=np.asarray(cfg.vol_dim, np.int64),
        voxel=np.asarray(d.voxel, np.float32),
        mu=np.asarray(d.mu, np.float32),
        diff=d.diff, color=d.color, weight=d.weight, hist=d.hist,
        vol_start=np.asarray(d.vol_start, np.float32),
        vol_end=np.asarray(d.vol_end, np.float32),
        n_obs=np.asarray(d.n_obs, np.int32),
        num_objs=np.asarray(d.num_objs, np.int32),
        mv_id=d.mv_id, mv_cnt=d.mv_cnt)
    return path


def load_volume(path: str, cfg: FusionConfig, device="cuda",
                backend: str = "pallas") -> TSDFState:
    """Restore a snapshot onto ``device``: into the fuse kernel's u16 store
    (backend "pallas", the default) or the dense path's cfg.hist_dtype
    store (backend "xla"). Raises ValueError if it was saved at another
    ``vol_dim``, with another number of histogram bins, in the other
    majority-vote mode than ``cfg``, or (kernel store) with a count above
    65535: a count is never wrapped."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"backend {backend!r}: 'xla' or 'pallas'")
    device = resolve_device(device)
    z = np.load(path)
    if "vol_dim" in z:  # written by this version; older snapshots lack it
        saved_dim = tuple(int(d) for d in z["vol_dim"])
        if saved_dim != tuple(cfg.vol_dim):
            raise ValueError(
                f"snapshot was saved at vol_dim={saved_dim} but cfg has "
                f"vol_dim={tuple(cfg.vol_dim)}; voxel pitch/mu would be "
                "inconsistent with the restored arrays")
    elif tuple(cfg.vol_dim) != z["diff"].shape:
        raise ValueError(
            f"snapshot arrays are {z['diff'].shape} but cfg.vol_dim is "
            f"{tuple(cfg.vol_dim)}")
    mv = z["mv_id"].shape == z["diff"].shape
    if mv != cfg.majority_vote or (mv and backend == "pallas"):
        raise ValueError(
            f"snapshot was saved {'in' if mv else 'without'} majority-vote "
            f"mode; it loads only into a {'majority-vote' if mv else 'histogram'}"
            f" config{' on the dense path (xla)' if mv else ''}")
    if not mv and z["hist"].shape[-1] != cfg.max_objects:
        raise ValueError(
            f"snapshot histogram has {z['hist'].shape[-1]} bins but "
            f"cfg.max_objects is {cfg.max_objects}")
    return from_dense(SimpleNamespace(
        diff=z["diff"], color=z["color"], weight=z["weight"],
        hist=z["hist"], vol_start=z["vol_start"], vol_end=z["vol_end"],
        voxel=z["voxel"], mu=z["mu"], n_obs=int(z["n_obs"]),
        num_objs=int(z["num_objs"]), mv_id=z["mv_id"], mv_cnt=z["mv_cnt"]),
        device, np.uint16 if backend == "pallas" else cfg.hist_dtype)
