"""The comparisons that decide ``correct``, and what the window keeps for
them.

The fused state is 10-13 GB at 512^3, too large to keep a copy of inside
the window, so the driver keeps ``PLANES`` x-planes of it (drawn from the
run's seed) right after the judged frames, a device copy of about 20 MB
a plane; the reference's state is compared on the same planes.
"""

from __future__ import annotations

import numpy as np
import torch

PLANES = 8
FIELDS = ("diff", "weight", "color", "hist")


def pick(seed: int, n: int, k: int, salt: int) -> np.ndarray:
    """``k`` sorted distinct indices below ``n`` drawn from the seed."""
    rng = np.random.default_rng([seed, salt])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def planes(state, xs) -> dict:
    """Copies of the state's x-planes ``xs`` (and its counters)."""
    idx = torch.as_tensor(xs, device=state.diff.device)
    out = {f: getattr(state, f).index_select(0, idx) for f in FIELDS}
    out["num_objs"] = state.num_objs.clone()
    out["n_obs"] = state.n_obs
    return out


def share_differing(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of the elements where two stacks of images differ (a pixel
    differs when any of its channels does)."""
    ne = a != b
    if ne.dim() == 4:                      # [N, H, W, 3]
        ne = ne.any(-1)
    return float(ne.float().mean())


def label_mismatch(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest share, over a stack of label images [N, H, W], of a
    frame's labelled pixels (labelled in either image) whose labels
    differ: 0 when the detections agree, near 1 for a frame whose
    detections all moved."""
    ref = ref.to(prog.device)
    fg = ((prog > 0) | (ref > 0)).flatten(1).sum(1)
    ne = (prog != ref).flatten(1).sum(1)
    return float((ne.float() / fg.clamp_min(1).float()).max())


def state_numbers(prog: dict, ref: dict) -> dict:
    """``diff_max_err``: the largest |diff| gap on the kept planes (the
    fuse kernel's division rounds differently from the plain one's, by up
    to 2e-6 a frame); ``state_mismatch``: the share of kept voxels whose
    weight, color or histogram differ, plus 1 if the counters differ."""
    d = float((prog["diff"] - ref["diff"].to(prog["diff"].device))
              .abs().max())
    ne = (prog["weight"] != ref["weight"].to(prog["weight"].device))
    ne |= (prog["color"] != ref["color"].to(prog["color"].device)).any(-1)
    ne |= (prog["hist"] != ref["hist"].to(prog["hist"].device)).any(-1)
    counters = (int(prog["num_objs"]) != int(ref["num_objs"])
                or prog["n_obs"] != ref["n_obs"])
    return dict(diff_max_err=d,
                state_mismatch=float(ne.float().mean()) + float(counters))
