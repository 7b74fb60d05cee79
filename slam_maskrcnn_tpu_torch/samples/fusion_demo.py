"""Semantic TSDF fusion driver, stage 2: the ``kernel.cpp`` equivalent.

Port of slam_maskrcnn_tpu/samples/fusion_demo.py (=
``src/SfM_CUDA/kernel.cpp:37-111``): glob a TUM sequence's
rgb/depth/mask folders, two-pointer-sync the streams, fuse the timestamp
window [68164, 68170] (<= 100 frames) with ground-truth poses, then orbit
the fused volume (angle += 0.01 a frame, dist = the first mean depth).
The reference's constants are flags with its values as defaults
(intrinsics 520.9/521.0/325.1/249.7, kernel.cpp:39). ``--backend``
chooses the fuse path as the JAX driver's does: "pallas" (default) the
CUDA fuse kernel on a u16 histogram, "xla" the dense torch fuse on a u32
one with the exact ray-march probe; ``--device`` (cuda or cpu) where it
runs.

    python -m slam_maskrcnn_tpu_torch.samples.fusion_demo \\
        --dataset seq --orbit-frames 100 --save-dir orbit [--backend xla]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def run(dataset: str, begin: float = 68164.0, end: float = 68170.0,
        max_frames: int = 100, vol_dim: int = 256, backend: str = "pallas",
        intrinsics=(520.9, 521.0, 325.1, 249.7), orbit_frames: int = 0,
        save_dir: str | None = None, interpolate_poses: bool = False,
        verbose: bool = True, device="cuda"):
    """Fuse the sequence and orbit it. Returns (SemanticFusion, orbit
    frames as u8 [H, W, 3] RGB numpy arrays)."""
    from slam_maskrcnn_tpu_torch.data.tum import TUMSequence
    from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)
    from slam_maskrcnn_tpu_torch.viz.viewer import Viewer

    K = make_intrinsic(*intrinsics)
    cfg = FusionConfig(vol_dim=(vol_dim,) * 3,
                       hist_dtype=np.uint16 if backend == "pallas"
                       else np.uint32)
    seq = TUMSequence(dataset, begin=begin, end=end, max_frames=max_frames,
                      interpolate_poses=interpolate_poses)
    if len(seq) == 0:
        raise SystemExit(f"no frames matched in [{begin}, {end}] under "
                         f"{dataset}")
    fusion = SemanticFusion(K, cfg, backend=backend, device=device)
    t0 = time.time()
    H = W = None
    for i in range(len(seq)):
        fr = seq[i]
        H, W = fr["depth"].shape
        fusion.parse_frame(fr["depth"], fr["color"], fr["mask"],
                           fr["extrinsic"], fr["mean_depth"])
        if verbose:
            print(f"processing: {i} ts={fr['timestamp']:.6f}")
    float(fusion.state.weight.sum())        # a readback ends the queue
    dt = time.time() - t0
    n_fused = max(len(seq) - 1, 1)
    if verbose:
        print(f"fused {n_fused} frames in {dt:.2f}s "
              f"({n_fused / dt:.2f} frames/sec incl. PNG reads)")

    if orbit_frames:
        viewer = Viewer(W, H, K, cfg, backend)
        frames = viewer.spin(fusion.state, fusion.mean_depth,
                             n_frames=orbit_frames, save_dir=save_dir)
        return fusion, frames
    return fusion, []


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   help="TUM sequence root with rgb/ depth/ mask/ "
                        "groundtruth.txt")
    p.add_argument("--begin", type=float, default=68164.0)
    p.add_argument("--end", type=float, default=68170.0)
    p.add_argument("--max-frames", type=int, default=100)
    p.add_argument("--vol-dim", type=int, default=256)
    p.add_argument("--backend", choices=["xla", "pallas"], default="pallas")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--orbit-frames", type=int, default=100,
                   help="orbit frames to render after fusing (0 = skip)")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--slerp", action="store_true",
                   help="slerp pose interpolation (TSDF_Python behavior) "
                        "instead of lower_bound lookup")
    a = p.parse_args(argv)
    return run(a.dataset, a.begin, a.end, a.max_frames, a.vol_dim,
               a.backend, orbit_frames=a.orbit_frames, save_dir=a.save_dir,
               interpolate_poses=a.slerp, device=a.device)


if __name__ == "__main__":
    main()
