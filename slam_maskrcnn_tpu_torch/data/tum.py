"""TUM RGB-D dataset frontend.

Copy of slam_maskrcnn_tpu/data/tum.py (the port keeps its own copy); the
one change is that frames are read with data/image_io.py ``imread`` in
place of ``cv2.imread``, with the same flags.

Host-side (pure numpy) re-implementation of the reference's L0 layer:
``read_trajactory``/``parse_extrinsic`` (``src/SfM_CUDA/utils.cu:8-75``),
the filename-timestamp parsing + two-pointer stream matching of
``kernel.cpp:50-68``, ``mean_depth`` (``utils.cu:77-91``), and the slerp
pose interpolation of the NumPy prototype (``src/TSDF_Python/main.py:127-140``,
``tsdf_utils.py:64-103``).

Timestamp convention (a reference quirk preserved deliberately): both the
filename timestamps and the groundtruth keys are truncated to
``fmod(ts, 1e5)`` — the filename parser skips the first 5 chars of the
10-digit unix-seconds stem (``kernel.cpp:53``) and the trajectory reader
keys by ``fmod(ts, 1e5)`` (``utils.cu:72``) so the two agree.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from slam_maskrcnn_tpu_torch.data.image_io import (IMREAD_ANYDEPTH,
                                                   IMREAD_GRAYSCALE, imread)


def filename_timestamp(path: str) -> float:
    """Timestamp from a TUM frame filename, truncated mod 1e5.

    '<dir>/1311871923.004312.png' -> 71923.004312 (kernel.cpp:51-58).
    """
    stem = os.path.basename(path)
    stem = stem[: stem.rfind(".")]
    return float(np.fmod(float(stem), 1e5))


def quaternion_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (qx, qy, qz, qw) -> 3x3 rotation matrix.

    Equivalent to the reference's axis-angle + Rodrigues route
    (``utils.cu:9-16``): theta = 2*atan2(|v|, qw), axis = v/|v|.
    """
    qx, qy, qz, qw = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


def pose_matrix(pose: np.ndarray) -> np.ndarray:
    """(tx, ty, tz, qx, qy, qz, qw) -> 4x4 camera-to-world matrix."""
    pose = np.asarray(pose, np.float64)
    E = np.eye(4)
    E[:3, :3] = quaternion_matrix(pose[3:7])
    E[:3, 3] = pose[:3]
    return E


def parse_extrinsic(pose: np.ndarray) -> np.ndarray:
    """TUM pose -> world-to-camera 4x4 (the reference *returns the inverse*,
    ``utils.cu:23``)."""
    return np.linalg.inv(pose_matrix(pose)).astype(np.float32)


def slerp(q1: np.ndarray, q2: np.ndarray, t: float) -> np.ndarray:
    """Quaternion slerp, matching ``tsdf_utils.slerp`` (``tsdf_utils.py:81-103``)
    including the lerp shortcut above dot 0.9995."""
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    q1 = q1 / np.linalg.norm(q1)
    q2 = q2 / np.linalg.norm(q2)
    dot = float(np.dot(q1, q2))
    if dot < 0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        return q1 + t * (q2 - q1)
    dot = max(min(dot, 1.0), -1.0)
    theta_0 = np.arccos(dot)
    theta = theta_0 * t
    s1 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta_0)
    s2 = np.sin(theta) / np.sin(theta_0)
    return s1 * q1 + s2 * q2


@dataclasses.dataclass
class Trajectory:
    """Sorted ground-truth trajectory: timestamps (mod 1e5) + raw poses."""

    timestamps: np.ndarray  # f64 [N]
    poses: np.ndarray       # f64 [N, 7] (tx ty tz qx qy qz qw)

    def lower_bound(self, ts: float) -> np.ndarray:
        """Pose at the first timestamp >= ts — the reference's
        ``traj.lower_bound(ts)`` lookup (``kernel.cpp:97``)."""
        i = int(np.searchsorted(self.timestamps, ts, side="left"))
        i = min(i, len(self.timestamps) - 1)
        return self.poses[i]

    def interpolate(self, ts: float) -> np.ndarray:
        """Linear position + slerp rotation between the bracketing samples —
        the NumPy prototype's variant (``TSDF_Python/main.py:127-138``)."""
        k = int(np.searchsorted(self.timestamps, ts, side="left"))
        if k <= 0:
            return self.poses[0]
        if k >= len(self.timestamps):
            return self.poses[-1]
        t0, t1 = self.timestamps[k - 1], self.timestamps[k]
        t = (ts - t0) / (t1 - t0) if t1 > t0 else 0.0
        p0, p1 = self.poses[k - 1], self.poses[k]
        return np.concatenate([
            p0[:3] + t * (p1[:3] - p0[:3]),
            slerp(p0[3:7], p1[3:7], t),
        ])

    def extrinsic_at(self, ts: float, interpolate: bool = False) -> np.ndarray:
        pose = self.interpolate(ts) if interpolate else self.lower_bound(ts)
        return parse_extrinsic(pose)


def read_trajectory(path: str) -> Trajectory:
    """Parse groundtruth.txt. Skips comments/malformed lines (utils.cu:70);
    keys timestamps by fmod(ts, 1e5) (utils.cu:72)."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            try:
                vals = [float(p) for p in parts[:8]]
            except ValueError:
                continue
            stamps.append(np.fmod(vals[0], 1e5))
            poses.append(vals[1:8])
    ts = np.asarray(stamps, np.float64)
    ps = np.asarray(poses, np.float64)
    order = np.argsort(ts)
    return Trajectory(ts[order], ps[order])


def mean_depth(depth: np.ndarray, depth_scale: float = 5000.0) -> float:
    """Mean metric depth over nonzero pixels (``utils.cu:77-91``)."""
    valid = depth > 0
    if not valid.any():
        return 0.0
    return float((depth[valid].astype(np.float64) / depth_scale).mean())


def filter_gaussian(depth: np.ndarray, iters: int = 1):
    """Iterative 3-sigma depth outlier rejection, the TSDF_CPP prototype's
    preprocessing (``src/TSDF_CPP/main.cpp:40-91``): per pass, zero every
    nonzero pixel beyond 3 standard deviations of the nonzero mean, and
    return the survivors' mean (RAW sensor units, as the reference —
    callers divide by the depth scale). "Can be performed multiple times"
    per the reference comment; `iters` controls that. In-place on a copy.
    """
    depth = depth.copy()
    mean = 0.0
    for _ in range(max(iters, 1)):
        vals = depth[depth > 0].astype(np.float64)
        if vals.size == 0:
            return depth, 0.0
        mean = vals.mean()
        std = vals.std()  # population std, as the reference's MLE
        kill = (depth > 0) & (np.abs(depth.astype(np.float64) - mean)
                              > 3.0 * std)
        depth[kill] = 0
        vals = depth[depth > 0].astype(np.float64)
        mean = vals.mean() if vals.size else 0.0
    return depth, float(mean)


def match_timestamps(depth_ts: np.ndarray, mask_ts: np.ndarray,
                     begin: float = -np.inf, end: float = np.inf,
                     max_frames: int | None = None):
    """Two-pointer depth<->mask stream sync (``kernel.cpp:64-74``): advance
    whichever stream lags until timestamps meet; keep frames whose depth
    timestamp lies in [begin, end]; cap at max_frames.

    Returns list of (depth_index, mask_index) pairs.
    """
    out = []
    i, j = 0, 0
    while i < len(depth_ts) and j < len(mask_ts):
        if depth_ts[i] < mask_ts[j]:
            i += 1
            continue
        if mask_ts[j] < depth_ts[i]:
            j += 1
            continue
        if begin <= depth_ts[i] <= end:
            out.append((i, j))
            if max_frames is not None and len(out) >= max_frames:
                break
        i += 1
        j += 1
    return out


class TUMSequence:
    """Directory-layout loader for a TUM RGB-D sequence with precomputed
    masks: <root>/{rgb,depth,mask}/*.png + groundtruth.txt (the dataset
    contract of ``kernel.cpp:41-48``)."""

    def __init__(self, root: str, begin: float = -np.inf, end: float = np.inf,
                 max_frames: int | None = None, interpolate_poses: bool = False):
        self.root = root
        self.rgb_files = sorted(glob.glob(os.path.join(root, "rgb", "*.png")))
        self.depth_files = sorted(glob.glob(os.path.join(root, "depth", "*.png")))
        self.mask_files = sorted(glob.glob(os.path.join(root, "mask", "*.png")))
        self.trajectory = read_trajectory(os.path.join(root, "groundtruth.txt"))
        self.interpolate_poses = interpolate_poses
        depth_ts = np.array([filename_timestamp(f) for f in self.depth_files])
        # without precomputed masks (live pipeline), pair depth<->rgb instead
        self.has_masks = len(self.mask_files) > 0
        second = self.mask_files if self.has_masks else self.rgb_files
        second_ts = np.array([filename_timestamp(f) for f in second])
        self.pairs = match_timestamps(depth_ts, second_ts, begin, end,
                                      max_frames)
        self.depth_ts = depth_ts

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, k: int):
        """Returns dict(depth u16 [H,W], color u8 [H,W,3] BGR, mask u8 [H,W],
        extrinsic f32 [4,4] world->camera, mean_depth float, timestamp)."""
        i, j = self.pairs[k]
        depth = imread(self.depth_files[i], IMREAD_ANYDEPTH)
        mask = (imread(self.mask_files[j], IMREAD_GRAYSCALE)
                if self.has_masks else None)
        # NOTE: the reference indexes rgb by the *mask* pointer j
        # (kernel.cpp:71) — rgb and mask share timestamps by construction.
        color = imread(self.rgb_files[j])
        ts = self.depth_ts[i]
        extrinsic = self.trajectory.extrinsic_at(ts, self.interpolate_poses)
        return dict(depth=depth, color=color, mask=mask, extrinsic=extrinsic,
                    mean_depth=mean_depth(depth), timestamp=ts)
