"""Orbit viewer of the fused volume, the ``Viewer::show_tsdf`` loop.

Port of slam_maskrcnn_tpu/viz/viewer.py (the reference viewer,
``src/SfM_CUDA/viewer.cu:137-179`` + ``kernel.cpp:101-107``): orbit the
fused volume and render the instance-argmax (or color) view: the kernel
path's volume (backend "pallas") with the splat renderer (fusion/splat.py
``OrbitRenderer``), the dense path's (backend "xla") with the exact ray
march (fusion/raycast.py ``render_orbit``), as the JAX viewer renders a
blocked state and a dense one. Headless: ``show_tsdf``
returns the frame and opens no window (there is no cv2 where the port
runs); ``spin(..., save_dir=...)`` writes the frames as PNGs with
data/png.py.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

from slam_maskrcnn_tpu_torch.data.png import write_png
from slam_maskrcnn_tpu_torch.fusion.splat import OrbitRenderer
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig


class Viewer:
    def __init__(self, width: int, height: int, intrinsic: np.ndarray,
                 cfg: FusionConfig | None = None, backend: str = "pallas"):
        self.width = width
        self.height = height
        self.intrinsic = np.asarray(intrinsic, np.float32)
        if self.intrinsic.shape == (3, 3):
            K = np.eye(4, dtype=np.float32)
            K[:3, :3] = self.intrinsic
            self.intrinsic = K
        self.cfg = cfg
        self.backend = backend
        self._orbit, self._orbit_for = None, None

    def render(self, state, angle: float, dist: float,
               mode: str = "instance") -> np.ndarray:
        """One frame, u8 [H, W, 3] RGB. An orbit loop renders a static
        fused volume (kernel.cpp:101-107), so the splat's shell compaction
        is cached while the volume is unchanged: the same object at the
        same ``n_obs`` (the port fuses in place, and every fuse counts)."""
        if self.backend == "xla":
            from slam_maskrcnn_tpu_torch.fusion.raycast import render_orbit
            return render_orbit(state, angle, dist,
                                np.linalg.inv(self.intrinsic), self.height,
                                self.width, self.cfg or FusionConfig(),
                                mode).cpu().numpy()
        key = (id(state), state.n_obs)
        if self._orbit_for != key:
            self._orbit = OrbitRenderer(state, self.intrinsic, self.height,
                                        self.width, self.cfg or FusionConfig())
            self._orbit_for = key
        return self._orbit.render(angle, dist, mode=mode).cpu().numpy()

    def show_tsdf(self, state, angle: float, dist: float,
                  mode: str = "instance") -> np.ndarray:
        """Render one view (viewer.cu:176-177) and return it; no window."""
        return self.render(state, angle, dist, mode)

    def spin(self, state, dist: float, n_frames: int | None = None,
             angle_step: float = 0.01, mode: str = "instance",
             save_dir: str | None = None):
        """The kernel.cpp:101-107 loop: angle += 0.01 per frame. With
        n_frames set, renders that many and returns them; with save_dir,
        writes each as orbit_<k>.png."""
        frames = []
        angle = 0.0
        it = range(n_frames) if n_frames else itertools.count()
        for k in it:
            angle += angle_step
            img = self.show_tsdf(state, angle, dist, mode)
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                write_png(os.path.join(save_dir, f"orbit_{k:05d}.png"),
                          np.ascontiguousarray(img[:, :, ::-1]))
            if n_frames:
                frames.append(img)
        return frames
