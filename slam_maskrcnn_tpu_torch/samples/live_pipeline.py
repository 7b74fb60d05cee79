"""End-to-end streaming pipeline: Mask R-CNN -> semantic TSDF -> render.

Port of slam_maskrcnn_tpu/samples/live_pipeline.py. Per frame: instance
segmentation of the RGB image, the label-encoded mask (dmask semantics),
fusion with instance association, and an optional render. The reference
joins the two stages by mask PNGs on disk; here the same contract runs
live.

* ``step`` / ``run``: the host path. A prefetch thread reads frames ahead;
  ``mask_detect`` (with the depth filter, which needs per-mask medians) or
  ``mask_detect_device`` labels each frame, ``SemanticFusion`` fuses it.
* ``run_device``: the device path. An upload thread stages each frame on
  the card ahead of use; molding (``device_mold_geometry``, the resize of
  ``jax.image.resize``), detect, ``label_masks_device`` and
  ``parse_frame`` run on device tensors, and nothing is read back until
  the end.

    python -m slam_maskrcnn_tpu_torch.samples.live_pipeline \\
        --dataset seq [--weights w.h5] [--vol-dim 256]
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch


class _Ahead:
    """A daemon thread that runs ``make(seq[i])`` for every frame, at most
    ``depth`` ahead of the consumer; iterate to take the results."""

    def __init__(self, seq, make, depth: int):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(seq, make),
                                       daemon=True)
        self.thread.start()

    def _run(self, seq, make):
        try:
            for i in range(len(seq)):
                self.q.put(make(seq[i]))
        except Exception as e:                   # re-raised by the consumer
            self.error = e
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item


class FramePrefetcher(_Ahead):
    """Host-side decode thread: keeps ``depth`` frames decoded ahead."""

    def __init__(self, seq, depth: int = 4):
        super().__init__(seq, lambda fr: fr, depth)


class LivePipeline:
    """detect -> label-encode -> fuse (+ render every ``render_every``)."""

    def __init__(self, model, intrinsic, fusion_cfg=None,
                 backend: str = "pallas", use_depth_filter: bool = True,
                 render_every: int = 0, render_size=None):
        from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
        from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig

        self.model = model
        self.fusion = SemanticFusion(intrinsic, fusion_cfg or FusionConfig(),
                                     backend, device=model.device)
        self.use_depth_filter = use_depth_filter
        self.render_every = render_every
        self.render_size = render_size
        self.frames_done = 0
        self.renders = []
        self.timings = {"detect": 0.0, "fuse": 0.0, "render": 0.0}
        self._viewer = None  # constructed once on first render

    def step(self, depth: np.ndarray, color_bgr: np.ndarray,
             extrinsic: np.ndarray, mean_depth: float | None = None):
        """One frame on the host path. Returns (label mask u8 [H, W] numpy,
        relabeled mask tensor or None)."""
        from slam_maskrcnn_tpu_torch.models.mask_ops import (
            mask_detect, mask_detect_device)

        t0 = time.perf_counter()
        rgb = np.ascontiguousarray(color_bgr[:, :, ::-1])
        if self.use_depth_filter:
            # depth filtering needs per-mask medians -> host dmask path
            mask = mask_detect(self.model, rgb, depth)
        else:
            # device-side label encode: only [H, W] u8 crosses back
            mask = mask_detect_device(self.model, rgb)
        self.timings["detect"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        out = self.fusion.parse_frame(depth, color_bgr, mask, extrinsic,
                                      mean_depth)
        self.timings["fuse"] += time.perf_counter() - t0
        self.frames_done += 1

        if (self.render_every and out is not None
                and self.frames_done % self.render_every == 0):
            t0 = time.perf_counter()
            if self._viewer is None:
                from slam_maskrcnn_tpu_torch.viz.viewer import Viewer

                H, W = self.render_size or depth.shape
                self._viewer = Viewer(W, H, self.fusion.intrinsic,
                                      self.fusion.cfg, self.fusion.backend)
            img = self._viewer.render(self.fusion.state,
                                      0.01 * self.frames_done,
                                      self.fusion.mean_depth)
            self.renders.append(img)
            self.timings["render"] += time.perf_counter() - t0
        return mask, out

    def run_device(self, seq, upload_ahead: int = 2, verbose: bool = True):
        """Device-resident streaming: an upload thread stages frame N+1 on
        the device while the device computes frame N; molding, detect,
        label encode and fuse stay on the device, and nothing blocks on a
        readback until the end. The depth filter is host-side and not part
        of this path (use ``run``).

        Returns steady-state fused frames/sec (after the first 3 frames)."""
        from slam_maskrcnn_tpu_torch.samples.north_star import (
            detect_mask_impl, device_mold_geometry)

        model, fusion = self.model, self.fusion
        dev = model.device
        fusion.miss_check_every = 0  # no mid-stream sync points

        def upload(fr):
            mean_depth = fr.get("mean_depth")
            if mean_depth is None:  # on the host, not from the staged copy
                d = np.asarray(fr["depth"])
                valid = d > 0
                mean_depth = float(
                    (d[valid].astype(np.float64)
                     / fusion.cfg.depth_scale).mean()) if valid.any() else 0.0
            return dict(
                depth=torch.from_numpy(np.asarray(fr["depth"])).to(dev),
                color=torch.from_numpy(np.asarray(fr["color"], np.uint8))
                .to(dev),
                extrinsic=fr["extrinsic"], mean_depth=mean_depth,
                shape=tuple(fr["depth"].shape))

        geom = None
        t_start = t_steady = time.time()
        n_steady = 0
        last_mask = None
        for fr in _Ahead(seq, upload, upload_ahead):
            H, W = fr["shape"]
            if geom is None:
                # the molding geometry is static for a fixed sensor size
                rh, rw, top, left, mh, mw, nwin = device_mold_geometry(
                    model.config, H, W)
                geom = (rh, rw, top, left, mh, mw)
                nwin = torch.from_numpy(nwin).to(dev)
                anchors = model.anchors((mh, mw))
                mean = torch.tensor(np.asarray(model.config.MEAN_PIXEL,
                                               np.float32), device=dev)
            mask = detect_mask_impl(model.module, anchors, nwin, fr["color"],
                                    H, W, geom, mean)
            last_mask = mask
            fusion.parse_frame(fr["depth"], fr["color"], mask,
                               fr["extrinsic"], fr["mean_depth"])
            self.frames_done += 1
            if self.frames_done == 3:  # steady state from here
                float(fusion.state.weight.sum())
                t_steady = time.time()
                n_steady = self.frames_done
        # one readback closes the stream
        float(fusion.state.weight.sum())
        if last_mask is not None:
            int(last_mask.sum())
        wall = time.time() - t_steady
        done = max(self.frames_done - n_steady, 1)
        fps = done / wall
        if verbose:
            print(f"{self.frames_done} frames "
                  f"({done} steady in {wall:.1f}s = {fps:.2f} fused "
                  f"frames/sec device-resident; total "
                  f"{time.time() - t_start:.1f}s)")
        return fps

    def run(self, seq, prefetch: int = 4, verbose: bool = True):
        """Stream a TUMSequence-like object end to end (host path)."""
        t_start = time.time()
        for fr in FramePrefetcher(seq, prefetch):
            self.step(fr["depth"], fr["color"], fr["extrinsic"],
                      fr.get("mean_depth"))
            if verbose:
                st = self.fusion.state
                print(f"frame {self.frames_done}: "
                      f"objs={int(st.num_objs) if st is not None else 0}")
        wall = time.time() - t_start
        fps = max(self.frames_done - 1, 1) / wall
        if verbose:
            print(f"{self.frames_done} frames in {wall:.1f}s = {fps:.2f} "
                  f"fused frames/sec (detect {self.timings['detect']:.1f}s, "
                  f"fuse {self.timings['fuse']:.1f}s)")
        return fps


def main(argv=None):
    import argparse

    from slam_maskrcnn_tpu_torch.data.tum import TUMSequence
    from slam_maskrcnn_tpu_torch.fusion.state import (FusionConfig,
                                                      make_intrinsic)
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.samples.coco import CocoInferenceConfig

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--begin", type=float, default=-np.inf)
    p.add_argument("--end", type=float, default=np.inf)
    p.add_argument("--max-frames", type=int, default=100)
    p.add_argument("--vol-dim", type=int, default=256)
    p.add_argument("--backend", choices=["xla", "pallas"], default="pallas",
                   help="fuse path: the CUDA kernel on a u16 histogram "
                        "(pallas) or the dense torch fuse on a u32 one (xla)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--render-every", type=int, default=0)
    a = p.parse_args(argv)

    model = MaskRCNN("inference", CocoInferenceConfig(), device=a.device)
    if a.weights:
        model.load_weights(a.weights, by_name=True)
    else:
        model.init_params()
    seq = TUMSequence(a.dataset, begin=a.begin, end=a.end,
                      max_frames=a.max_frames)
    K = make_intrinsic(520.9, 521.0, 325.1, 249.7)
    cfg = FusionConfig(vol_dim=(a.vol_dim,) * 3,
                       hist_dtype=np.uint16 if a.backend == "pallas"
                       else np.uint32)
    pipe = LivePipeline(model, K, cfg, a.backend,
                        render_every=a.render_every)
    return pipe.run(seq)


if __name__ == "__main__":
    main()
