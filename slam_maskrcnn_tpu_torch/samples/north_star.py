"""The north-star composition, all on the device:

    detect (Mask R-CNN) -> label-encode -> probe -> associate -> relabel
    -> fuse -> in-loop splat render

Port of slam_maskrcnn_tpu/samples/north_star.py: the reference program's
fuse-then-view process (src/SfM_CUDA/kernel.cpp:64-107) with the two
offline stages joined live and the render inside the loop. Per-frame
inputs are depth u16 [H, W], color BGR u8 [H, W, 3], the extrinsic2init
[4, 4] and the orbit camera (angle, dist); outputs are the rendered frame
u8 [H, W, 3] RGB and the global-id mask, on the device, and ``misses``, a
0-d int64 device tensor: budget overflow of the splat (probe, shell or
candidate refresh). The CUDA fuse kernels gather every voxel's pixel and
have no rect to miss.

Forms: ``NorthStar.step`` (one frame), ``run_chunk`` (a frame stack,
detect per frame), ``run_chunk_batched`` (detect hoisted into one model
apply over the stack) and ``run_chunk_paired`` (batched detect, and the
fuse over frame pairs: one pass of the paired kernel per two frames).

Render modes: "instance" (palette of the histogram's argmax), "color"
(the volume's color), "splatonly" (the splat without shading, a
measurement mode) and "none" (everything but the render).

The render's surface: with cfg.shell_refresh_every <= 1 each frame
compacts the surface shell once, before the fuse, and shares it between
the splat probe and the render (``share_shell``; the render then sees one
frame of shell staleness; False recompacts after the fuse). With
shell_refresh_every = N > 1 (probe_mode="depth") a candidate set
(fusion/splat.py select_candidates) is refreshed before frame i when
i % N == 0, from the state as it stands then and at that frame's angle,
decoded once, and re-projected exactly by every frame until the next
refresh; the refresh's overflow lands in that frame's misses. The JAX
package writes this schedule as three scan shapes and once more in its
per-call step; here ``step`` and the chunk forms share one cache, one
frame counter and one miss rule (``NorthStar._due_candidates``), so N
``step`` calls from a reset cache give a chunk's outputs, misses included.
(The JAX per-call step adds the cached overflow to every call until the
next refresh; its scans, and this port throughout, add it once.)
Shading always reads the current color and histogram.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slam_maskrcnn_tpu_torch.fusion.pipeline import (fusion_step,
                                                     fusion_step_pair)
from slam_maskrcnn_tpu_torch.fusion.splat import (_compact_shell, _shade,
                                                  _splat_from_rows,
                                                  decode_candidates,
                                                  pinhole_of_orbit,
                                                  select_candidates,
                                                  splat_from_candidates)
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
from slam_maskrcnn_tpu_torch.models.mask_ops import label_masks_device
from slam_maskrcnn_tpu_torch.utils.profiling import frame, span

RENDER_MODES = ("instance", "color", "splatonly", "none")


def device_mold_geometry(model_config, H: int, W: int):
    """Static molding geometry for a fixed sensor size (``resize_image``'s
    square and rect modes, utils.py:392-497). Returns (rh, rw, top, left,
    mh, mw, nwin [1, 4] f32)."""
    mode = model_config.IMAGE_RESIZE_MODE
    if mode not in ("square", "rect"):
        raise NotImplementedError("device molding implements the square and "
                                  "rect resize modes")
    if mode == "rect":
        mh, mw = (int(s) for s in model_config.IMAGE_RECT_SHAPE)
        scale = min(mh / H, mw / W)
        if model_config.IMAGE_MIN_SCALE:
            scale = max(scale, model_config.IMAGE_MIN_SCALE)
    else:
        mh = mw = int(model_config.IMAGE_MAX_DIM)
        scale = max(1.0, model_config.IMAGE_MIN_DIM / min(H, W))
        if model_config.IMAGE_MIN_SCALE:
            scale = max(scale, model_config.IMAGE_MIN_SCALE)
        if round(max(H, W) * scale) > model_config.IMAGE_MAX_DIM:
            scale = model_config.IMAGE_MAX_DIM / max(H, W)
    rh, rw = round(H * scale), round(W * scale)
    top, left = (mh - rh) // 2, (mw - rw) // 2
    win_px = np.array([top, left, top + rh, left + rw], np.float32)
    den = np.array([mh - 1, mw - 1, mh - 1, mw - 1], np.float32)
    shift = np.array([0, 0, 1, 1], np.float32)
    nwin = ((win_px - shift) / den)[None]
    return rh, rw, top, left, mh, mw, nwin


def resize_bilinear(img: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """= jax.image.resize(img [H, W, C], (rh, rw, C), "bilinear"): half-pixel
    centres, and a widened (antialiasing) triangle when shrinking."""
    H, W = img.shape[:2]
    if (rh, rw) == (H, W):
        return img
    x = img.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False,
                      antialias=rh < H or rw < W)
    return x[0].permute(1, 2, 0)


def _mold(colors_bgr: torch.Tensor, geom, mean_pixel) -> torch.Tensor:
    """Frames [N, H, W, 3] BGR u8 -> molded images [N, mh, mw, 3] f32."""
    with span("mold"):
        rh, rw, top, left, mh, mw = geom
        rgb = colors_bgr.flip(-1).to(torch.float32)
        img = torch.stack([resize_bilinear(f, rh, rw) for f in rgb])
        img = F.pad(img, (0, 0, left, mw - rw - left, top, mh - rh - top))
        return img - mean_pixel


def detect_mask_impl(module, anchors, nwin, color_bgr: torch.Tensor,
                     H: int, W: int, geom, mean_pixel,
                     mark=None) -> torch.Tensor:
    """Device molding + Mask R-CNN + label-encode for one frame (stage 1
    of the reference, mask_process.py:97-105 + dmask.py:47-59). Returns the
    label image u8 [H, W]."""
    with span("detect"):
        out = module(_mold(color_bgr[None], geom, mean_pixel), anchors, nwin)
    if mark is not None:
        mark("detect")
    return label_masks_device(out["detections"][0], out["masks"][0],
                              nwin[0], (H, W), min_area=2000)


def detect_mask_batched_impl(module, anchors, nwin,
                             colors_bgr: torch.Tensor, H: int, W: int, geom,
                             mean_pixel, mark=None) -> torch.Tensor:
    """Batched twin of detect_mask_impl over a frame stack [N, H, W, 3]:
    one model apply at batch N (one NMS launch for the proposals and one
    for the detections of all N frames; ROIAlign stays one launch per
    frame and head). Returns the label images u8 [N, H, W]."""
    N = colors_bgr.shape[0]
    with span("detect"):
        out = module(_mold(colors_bgr, geom, mean_pixel), anchors,
                     nwin.expand(N, 4))
    if mark is not None:
        mark("detect")
    labels = []
    for i in range(N):
        frame(i)
        labels.append(label_masks_device(out["detections"][i],
                                         out["masks"][i], nwin[0], (H, W),
                                         min_area=2000))
    return torch.stack(labels)


def _shell(state, cfg: FusionConfig):
    return _compact_shell(state, cfg.splat_max_blocks, cfg.splat_max_rows,
                          cfg.splat_shell_band)


def _render_view(state, angle, dist, intrinsic, cfg: FusionConfig, H: int,
                 W: int, share_shell: bool, render_mode: str, rows,
                 cands=None, cands_dec=None) -> torch.Tensor:
    """The in-loop render (viewer.cu orbit camera): candidate or shell
    splat and shade at one orbit angle, reading the current state."""
    M, m4 = pinhole_of_orbit(angle, dist, intrinsic)
    if cands is not None:
        _, vid = splat_from_candidates(cands, state, M, m4, H, W, fill=True,
                                       decoded=cands_dec)
    else:
        if not share_shell or rows is None:
            rows = _shell(state, cfg)
        _, vid, _, _ = _splat_from_rows(
            rows, M, m4, H, W, cfg.splat_max_blocks, cfg.splat_max_rows,
            cfg.splat_max_surface, cfg.splat_row_cap, fill=True)
    if render_mode == "splatonly":
        return (vid.view(H, W, 1) % 255).to(torch.uint8).expand(H, W, 3)
    return _shade(vid.view(H, W), state, render_mode)


def _blank(state, H: int, W: int, n: int | None = None) -> torch.Tensor:
    shape = (H, W, 3) if n is None else (n, H, W, 3)
    return torch.zeros(shape, dtype=torch.uint8, device=state.device)


def fuse_render_step(state, mask, depth, color_bgr, e2i, intrinsic, angle,
                     dist, cfg: FusionConfig, H: int, W: int,
                     share_shell: bool = True, render_mode: str = "instance",
                     cands=None, cands_dec=None, mark=None):
    """Fusion side of the north-star frame, detect already done: probe ->
    associate -> relabel -> fuse -> in-loop splat render. ``cands``: a
    carried candidate set (and its decode) for the render; without one the
    surface shell is compacted once here, before the fuse, and shared by
    the splat probe and the render. Returns (state, render [H, W, 3] u8,
    mask_g [H, W], misses)."""
    rows = None
    if cands is None and (render_mode != "none"
                          or cfg.probe_mode == "splat"):
        with span("refresh"):
            rows = _shell(state, cfg)
    state, mask_g, misses = fusion_step(
        state, depth, color_bgr, mask, e2i, intrinsic, cfg, mark,
        rows=rows if cfg.probe_mode == "splat" else None)
    if render_mode == "none":
        return state, _blank(state, H, W), mask_g, misses
    with span("render"):
        render = _render_view(state, angle, dist, intrinsic, cfg, H, W,
                              share_shell, render_mode, rows, cands,
                              cands_dec)
    if mark is not None:
        mark("render")
    return state, render, mask_g, misses


def fuse_render_pair_step(state, m1, d1, c1, e1, a1, m2, d2, c2, e2, a2,
                          intrinsic, dist, cfg: FusionConfig, H: int, W: int,
                          share_shell: bool = True,
                          render_mode: str = "instance", cands=None,
                          cands_dec=None, mark=None):
    """Paired-frame north-star step: both frames' associations, one paired
    fuse pass (fusion/pipeline.py fusion_step_pair), then both frames'
    renders from the post-pair state. Against the sequential step, frame
    2's association probes the pre-pair histogram (one frame stale) and
    frame 1's render sees frame 2's fused data (one frame ahead). Needs a
    warmed state (n_obs >= 1). Returns (state, renders [2, H, W, 3] u8,
    masks_g [2, H, W], misses)."""
    state, (mg1, mg2), misses = fusion_step_pair(
        state, d1, c1, m1, e1, d2, c2, m2, e2, intrinsic, cfg, mark)
    masks_g = torch.stack([mg1, mg2])
    if render_mode == "none":
        return state, _blank(state, H, W, 2), masks_g, misses
    with span("render"):
        renders = torch.stack([
            _render_view(state, a, dist, intrinsic, cfg, H, W, share_shell,
                         render_mode, None, cands, cands_dec)
            for a in (a1, a2)])
    if mark is not None:
        mark("render")
    return state, renders, masks_g, misses


class NorthStar:
    """Runner of the north-star composition for a model
    (models.mask_rcnn.MaskRCNN) on its device: ``step`` per frame, and the
    chunk forms over a pre-staged frame stack."""

    def __init__(self, model, intrinsic, cfg: FusionConfig, H: int, W: int,
                 share_shell: bool = True, render_mode: str = "instance"):
        if render_mode not in RENDER_MODES:
            raise ValueError(f"render_mode {render_mode!r}: one of "
                             f"{RENDER_MODES}")
        self.refresh = max(1, int(cfg.shell_refresh_every))
        if self.refresh > 1 and cfg.probe_mode != "depth":
            raise ValueError("shell_refresh_every > 1 would stale the splat "
                             "probe; use probe_mode='depth'")
        self.model, self.cfg, self.H, self.W = model, cfg, H, W
        self.share_shell, self.render_mode = share_shell, render_mode
        dev = model.device
        g = device_mold_geometry(model.config, H, W)
        self.geom = tuple(g[:6])
        self.nwin = torch.from_numpy(g[6]).to(dev)
        mh, mw = self.geom[4], self.geom[5]
        self.anchors = torch.from_numpy(
            get_anchors(model.config, (mh, mw, 3))).to(dev)
        self.intrinsic = np.asarray(intrinsic, np.float32)
        self.mean_pixel = torch.as_tensor(
            np.asarray(model.config.MEAN_PIXEL, np.float32), device=dev)
        self.reset_candidates()

    # ---- detect
    def detect(self, color_bgr: torch.Tensor, mark=None) -> torch.Tensor:
        """Label image u8 [H, W] of one frame."""
        return detect_mask_impl(self.model.module, self.anchors, self.nwin,
                                color_bgr, self.H, self.W, self.geom,
                                self.mean_pixel, mark)

    def detect_batched(self, colors_bgr: torch.Tensor,
                       mark=None) -> torch.Tensor:
        """Label images u8 [N, H, W] of a frame stack, one model apply."""
        return detect_mask_batched_impl(
            self.model.module, self.anchors, self.nwin, colors_bgr, self.H,
            self.W, self.geom, self.mean_pixel, mark)

    # ---- candidates
    def _candidates(self, state, angle, dist, mark=None):
        """(codes, decode, overflow) of a fresh candidate set at an orbit
        angle. The overflow is hard loss (shell block or row budget) and
        goes into the refresh frame's misses; the row cap's clip count is
        dropped here, as the probes drop theirs."""
        with span("refresh"):
            M, m4 = pinhole_of_orbit(angle, dist, self.intrinsic)
            codes, ovf, _clip = select_candidates(
                _shell(state, self.cfg), M, m4, self.cfg.splat_row_cap)
            dec = decode_candidates(codes, state)
        if mark is not None:
            mark("refresh")
        return codes, dec, ovf

    def reset_candidates(self) -> None:
        """Drop the candidate cache and restart the refresh schedule (e.g.
        after swapping to an unrelated volume). The chunk forms do so at
        their start."""
        self._cands = self._cands_dec = None
        self._step_i = 0

    def _due_candidates(self, state, angle, dist, n_frames: int, mark=None):
        """The refresh schedule of ``step`` and of every chunk form: before
        frame i (counted from the last reset) the candidate set is
        refreshed when i % refresh == 0, or when none is cached; then the
        counter advances by the ``n_frames`` this set is about to render
        (2 for a pair). Returns (codes, decode, overflow): all None with
        shell_refresh_every <= 1, overflow None when nothing was
        refreshed."""
        if self.refresh <= 1:
            return None, None, None
        ovf = None
        if self._cands is None or self._step_i % self.refresh == 0:
            self._cands, self._cands_dec, ovf = self._candidates(
                state, angle, dist, mark)
        self._step_i += n_frames
        return self._cands, self._cands_dec, ovf

    # ---- per frame
    def _frame(self, state, mask, depth, color_bgr, e2i, angle, dist, mark):
        """One frame after its detect: the candidates that are due, then
        fuse_render_step. A refresh's overflow joins this frame's misses."""
        cands, dec, ovf = self._due_candidates(state, angle, dist, 1, mark)
        state, render, mask_g, miss = fuse_render_step(
            state, mask, depth, color_bgr, e2i, self.intrinsic, angle, dist,
            self.cfg, self.H, self.W, self.share_shell, self.render_mode,
            cands=cands, cands_dec=dec, mark=mark)
        return state, render, mask_g, miss if ovf is None else miss + ovf

    @torch.no_grad()
    def step(self, state, depth: torch.Tensor, color_bgr: torch.Tensor,
             e2i, angle, dist, mark=None):
        """One live frame. depth/color tensors on the model's device, e2i a
        [4, 4] float32 array, (angle, dist) the render's orbit camera.
        ``mark(stage)``, if given, is called after each stage ("detect",
        "label", "refresh", "associate", "fuse", "render"), e.g. to record
        CUDA events. With cfg.shell_refresh_every = N > 1 the render's
        candidate set is cached on the runner and refreshed every N calls;
        the refresh's overflow is in that call's misses.
        Returns (state, render [H, W, 3] u8, mask_g [H, W] u8, misses)."""
        with span("step"):
            mask = self.detect(color_bgr, mark)
            if mark is not None:
                mark("label")
            return self._frame(state, mask, depth, color_bgr, e2i, angle,
                               dist, mark)

    # ---- chunks
    def _run(self, state, depths, colors, es, angles, dist, masks, pair,
             mark):
        """The loop behind the chunk forms: restart the refresh schedule,
        then walk the stack one frame (or one pair) at a time. ``masks``:
        precomputed label images, or None to detect inside the loop (then
        each frame is a ``step``)."""
        N = depths.shape[0]
        angles = np.asarray(angles, np.float32)
        renders, masks_g, misses = [], [], []
        self.reset_candidates()
        for i in range(0, N, 2 if pair else 1):
            frame(i)
            if pair:
                cands, dec, ovf = self._due_candidates(state, angles[i],
                                                       dist, 2, mark)
                state, r, mg, miss = fuse_render_pair_step(
                    state, masks[i], depths[i], colors[i], es[i], angles[i],
                    masks[i + 1], depths[i + 1], colors[i + 1], es[i + 1],
                    angles[i + 1], self.intrinsic, dist, self.cfg, self.H,
                    self.W, self.share_shell, self.render_mode, cands, dec,
                    mark)
                if ovf is not None:
                    miss = miss + ovf
                renders += [r[0], r[1]]
                masks_g += [mg[0], mg[1]]
            else:
                if masks is None:
                    state, r, mg, miss = self.step(
                        state, depths[i], colors[i], es[i], angles[i], dist,
                        mark)
                else:
                    state, r, mg, miss = self._frame(
                        state, masks[i], depths[i], colors[i], es[i],
                        angles[i], dist, mark)
                renders.append(r)
                masks_g.append(mg)
            misses.append(miss)
        return (state, torch.stack(renders), torch.stack(masks_g),
                torch.stack(misses))

    @torch.no_grad()
    def run_chunk(self, state, depths, colors, es, angles, dist, mark=None):
        """A whole pre-staged frame stack ([N, ...] tensors on the device,
        es [N, 4, 4] and angles [N] on the host), detect inside the loop:
        the same outputs as N ``step`` calls. Returns (state, renders
        [N, H, W, 3] u8, masks_g [N, H, W], misses [N])."""
        with span("chunk"):
            return self._run(state, depths, colors, es, angles, dist, None,
                             False, mark)

    @torch.no_grad()
    def run_chunk_batched(self, state, depths, colors, es, angles, dist,
                          mark=None):
        """run_chunk with detect hoisted out of the loop as one batched
        model apply over the N frames (detect does not depend on the
        fusion state). Batch-N convolutions may round differently from
        batch-1, which can flip a few mask border pixels. Adds N frames of
        latency: a live loop holds frames until the chunk fills."""
        with span("chunk"):
            masks = self.detect_batched(colors, mark)
            if mark is not None:
                mark("label")
            return self._run(state, depths, colors, es, angles, dist, masks,
                             False, mark)

    @torch.no_grad()
    def run_chunk_paired(self, state, depths, colors, es, angles, dist,
                         mark=None):
        """run_chunk_batched with the fuse over frame pairs
        (fuse_render_pair_step): one pass of the paired kernel fuses two
        frames. N must be even and the state warmed (n_obs >= 1: fuse one
        frame with ``step`` first). Against run_chunk_batched, pair-second
        associations probe a one-frame-stale histogram and pair-first
        renders see one frame ahead. Candidates refresh before pair i when
        (2 i) % refresh == 0. Returns misses [N // 2]."""
        if depths.shape[0] % 2:
            raise ValueError("paired chunk needs an even frame count")
        if state.n_obs < 1:
            raise ValueError("paired chunk needs a warmed state (n_obs >= 1)")
        with span("chunk"):
            masks = self.detect_batched(colors, mark)
            if mark is not None:
                mark("label")
            return self._run(state, depths, colors, es, angles, dist, masks,
                             True, mark)
