"""Mask post-processing: detections -> label-encoded instance image.

Port of slam_maskrcnn_tpu/models/mask_ops.py (``Mask_RCNN/dmask.py``, the
stage-1 / stage-2 contract: a mask PNG whose pixel value is the instance
id, 0 = background, ``dmask.py:47-59``):

* the host dmask functions ``depth_filter``, ``preserve_small_objs``,
  ``filter_tiny_objects`` and ``mask_detect`` stay numpy, copied as they
  are: ``np.argsort`` over mask areas is not stable, and only the same
  numpy call breaks ties the same way;
* ``label_masks_device`` is the same label image computed on the device,
  and ``mask_detect_device`` runs detect -> label there;
* ``batch_mask_process`` is the ``mask_process.py`` batch driver: it
  reads PNG or JPEG frames with data/image_io.py (``cv2.imread``'s
  semantics) and writes the label PNGs with data/png.py.
"""

from __future__ import annotations

import contextlib
import glob
import os

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.data.image_io import IMREAD_ANYDEPTH, imread
from slam_maskrcnn_tpu_torch.data.png import write_png
from slam_maskrcnn_tpu_torch.utils.profiling import span, sync, to_host


def depth_filter(depth_image: np.ndarray, masks: np.ndarray,
                 n_std: float = 5.0) -> np.ndarray:
    """Zero mask pixels whose depth deviates more than n_std sigma from the
    mask's median depth (``dmask.py:3-19``)."""
    new_masks = masks.copy()
    for i in range(masks.shape[2]):
        sel = masks[:, :, i]
        if not sel.any():
            continue
        median = np.median(depth_image[sel])
        std = np.std(depth_image[sel])
        bad = (depth_image < median - n_std * std) | \
              (depth_image > median + n_std * std)
        new_masks[:, :, i][bad] = False
    return new_masks


def preserve_small_objs(masks: np.ndarray) -> np.ndarray:
    """Resolve overlaps in favor of smaller masks (``dmask.py:21-32``):
    area-ascending pairwise subtraction."""
    areas = np.array([np.count_nonzero(masks[:, :, i])
                      for i in range(masks.shape[-1])])
    order = np.argsort(areas)
    for a in range(len(order)):
        for b in range(a + 1, len(order)):
            inter = masks[:, :, order[a]] & masks[:, :, order[b]]
            if inter.any():
                masks[:, :, order[b]][inter] = False
    return masks


def filter_tiny_objects(masks: np.ndarray, min_area: int = 2000) -> np.ndarray:
    """Drop masks with area <= min_area px (``dmask.py:34-45``; note the
    reference keeps area > 2000 strictly)."""
    keep = [i for i in range(masks.shape[-1])
            if np.count_nonzero(masks[:, :, i]) > min_area]
    return masks[:, :, keep]


def mask_detect(model, rgb_image: np.ndarray,
                depth_image: np.ndarray | None = None,
                noise_remove: bool = True) -> np.ndarray:
    """detect -> filter -> label-encode (``dmask.py:47-59``). Returns
    uint8 [H, W] with instance i's pixels = i+1."""
    result = model.detect([rgb_image], verbose=0)[0]
    with span("label"):
        masks = result["masks"].astype(bool)
        if depth_image is not None:
            masks = depth_filter(depth_image, masks)
        if noise_remove:
            masks = filter_tiny_objects(masks)
        masks = preserve_small_objs(masks)
        cls = np.zeros(rgb_image.shape[:2], np.uint8)
        for i in range(masks.shape[2]):
            cls[masks[:, :, i]] = i + 1
        return cls


def label_masks_device(detections: torch.Tensor, masks_u8: torch.Tensor,
                       window_norm: torch.Tensor, out_shape,
                       min_area: int = 2000) -> torch.Tensor:
    """detections [D, 6] molded-normalized (y1, x1, y2, x2, class, score);
    masks_u8 [D, 28, 28] uint8; window_norm [4] normalized window of the
    molded image; out_shape (oh, ow). Returns uint8 [oh, ow].

    Each 28x28 mask pastes into its unmolded pixel box with cv2
    INTER_LINEAR's half-pixel hat weights (separable: Wy @ m @ Wx^T),
    thresholds at 0.5, drops masks of area <= min_area, and overlaps go to
    the smaller mask (ties to the earlier detection). Labels are kept-list
    positions + 1."""
    with span("label"):
        return _label_masks(detections, masks_u8, window_norm, out_shape,
                            min_area)


def _label_masks(detections, masks_u8, window_norm, out_shape, min_area):
    D, S = masks_u8.shape[0], masks_u8.shape[1]
    oh, ow = int(out_shape[0]), int(out_shape[1])
    dev = detections.device
    wy1, wx1, wy2, wx2 = (window_norm[0], window_norm[1], window_norm[2],
                          window_norm[3])
    with sync("label.const"):
        shift = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    wscale = torch.stack([wy2 - wy1, wx2 - wx1, wy2 - wy1, wx2 - wx1])
    woff = torch.stack([wy1, wx1, wy1, wx1])
    boxes = (detections[:, :4] - woff) / wscale
    with sync("label.const"):
        oscale = torch.tensor([oh - 1, ow - 1, oh - 1, ow - 1],
                              dtype=torch.float32, device=dev)
    bpx = torch.round(boxes * oscale + shift).to(torch.int32)
    y1, x1, y2, x2 = bpx[:, 0], bpx[:, 1], bpx[:, 2], bpx[:, 3]
    valid = (detections[:, 4] > 0) & (y2 > y1) & (x2 > x1)

    def axis_weights(lo, hi, n_out):
        """[D, n_out, S] hat weights at integer output coords lo..hi-1."""
        coords = torch.arange(n_out, dtype=torch.float32, device=dev)[None]
        size = (hi - lo).float().clamp_min(1.0)[:, None]
        src = (coords - lo[:, None].float() + 0.5) * (S / size) - 0.5
        src = src.clamp(0.0, S - 1.0)
        sidx = torch.arange(S, dtype=torch.float32, device=dev)
        w = (1.0 - (src[..., None] - sidx).abs()).clamp_min(0.0)
        inside = (coords >= lo[:, None]) & (coords < hi[:, None])
        return w * inside[..., None]

    wy = axis_weights(y1, y2, oh)                       # [D, oh, S]
    wx = axis_weights(x1, x2, ow)                       # [D, ow, S]
    m = masks_u8.float() / 255.0
    full = torch.bmm(torch.bmm(wy, m), wx.transpose(1, 2))  # [D, oh, ow]
    cover = (full >= 0.5) & valid[:, None, None]

    area = cover.sum(dim=(1, 2))
    kept = valid & (area > min_area)
    label_of = torch.cumsum(kept.to(torch.int32), 0)    # kept-list pos + 1
    big = 2 ** 30
    d_i = torch.arange(D, dtype=torch.int64, device=dev)
    key = torch.where(cover & kept[:, None, None],
                      area[:, None, None] * 512 + d_i[:, None, None],
                      torch.full_like(cover, big, dtype=torch.int64))
    kmin, win = key.min(dim=0)
    return torch.where(kmin < big, label_of[win],
                       torch.zeros_like(label_of[win])).to(torch.uint8)


def mask_detect_device(model, rgb_image, min_area: int = 2000) -> np.ndarray:
    """``mask_detect``'s streaming variant: molding, detect and the label
    encode run on the model's device; only the [H, W] u8 label image comes
    back (no depth filter: it needs per-mask medians)."""
    out, molded, windows = model.run_graph([rgb_image])
    nwin = torch.from_numpy(model.norm_windows(windows, molded.shape[1:]))
    label = label_masks_device(out["detections"][0], out["masks"][0],
                               nwin[0].to(model.device),
                               np.asarray(rgb_image).shape[:2],
                               min_area=min_area)
    return to_host("label", label).numpy()


def batch_mask_process(model, rgb_dir: str, mask_dir: str,
                       depth_dir: str | None = None,
                       verbose: bool = True, timer=None) -> int:
    """The ``mask_process.py`` batch driver (``mask_process.py:94-105``):
    sorted rgb/*.png (or, without any, rgb/*.jpg) read with ``imread`` on
    the model's device, the depth of the same name with
    ``IMREAD_ANYDEPTH``, -> mask_detect -> mask/<same stem>.png (u8
    labels). A ``utils.profiling.StageTimer`` as ``timer`` times the
    stages "read", "detect" and "write" of every frame. Returns the
    number of masks written."""
    os.makedirs(mask_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(rgb_dir, "*.png"))) or \
        sorted(glob.glob(os.path.join(rgb_dir, "*.jpg")))
    stage = timer if timer is not None else (
        lambda name: contextlib.nullcontext())
    with span("mask_process"):
        for k, f in enumerate(files):
            with stage("read"), span("read"):
                bgr = imread(f, device=model.device)
                if bgr is None:
                    raise FileNotFoundError(f)
                rgb = np.ascontiguousarray(bgr[:, :, ::-1])  # BGR -> RGB
                depth = None
                if depth_dir is not None:
                    dfile = os.path.join(depth_dir, os.path.basename(f))
                    if os.path.exists(dfile):
                        depth = imread(dfile, IMREAD_ANYDEPTH)
            with stage("detect"), span("mask_detect"):
                cls = mask_detect(model, rgb, depth)
            out = os.path.join(mask_dir, os.path.splitext(
                os.path.basename(f))[0] + ".png")
            with stage("write"), span("write"):
                write_png(out, cls)
            if verbose:
                print(f"[{k + 1}/{len(files)}] {out} ({cls.max()} instances)")
    return len(files)
