"""Mask post-processing on the device: detections -> label-encoded image.

Port of ``label_masks_device`` from slam_maskrcnn_tpu/models/mask_ops.py
(``Mask_RCNN/dmask.py:47-59`` contract: pixel value = instance id, 0 =
background).
"""

from __future__ import annotations

import torch


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
    D, S = masks_u8.shape[0], masks_u8.shape[1]
    oh, ow = int(out_shape[0]), int(out_shape[1])
    dev = detections.device
    wy1, wx1, wy2, wx2 = (window_norm[0], window_norm[1], window_norm[2],
                          window_norm[3])
    shift = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    wscale = torch.stack([wy2 - wy1, wx2 - wx1, wy2 - wy1, wx2 - wx1])
    woff = torch.stack([wy1, wx1, wy1, wx1])
    boxes = (detections[:, :4] - woff) / wscale
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
