"""Mask R-CNN: the inference and training graphs and the user-facing API.

Port of slam_maskrcnn_tpu/models/mask_rcnn.py (``MaskRCNN``,
``Mask_RCNN/mrcnn/model.py:1812-2672``). Inference (``forward``):
backbone -> FPN -> RPN -> proposals -> ROIAlign -> heads -> detections ->
ROIAlign -> mask head -> class-plane select -> uint8 quantisation, with
static shapes. Training (``train_forward``, the training branch of
``MaskRCNN.build``, model.py:1957-2008): backbone -> RPN -> proposals
(the NMS kernel on CUDA, on detached inputs) -> detection-target sampling
(models/targets.py) -> the training ROIAlign (ops/roi_align.py
``pyramid_roi_align_train``, differentiable) -> heads on the flattened
rois. Images are NHWC float32 (molded), as in the JAX package.

Around the graph, as the JAX package's host code: ``resize_image`` and
``mold_inputs`` (molding, with ops/resize.py in place of cv2, on the
model's device), ``MaskRCNN.load_weights`` (Keras .h5 through
models/h5.py), ``detect`` and ``unmold_detections`` (boxes to pixels,
each 28x28 mask pasted into its box and thresholded).

COMPUTE_DTYPE "float32" means float32 on the card too: cuDNN would run an
f32 convolution in TF32 by default (``torch.backends.cudnn.allow_tf32``),
so ``MaskRCNNModule.forward`` turns TF32 off for convolutions and matmuls
while an f32 module runs (``_exact_f32``) and restores the flags after.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
from slam_maskrcnn_tpu_torch.models.backbone import FPN, Conv, ResNet
from slam_maskrcnn_tpu_torch.models.config import Config
from slam_maskrcnn_tpu_torch.models.detection import detection_layer
from slam_maskrcnn_tpu_torch.models.heads import (ConvTranspose, Dense,
                                                  FPNClassifier, MaskHead)
from slam_maskrcnn_tpu_torch.models.proposal import generate_proposals
from slam_maskrcnn_tpu_torch.models.rpn import RPNHead
from slam_maskrcnn_tpu_torch.models.trunk_graph import TrunkGraph
from slam_maskrcnn_tpu_torch.ops.resize import resize_linear
from slam_maskrcnn_tpu_torch.ops.roi_align import (pyramid_roi_align,
                                                   pyramid_roi_align_train)
from slam_maskrcnn_tpu_torch.utils.profiling import span, sync, to_host


@contextlib.contextmanager
def _exact_f32(enabled: bool):
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block
    (when ``enabled``), the caller's flags restored after."""
    if not enabled:
        yield
        return
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


class MaskRCNNModule(nn.Module):
    """The graph. ``forward`` (inference) returns detections [B, D, 6] and
    class-selected masks [B, D, 28, 28] uint8, plus the proposals and RPN
    outputs; ``train_forward`` the head outputs and sampled targets the
    losses take. BatchNorm uses batch statistics only while the module is
    in train mode (TRAIN_BN). At batch 1 on the card, in eval mode with
    grad off, ``forward`` replays the trunk (backbone, FPN, RPN head) as
    one CUDA graph (models/trunk_graph.py), bit-equal to the eager trunk."""

    def __init__(self, num_classes: int, backbone: str = "resnet101",
                 image_shape=(1024, 1024), pool_size: int = 7,
                 mask_pool_size: int = 14, fc_size: int = 1024,
                 top_down: int = 256, anchors_per_location: int = 3,
                 anchor_stride: int = 1, proposal_count: int = 1000,
                 rpn_nms_threshold: float = 0.7, pre_nms_limit: int = 6000,
                 detection_max_instances: int = 100,
                 detection_min_confidence: float = 0.7,
                 detection_nms_threshold: float = 0.3,
                 rpn_bbox_std=(0.1, 0.1, 0.2, 0.2),
                 bbox_std=(0.1, 0.1, 0.2, 0.2), dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.image_shape = tuple(image_shape)
        self.pool_size, self.mask_pool_size = pool_size, mask_pool_size
        self.proposal_count = proposal_count
        self.rpn_nms_threshold = rpn_nms_threshold
        self.pre_nms_limit = pre_nms_limit
        self.detection_max_instances = detection_max_instances
        self.detection_min_confidence = detection_min_confidence
        self.detection_nms_threshold = detection_nms_threshold
        self.rpn_bbox_std, self.bbox_std = rpn_bbox_std, bbox_std
        self.dtype = dtype
        self.resnet = ResNet(backbone, dtype)
        self.fpn = FPN(top_down, dtype)
        self.rpn_model = RPNHead(anchors_per_location, anchor_stride,
                                 top_down, dtype)
        self.fpn_classifier = FPNClassifier(num_classes, pool_size, fc_size,
                                            top_down, dtype)
        self.fpn_mask = MaskHead(num_classes, top_down, dtype)
        # the batch-1 trunk's CUDA graphs (models/trunk_graph.py)
        self._trunk_graph = TrunkGraph()

    def features(self, images):
        """images [B, H, W, 3] -> (P2..P6), NCHW in channels-last memory."""
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.fpn(*self.resnet(x))

    def rpn_outputs(self, pyramid):
        outs = [self.rpn_model(p) for p in pyramid]
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def _trunk(self, images):
        """images -> (P2, P3, P4, P5, P6, rpn_probs, rpn_bbox): the span
        of the inference graph that ``TrunkGraph`` captures."""
        pyramid = self.features(images)
        _, rpn_probs, rpn_bbox = self.rpn_outputs(pyramid)
        return pyramid + (rpn_probs, rpn_bbox)

    def _graphable(self, images) -> bool:
        """Whether ``_forward`` replays the trunk's CUDA graph: the images
        on a device a graph can be captured on, a batch of 1, eval mode,
        grad off (models/trunk_graph.py says why)."""
        return (images.device.type in self._trunk_graph.DEVICES
                and images.shape[0] == 1 and not self.training
                and not torch.is_grad_enabled())

    def _roi_align(self, feats, boxes, pool):
        """PyramidROIAlign of the whole batch (one kernel launch) on NHWC
        views of the NCHW levels, which are contiguous: the levels live in
        channels-last memory. Returns f32 [B, N, pool, pool, C]."""
        return pyramid_roi_align(tuple(f.permute(0, 2, 3, 1) for f in feats),
                                 boxes, pool, self.image_shape)

    @torch.no_grad()
    def forward(self, images, anchors, windows):
        """images [B, H, W, 3] molded f32; anchors [A, 4] normalized;
        windows [B, 4] normalized."""
        with _exact_f32(self.dtype == torch.float32):
            return self._forward(images, anchors, windows)

    def train_forward(self, images, anchors, gt_class_ids, gt_boxes,
                      gt_masks, pos_noise, neg_noise, train_rois: int = 200,
                      positive_ratio: float = 0.33):
        """The training forward (the JAX ``train_forward``,
        mask_rcnn.py:140-197). images [B, H, W, 3] molded f32; anchors
        [A, 4]; gt as data/dataset.py's batch; pos_noise / neg_noise
        [B, proposal_count] uniform draws of the target sampling
        (models/targets.py ``draw_target_noise``). Returns (outputs,
        targets) dicts for models/losses.py ``total_loss``."""
        from slam_maskrcnn_tpu_torch.models.targets import detection_targets

        B = images.shape[0]
        with span("backbone"):
            pyramid = self.features(images)
        feats = pyramid[:4]
        with span("rpn"):
            rpn_logits, rpn_probs, rpn_bbox = self.rpn_outputs(pyramid)
        # NMS selects: no gradient flows through the proposals (the JAX
        # graph's stop_gradient)
        with span("proposals"):
            proposals, _ = generate_proposals(
                rpn_probs.detach(), rpn_bbox.detach(), anchors,
                self.proposal_count, self.rpn_nms_threshold,
                self.pre_nms_limit, self.rpn_bbox_std)
        with span("targets"):
            rois, tgt_cls, tgt_bbox, tgt_mask, roi_valid = \
                detection_targets(
                    proposals, gt_class_ids, gt_boxes, gt_masks, pos_noise,
                    neg_noise, train_rois=train_rois,
                    positive_ratio=positive_ratio,
                    mask_size=self.mask_pool_size * 2,
                    bbox_std=self.bbox_std)
        rois = rois.detach()
        # ROIAlign per image; the heads on the flattened [B * T] rois, as
        # the reference's TimeDistributed heads see the whole batch
        with span("roi_align"):
            nhwc = tuple(f.permute(0, 2, 3, 1) for f in feats)
            pooled = pyramid_roi_align_train(nhwc, rois, self.pool_size,
                                             self.image_shape)
            mpooled = pyramid_roi_align_train(nhwc, rois,
                                              self.mask_pool_size,
                                              self.image_shape)
        T = rois.shape[1]
        with span("heads"):
            logits, probs, bbox = self.fpn_classifier(pooled.flatten(0, 1))
        with span("mask_head"):
            masks = self.fpn_mask(mpooled.flatten(0, 1))
        outputs = dict(
            rpn_class_logits=rpn_logits, rpn_probs=rpn_probs,
            rpn_bbox=rpn_bbox,
            mrcnn_class_logits=logits.reshape(B, T, -1),
            mrcnn_probs=probs.reshape(B, T, -1),
            mrcnn_bbox=bbox.reshape((B, T) + bbox.shape[1:]),
            mrcnn_masks=masks.reshape((B, T) + masks.shape[1:]))
        targets = dict(target_class_ids=tgt_cls, target_bbox=tgt_bbox,
                       target_mask=tgt_mask, roi_valid=roi_valid, rois=rois)
        return outputs, targets

    def _forward(self, images, anchors, windows):
        with span("backbone"):
            trunk = (self._trunk_graph.replay(self, images)
                     if self._graphable(images) else None)
            pyramid = self.features(images) if trunk is None else trunk[:5]
        with span("rpn"):
            if trunk is None:
                _, rpn_probs, rpn_bbox = self.rpn_outputs(pyramid)
            else:
                # copies: these leave the call, and the next replay
                # overwrites the graph's outputs
                rpn_probs, rpn_bbox = trunk[5].clone(), trunk[6].clone()
        feats = pyramid[:4]
        with span("proposals"):
            proposals, _ = generate_proposals(
                rpn_probs, rpn_bbox, anchors, self.proposal_count,
                self.rpn_nms_threshold, self.pre_nms_limit,
                self.rpn_bbox_std)
        B, N = proposals.shape[:2]
        with span("heads"):
            pooled = self._roi_align(feats, proposals, self.pool_size)
            _, probs, bbox = self.fpn_classifier(pooled.flatten(0, 1))
            detections, det_valid = detection_layer(
                proposals, probs.reshape(B, N, -1),
                bbox.reshape(B, N, -1, 4), windows,
                max_instances=self.detection_max_instances,
                min_confidence=self.detection_min_confidence,
                nms_threshold=self.detection_nms_threshold,
                bbox_std=self.bbox_std)
        D = detections.shape[1]
        with span("mask_head"):
            mpooled = self._roi_align(feats, detections[..., :4],
                                      self.mask_pool_size)
            masks = self.fpn_mask(mpooled.flatten(0, 1))  # [B*D, 28, 28, C]
            cls = detections[..., 4].long().reshape(B * D, 1, 1, 1)
            masks = torch.gather(masks, 3,
                                 cls.expand(-1, *masks.shape[1:3], 1))
            masks = torch.round(masks[..., 0] * 255.0).to(torch.uint8)
        return dict(detections=detections, detection_valid=det_valid,
                    masks=masks.reshape(B, D, *masks.shape[1:]),
                    proposals=proposals, rpn_probs=rpn_probs,
                    rpn_bbox=rpn_bbox)


def _init_(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded LeCun-normal weights (fan-in scaled, as Flax's default
    initialiser), zero biases, identity BatchNorm."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            fan_in = math.prod(m.weight.shape[1:])
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
        elif isinstance(m, ConvTranspose):
            fan_in = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
    # BatchNorm keeps its construction: the identity (scale 1, bias 0,
    # mean 0, var 1)


# ---------------------------------------------------------------------------
# Molding and unmolding (reference utils.resize_image, model.py:2332-2434)
# ---------------------------------------------------------------------------

def _pad(image: torch.Tensor, padding) -> torch.Tensor:
    (t, b), (l, r), _ = padding
    out = image.new_zeros((image.shape[0] + t + b, image.shape[1] + l + r)
                          + tuple(image.shape[2:]))
    out[t:t + image.shape[0], l:l + image.shape[1]] = image
    return out


def resize_image(image, min_dim=None, max_dim=None, min_scale=None,
                 mode="square", rect_shape=None):
    """= ``utils.resize_image`` (utils.py:392-497) in the square, pad64,
    rect, crop and none modes, with cv2's INTER_LINEAR arithmetic
    (ops/resize.py). image u8 [H, W, 3], a tensor (any device) or numpy.
    Returns (image tensor, window (y1, x1, y2, x2), scale, padding), and in
    "crop" mode (training only: a random min_dim square drawn from numpy's
    global stream, as the JAX package) the crop (y, x, h, w) as a fifth
    element."""
    image = torch.as_tensor(image)
    h, w = image.shape[:2]
    window = (0, 0, h, w)
    scale = 1.0
    if mode == "none":
        return image, window, scale, [(0, 0), (0, 0), (0, 0)]
    if mode == "rect":
        mh, mw = rect_shape
        scale = min(mh / h, mw / w)
        if min_scale and scale < min_scale:
            scale = min_scale
        image = resize_linear(image, (round(h * scale), round(w * scale)))
        h2, w2 = image.shape[:2]
        top, left = (mh - h2) // 2, (mw - w2) // 2
        padding = [(top, mh - h2 - top), (left, mw - w2 - left), (0, 0)]
        return (_pad(image, padding), (top, left, h2 + top, w2 + left),
                scale, padding)
    if min_dim:
        scale = max(1.0, min_dim / min(h, w))
    if min_scale and scale < min_scale:
        scale = min_scale
    if max_dim and mode == "square":
        image_max = max(h, w)
        if round(image_max * scale) > max_dim:
            scale = max_dim / image_max
    if scale != 1:
        image = resize_linear(image, (round(h * scale), round(w * scale)))
    h2, w2 = image.shape[:2]
    if mode == "square":
        top, left = (max_dim - h2) // 2, (max_dim - w2) // 2
        padding = [(top, max_dim - h2 - top), (left, max_dim - w2 - left),
                   (0, 0)]
        window = (top, left, h2 + top, w2 + left)
    elif mode == "pad64":
        padding = [(0, (64 - h2 % 64) % 64), (0, (64 - w2 % 64) % 64),
                   (0, 0)]
        window = (0, 0, h2, w2)
    elif mode == "crop":
        # random min_dim crop (training only), utils.py:475-487
        y = np.random.randint(0, (h2 - min_dim) + 1) if h2 > min_dim else 0
        x = np.random.randint(0, (w2 - min_dim) + 1) if w2 > min_dim else 0
        image = image[y:y + min_dim, x:x + min_dim]
        return (image, (0, 0, min_dim, min_dim), scale,
                [(0, 0), (0, 0), (0, 0)], (y, x, min_dim, min_dim))
    else:
        raise ValueError(f"mode {mode} not supported")
    return _pad(image, padding), window, scale, padding


def mold_image(image: torch.Tensor, config) -> torch.Tensor:
    """Subtract the mean pixel (``model.py:2706-2713``): f32 out."""
    with sync("mold.mean"):
        mean = torch.as_tensor(np.asarray(config.MEAN_PIXEL, np.float32),
                               device=image.device)
    return image.to(torch.float32) - mean


def unmold_mask(mask28: torch.Tensor, bbox, image_shape) -> torch.Tensor:
    """Paste one 28x28 mask into the full image (``utils.unmold_mask``,
    utils.py:565-581): resized to its box in float32 with cv2's bilinear
    arithmetic, thresholded at 127.5 for the device's u8 masks (0.5 for
    float ones). Returns bool [H, W] on the mask's device."""
    y1, x1, y2, x2 = (int(v) for v in bbox)
    full = torch.zeros(tuple(image_shape[:2]), dtype=torch.bool,
                       device=mask28.device)
    if y2 <= y1 or x2 <= x1:
        return full
    m = resize_linear(mask28.to(torch.float32), (y2 - y1, x2 - x1))
    full[y1:y2, x1:x2] = m >= (127.5 if mask28.dtype == torch.uint8
                               else 0.5)
    return full


class MaskRCNN:
    """User-facing wrapper: config -> module on ``device`` (default CUDA).
    ``init_params(seed)`` fills seeded random weights, ``load_weights``
    reads a Keras .h5 or a checkpoint of train/checkpoint.py,
    models/weights.py ``load_jax_params`` carries the JAX package's
    variables. ``detect`` takes RGB images (numpy u8) and returns the
    reference's dicts (rois, class_ids, scores, masks) as numpy. Mode
    "training" sizes the proposal layer for training
    (POST_NMS_ROIS_TRAINING) and ``train`` runs train/trainer.py."""

    def __init__(self, mode: str, config: Config, model_dir: str = "./logs",
                 device="cuda"):
        if mode not in ("training", "inference"):
            raise ValueError(f"mode {mode!r}: 'training' or 'inference'")
        self.mode = mode
        self.config = config
        self.model_dir = model_dir
        self.device = resolve_device(device)
        shape = tuple(int(s) for s in config.IMAGE_SHAPE[:2])
        self.module = MaskRCNNModule(
            num_classes=config.NUM_CLASSES,
            backbone=config.BACKBONE,
            image_shape=shape,
            pool_size=config.POOL_SIZE,
            mask_pool_size=config.MASK_POOL_SIZE,
            fc_size=config.FPN_CLASSIF_FC_LAYERS_SIZE,
            top_down=config.TOP_DOWN_PYRAMID_SIZE,
            anchors_per_location=len(config.RPN_ANCHOR_RATIOS),
            anchor_stride=config.RPN_ANCHOR_STRIDE,
            proposal_count=(config.POST_NMS_ROIS_TRAINING
                            if mode == "training"
                            else config.POST_NMS_ROIS_INFERENCE),
            rpn_nms_threshold=config.RPN_NMS_THRESHOLD,
            pre_nms_limit=config.PRE_NMS_LIMIT,
            detection_max_instances=config.DETECTION_MAX_INSTANCES,
            detection_min_confidence=config.DETECTION_MIN_CONFIDENCE or 0.0,
            detection_nms_threshold=config.DETECTION_NMS_THRESHOLD,
            rpn_bbox_std=tuple(float(v) for v in config.RPN_BBOX_STD_DEV),
            bbox_std=tuple(float(v) for v in config.BBOX_STD_DEV),
            dtype=(torch.bfloat16 if config.COMPUTE_DTYPE == "bfloat16"
                   else torch.float32),
        ).eval()
        self._anchors = {}
        # weights written (init_params, load_weights, load_jax_params)
        self.initialized = False

    def init_params(self, seed: int = 0):
        """Seeded random weights (drawn on the CPU, so every device gets the
        same values), then moved to the device."""
        gen = torch.Generator().manual_seed(seed)
        _init_(self.module, gen)
        self.module.to(self.device)
        self.initialized = True
        return self.module

    def load_weights(self, filepath: str, by_name: bool = True,
                     exclude: list[str] | None = None,
                     strict: bool | None = None):
        """Load a Keras weights .h5 by layer name (models/h5.py), or a
        checkpoint written by train/checkpoint.py (any other name).

        strict (.h5): default True for full-model loads (no exclude): every
        model parameter must be written and every file layer consumed, so
        a real checkpoint can never half-load silently. Excluded or partial
        loads default to non-strict, over seeded random weights."""
        if not str(filepath).endswith(".h5"):
            from slam_maskrcnn_tpu_torch.train.checkpoint import \
                restore_params
            restore_params(filepath, self)
            return self
        from slam_maskrcnn_tpu_torch.models.h5 import load_h5_weights
        if strict is None:
            strict = not exclude
        if not strict:
            self.init_params()
        load_h5_weights(filepath, self, exclude=exclude, strict=strict)
        return self

    def train(self, train_dataset, val_dataset=None, learning_rate=None,
              epochs=1, layers="all", augment=False, **kw):
        """Delegate to train/trainer.py ``Trainer`` (the reference's
        model.train, model.py:2244-2330)."""
        from slam_maskrcnn_tpu_torch.train.trainer import Trainer

        if not hasattr(self, "_trainer"):
            self._trainer = Trainer(self, self.config)
        return self._trainer.train(train_dataset, val_dataset,
                                   learning_rate, epochs, layers, augment,
                                   **kw)

    def find_last(self) -> str:
        """Newest checkpoint of the newest run in model_dir
        (model.py:2054-2077)."""
        from slam_maskrcnn_tpu_torch.train.checkpoint import find_last
        return find_last(self.model_dir, self.config.NAME or "model")

    # -- inference ----------------------------------------------------------

    def mold_inputs(self, images):
        """= model.py:2332-2369, on the model's device. Returns (resized u8
        [B, H, W, 3] tensor, windows [B, 4] numpy); the mean pixel is
        subtracted in ``detect``."""
        cfg = self.config
        molded, windows = [], []
        for img in images:
            with sync("mold.upload"):
                img = torch.as_tensor(np.asarray(img)).to(self.device)
            m, window, _, _ = resize_image(
                img,
                cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM, cfg.IMAGE_MIN_SCALE,
                cfg.IMAGE_RESIZE_MODE,
                rect_shape=getattr(cfg, "IMAGE_RECT_SHAPE", None))
            molded.append(m.to(torch.uint8))
            windows.append(window)
        return torch.stack(molded), np.stack(windows)

    def anchors(self, molded_shape) -> torch.Tensor:
        """Normalized anchors of a molded shape, on the device (cached)."""
        key = tuple(int(s) for s in molded_shape[:2])
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                get_anchors(self.config, key)).to(self.device)
        return self._anchors[key]

    @staticmethod
    def norm_windows(windows: np.ndarray, molded_shape) -> np.ndarray:
        H, W = molded_shape[:2]
        scale = np.array([H - 1, W - 1, H - 1, W - 1], np.float32)
        shift = np.array([0, 0, 1, 1], np.float32)
        return (windows.astype(np.float32) - shift) / scale

    def run_graph(self, images):
        """Mold ``images`` and run the graph once for all of them. Returns
        (graph outputs, molded [B, H, W, 3] u8, windows [B, 4])."""
        with span("mold"):
            molded, windows = self.mold_inputs(images)
            shape = tuple(molded.shape[1:])
            x = mold_image(molded, self.config)
            anchors = self.anchors(shape)
            with sync("mold.windows"):
                nwin = torch.from_numpy(self.norm_windows(windows, shape)) \
                    .to(self.device)
        out = self.module(x, anchors, nwin)
        return out, molded, windows

    def detect(self, images, verbose: int = 0):
        """Detection on a list of RGB images (``model.py:2436-2492``), one
        graph run for all. Returns one dict per image: rois [N, 4] pixel
        (y1, x1, y2, x2) i32, class_ids [N], scores [N], masks [H, W, N]
        bool, as numpy."""
        with span("detect"):
            out, molded, windows = self.run_graph(images)
            detections = to_host("detections", out["detections"]).numpy()
        with span("label"):
            return [self.unmold_detections(detections[i], out["masks"][i],
                                           np.asarray(img).shape,
                                           tuple(molded.shape[1:]),
                                           windows[i])
                    for i, img in enumerate(images)]

    def unmold_detections(self, detections, mrcnn_mask, original_shape,
                          molded_shape, window):
        """= model.py:2371-2434. detections [D, 6] numpy (molded,
        normalized); mrcnn_mask [D, 28, 28] u8 (a tensor on any device, or
        numpy), already class-selected."""
        zero_ix = np.where(detections[:, 4] == 0)[0]
        N = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]

        boxes = detections[:N, :4]
        class_ids = detections[:N, 4].astype(np.int32)
        scores = detections[:N, 5]

        # window in normalized coords of the molded image
        H, W = molded_shape[:2]
        scale = np.array([H - 1, W - 1, H - 1, W - 1], np.float32)
        shift = np.array([0, 0, 1, 1], np.float32)
        wy1, wx1, wy2, wx2 = (np.array(window, np.float32) - shift) / scale
        wh, ww = wy2 - wy1, wx2 - wx1
        boxes = (boxes - np.array([wy1, wx1, wy1, wx1])) / np.array(
            [wh, ww, wh, ww])
        # to original-image pixel coords (np.around: half to even)
        oh, ow = original_shape[:2]
        oscale = np.array([oh - 1, ow - 1, oh - 1, ow - 1], np.float32)
        boxes = np.around(boxes * oscale + shift).astype(np.int32)

        # drop zero-area boxes (model.py:2409-2416)
        keep = np.where((boxes[:, 2] > boxes[:, 0])
                        & (boxes[:, 3] > boxes[:, 1]))[0]
        boxes, class_ids, scores = boxes[keep], class_ids[keep], scores[keep]
        masks = torch.as_tensor(mrcnn_mask)[:N]
        with sync("unmold.keep"):
            keep_t = torch.from_numpy(keep).to(masks.device)
        masks = masks[keep_t]
        if len(keep):
            full = torch.stack([unmold_mask(masks[i], boxes[i],
                                            original_shape)
                                for i in range(len(keep))], -1)
            full = to_host("unmold.masks", full).numpy()
        else:
            full = np.empty(tuple(original_shape[:2]) + (0,), bool)
        return dict(rois=boxes, class_ids=class_ids, scores=scores,
                    masks=full)
