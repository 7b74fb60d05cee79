"""Dataset base class + training data pipeline.

Port of slam_maskrcnn_tpu/data/dataset.py (the reference's
``utils.Dataset`` registry, ``Mask_RCNN/mrcnn/utils.py:233-389``, and the
``load_image_gt`` / ``data_generator`` pipeline, ``model.py:1190-1290,
1635-1805``): host-side numpy producing fixed-shape batches for the train
step, per-image errors logged and skipped, up to 5 in a row
(model.py:1797-1805). Its random draws are the JAX package's: the
generator's own ``np.random.default_rng(seed)`` (shuffle, the legacy
fliplr, the gt cap) and numpy's global stream (``build_rpn_targets``'
anchor subsampling, the "crop" resize mode), so the batches of a seed
equal the JAX package's bit for bit.

Where the JAX package calls cv2, the port has its own copies: molding by
models/mask_rcnn.py ``resize_image`` (cv2's INTER_LINEAR, ops/resize.py),
``resize_mask`` with cv2's INTER_NEAREST index rule, ``minimize_mask``
through ops/resize.py, and ``Dataset.load_image`` reads PNG and JPEG
files with data/image_io.py ``imread`` (JPEG pixel stages on the card).
The ``Augmenter`` of
data/augment.py is applied where the JAX package applies it, after
molding, to the image and the masks together.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
from slam_maskrcnn_tpu_torch.models.targets import (DeviceAnchors,
                                                    build_rpn_targets)
from slam_maskrcnn_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)


class Dataset:
    """Image/class registry.

    Same public API as the reference's ``utils.Dataset``
    (``Mask_RCNN/mrcnn/utils.py:233-330`` — subclasses call ``add_class``/
    ``add_image`` then ``prepare()``), but a different implementation: the
    ``(source, id) -> contiguous index`` tables are maintained incrementally
    at registration time, and ``prepare()`` only derives the flat views
    from them in one pass. Class/image records are tuples internally;
    ``image_info`` stays a list of dicts because subclass loaders stash
    arbitrary per-image payloads in it (that dict IS the extension point).
    """

    def __init__(self, class_map=None):
        # internal class index 0 is always background and belongs to the
        # anonymous source "" (so it maps into every source's class list)
        self._classes = [("", 0, "BG")]
        self._class_index = {("", 0): 0}
        self.image_info = []
        self._image_index = {}
        self._image_ids = np.arange(0)
        self.source_class_ids = {}

    def add_class(self, source, class_id, class_name):
        if "." in source:
            raise ValueError(f"source name {source!r} may not contain '.'")
        key = (source, class_id)
        if key not in self._class_index:  # re-registration is a no-op
            self._class_index[key] = len(self._classes)
            self._classes.append((source, class_id, class_name))

    def add_image(self, source, image_id, path, **kwargs):
        self._image_index[(source, image_id)] = len(self.image_info)
        self.image_info.append(
            dict(kwargs, id=image_id, source=source, path=path))

    @property
    def class_info(self):
        """Records as dicts (reference-shaped view of the tuple storage)."""
        return [{"source": s, "id": i, "name": n}
                for s, i, n in self._classes]

    def prepare(self, class_map=None):
        self.num_classes = len(self._classes)
        self.class_ids = np.arange(self.num_classes)
        # display name = text before the first comma of the raw name
        self.class_names = [name.split(",")[0]
                            for _, _, name in self._classes]
        self.num_images = len(self.image_info)
        self._image_ids = np.arange(self.num_images)
        self.class_from_source_map = {
            f"{src}.{cid}": idx
            for (src, cid), idx in self._class_index.items()}
        self.image_from_source_map = {
            f"{src}.{iid}": idx
            for (src, iid), idx in self._image_index.items()}
        # per-source class lists: background (0) first, then the source's
        # own classes in registration order
        per_source = {}
        for idx, (src, _, _) in enumerate(self._classes):
            bucket = per_source.setdefault(src, [0])
            if idx > 0:
                bucket.append(idx)
        self.sources = list(per_source)
        self.source_class_ids = per_source

    def map_source_class_id(self, source_class_id):
        return self.class_from_source_map[source_class_id]

    def get_source_class_id(self, class_id, source):
        src, cid, _ = self._classes[class_id]
        if src != source:
            raise KeyError(
                f"class {class_id} belongs to source {src!r}, not {source!r}")
        return cid

    @property
    def image_ids(self):
        return self._image_ids

    def source_image_link(self, image_id):
        return self.image_info[image_id]["path"]

    def load_image(self, image_id):
        """The image as RGB u8 [H, W, 3] (PNG or JPEG, data/image_io.py)."""
        from slam_maskrcnn_tpu_torch.data.image_io import imread
        path = self.image_info[image_id]["path"]
        img = imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return np.ascontiguousarray(img[:, :, ::-1])

    def load_mask(self, image_id):
        """Override. Returns (masks [H,W,N] bool, class_ids [N])."""
        return (np.empty((0, 0, 0), bool), np.empty((0,), np.int32))

    def image_reference(self, image_id):
        return ""


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST) on a
    [H, W] or [H, W, C] array: destination pixel x reads source
    min(floor(x * (W / w)), W - 1), the inverse scale in double, as
    OpenCV's ``resizeNN``."""
    h2, w2 = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    sy = np.minimum(np.floor(np.arange(h2) * (1.0 / (h2 / H))), H - 1)
    sx = np.minimum(np.floor(np.arange(w2) * (1.0 / (w2 / W))), W - 1)
    return img[sy.astype(np.int64)][:, sx.astype(np.int64)]


def resize_mask(mask, scale, padding, crop=None):
    if scale != 1 and mask.shape[-1] > 0:
        h, w = mask.shape[:2]
        mask = resize_nearest(mask.astype(np.uint8),
                              (round(h * scale), round(w * scale))
                              ).astype(bool)
    if crop is not None:
        y, x, h, w = crop
        return mask[y:y + h, x:x + w]
    return np.pad(mask, list(padding[:2]) + [(0, 0)], mode="constant")


def minimize_mask(bbox, mask, mini_shape):
    """Crop masks to their boxes, resize to mini_shape
    (utils.minimize_mask, utils.py:513-540), each with cv2's u8
    INTER_LINEAR (ops/resize.py)."""
    from slam_maskrcnn_tpu_torch.ops.resize import resize_linear
    mini = np.zeros(tuple(mini_shape) + (mask.shape[-1],), bool)
    for i in range(mask.shape[-1]):
        m = mask[:, :, i].astype(np.uint8)
        y1, x1, y2, x2 = bbox[i][:4].astype(int)
        m = m[y1:y2, x1:x2]
        if m.size == 0:
            continue
        m = resize_linear(torch.from_numpy(np.ascontiguousarray(m)),
                          (mini_shape[0], mini_shape[1])).numpy()
        mini[:, :, i] = m >= 0.5
    return mini


def extract_bboxes(mask):
    """[H,W,N] -> [N,4] (y1,x1,y2,x2) (utils.extract_bboxes, utils.py:32-55)."""
    boxes = np.zeros([mask.shape[-1], 4], np.int32)
    for i in range(mask.shape[-1]):
        m = mask[:, :, i]
        rows = np.any(m, axis=1)
        cols = np.any(m, axis=0)
        if rows.any():
            y1, y2 = np.where(rows)[0][[0, -1]]
            x1, x2 = np.where(cols)[0][[0, -1]]
            boxes[i] = [y1, x1, y2 + 1, x2 + 1]
    return boxes


def load_image_gt(dataset: Dataset, config, image_id, augment=False,
                  augmentation=None, rng=None, use_mini_mask=None):
    """Load + resize one image with gt boxes/masks
    (= model.load_image_gt, model.py:1190-1290).

    `augment`: legacy coin-flip fliplr (deprecated in the reference too,
    model.py:1233-1240). `augmentation`: an Augmenter object
    (data/augment.py — the imgaug-hook equivalent of model.py:1241-1270);
    applied image+mask consistently, masks with nearest interpolation,
    with ``rng`` (a numpy Generator) drawing its parameters."""
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import resize_image

    image = dataset.load_image(image_id)
    mask, class_ids = dataset.load_mask(image_id)
    original_shape = image.shape
    out = resize_image(
        torch.from_numpy(np.ascontiguousarray(image)), config.IMAGE_MIN_DIM,
        config.IMAGE_MAX_DIM, config.IMAGE_MIN_SCALE,
        config.IMAGE_RESIZE_MODE,
        rect_shape=getattr(config, "IMAGE_RECT_SHAPE", None))
    crop = None
    if len(out) == 5:
        image, window, scale, padding, crop = out
    else:
        image, window, scale, padding = out
    image = image.numpy()
    mask = resize_mask(mask, scale, padding, crop)

    if augment and (rng or np.random).random() < 0.5:
        image = np.fliplr(image)
        mask = np.fliplr(mask)
    if augmentation is not None and mask.shape[-1] > 0:
        image, mask = augmentation(image, mask, rng)

    # drop empty masks (from cropping)
    keep = np.where(mask.any(axis=(0, 1)))[0]
    mask = mask[:, :, keep]
    class_ids = np.asarray(class_ids)[keep]
    bbox = extract_bboxes(mask)

    active_class_ids = np.zeros(config.NUM_CLASSES, np.int32)
    source_ids = dataset.source_class_ids.get(
        dataset.image_info[image_id]["source"],
        list(range(config.NUM_CLASSES)))
    active_class_ids[source_ids] = 1

    if use_mini_mask is None:
        use_mini_mask = config.USE_MINI_MASK
    if use_mini_mask:
        mask = minimize_mask(bbox, mask, config.MINI_MASK_SHAPE)
    return image, class_ids, bbox, mask, active_class_ids, window


def pad_to(arr, n, axis=0):
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, max(0, n - arr.shape[axis]))
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(0, n)
    return np.pad(arr, pad)[tuple(sl)]


def data_generator(dataset: Dataset, config, shuffle=True, augment=False,
                   batch_size=None, seed=None, augmentation=None,
                   device=None):
    """Infinite batch generator (= model.data_generator,
    model.py:1635-1805). Yields dicts of fixed-shape numpy arrays:
    images, rpn_match [B,A], rpn_bbox [B,A,4] (anchor-aligned),
    gt_class_ids [B,G], gt_boxes [B,G,4] normalized, gt_masks [B,G,h,w],
    active_class_ids [B,C], windows [B,4] normalized. ``augmentation``:
    an Augmenter (data/augment.py), drawing from the generator's own
    ``np.random.default_rng(seed)``. ``device``: where
    ``build_rpn_targets`` matches anchors to gt (the anchors uploaded
    once; on a card csrc/rpn_targets.cu, one launch an image); None keeps
    the whole batch in numpy. The batches are the same either way."""
    batch_size = batch_size or config.BATCH_SIZE
    rng = np.random.default_rng(seed)
    anchors_norm = get_anchors(config, config.IMAGE_SHAPE)
    H, W = int(config.IMAGE_SHAPE[0]), int(config.IMAGE_SHAPE[1])
    scale = np.array([H - 1, W - 1, H - 1, W - 1], np.float32)
    shift = np.array([0, 0, 1, 1], np.float32)
    anchors_px = anchors_norm * scale + shift
    anchors = (anchors_px if device is None
               else DeviceAnchors(anchors_px, device))
    G = config.MAX_GT_INSTANCES
    ids = np.copy(dataset.image_ids)
    error_count = 0
    b = 0
    batch = None
    i = -1
    while True:
        try:
            i = (i + 1) % len(ids)
            if shuffle and i == 0:
                rng.shuffle(ids)
            image_id = ids[i]
            (image, gt_class_ids, gt_boxes, gt_masks, active_ids,
             window) = load_image_gt(dataset, config, image_id,
                                     augment=augment,
                                     augmentation=augmentation, rng=rng)
            if not np.any(gt_class_ids > 0):
                continue
            with span("rpn_targets"):
                rpn_match, rpn_bbox = build_rpn_targets(
                    anchors, gt_class_ids, gt_boxes.astype(np.float32),
                    config)

            if batch is None:
                A = anchors_px.shape[0]
                mh, mw = gt_masks.shape[:2]
                batch = dict(
                    images=np.zeros((batch_size, H, W, 3), np.float32),
                    rpn_match=np.zeros((batch_size, A), np.int32),
                    rpn_bbox=np.zeros((batch_size, A, 4), np.float32),
                    gt_class_ids=np.zeros((batch_size, G), np.int32),
                    gt_boxes=np.zeros((batch_size, G, 4), np.float32),
                    gt_masks=np.zeros((batch_size, G, mh, mw), np.float32),
                    active_class_ids=np.zeros(
                        (batch_size, config.NUM_CLASSES), np.int32),
                    windows=np.zeros((batch_size, 4), np.float32),
                )
            # cap gt at G, subsample randomly if over (model.py:1703-1707)
            if gt_boxes.shape[0] > G:
                sel = rng.choice(gt_boxes.shape[0], G, replace=False)
                gt_class_ids = gt_class_ids[sel]
                gt_boxes = gt_boxes[sel]
                gt_masks = gt_masks[:, :, sel]
            n = gt_boxes.shape[0]
            # the JAX mold_image: f32 pixels less the f64 mean, stored f32
            batch["images"][b] = image.astype(np.float32) - config.MEAN_PIXEL
            batch["rpn_match"][b] = rpn_match
            batch["rpn_bbox"][b] = rpn_bbox
            batch["gt_class_ids"][b, :n] = gt_class_ids
            batch["gt_class_ids"][b, n:] = 0
            gt_norm = (gt_boxes.astype(np.float32) - shift) / scale
            batch["gt_boxes"][b] = pad_to(gt_norm, G)
            batch["gt_masks"][b] = pad_to(
                np.transpose(gt_masks, (2, 0, 1)).astype(np.float32), G)
            batch["active_class_ids"][b] = active_ids
            batch["windows"][b] = (np.array(window, np.float32) - shift) / scale
            b += 1
            if b >= batch_size:
                yield batch
                b = 0
                batch = None
            error_count = 0
        except (GeneratorExit, KeyboardInterrupt):
            raise
        except Exception:
            log.exception("Error processing image %s",
                          dataset.image_info[ids[i]] if i < len(ids) else i)
            error_count += 1
            if error_count > 5:
                raise
