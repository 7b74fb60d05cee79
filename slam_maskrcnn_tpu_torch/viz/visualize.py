"""Detection visualization.

Port of slam_maskrcnn_tpu/viz/visualize.py (``Mask_RCNN/mrcnn/
visualize.py``): every function of the JAX module under its name, the
composites pixel for pixel the same. Where the JAX module calls cv2, the
port draws with data/draw.py (``cv2.rectangle`` at thickness 1 and 2,
``cv2.line``), viz/font.py (``cv2.putText`` of the captions, OpenCV 5's
TrueType rendering) and writes with data/image_io.py ``imwrite``. The
matplotlib functions import matplotlib lazily, as the JAX module does;
where it is not installed they raise ``ImportError``.
"""

from __future__ import annotations

import colorsys
import random

import numpy as np

from slam_maskrcnn_tpu_torch.data import draw
from slam_maskrcnn_tpu_torch.viz.font import FONT_HERSHEY_SIMPLEX, put_text


def random_colors(N, bright=True, seed=None):
    """HSV-spaced colors (visualize.py:60-70)."""
    brightness = 1.0 if bright else 0.7
    hsv = [(i / max(N, 1), 1, brightness) for i in range(N)]
    colors = list(map(lambda c: colorsys.hsv_to_rgb(*c), hsv))
    rng = random.Random(seed)
    rng.shuffle(colors)
    return colors


def apply_mask(image, mask, color, alpha=0.5):
    """Blend a boolean mask into an image (visualize.py:73-81)."""
    image = image.copy()
    for c in range(3):
        image[:, :, c] = np.where(
            mask == 1,
            image[:, :, c] * (1 - alpha) + alpha * color[c] * 255,
            image[:, :, c])
    return image


def _bgr_write(path, rgb, device) -> None:
    from slam_maskrcnn_tpu_torch.data.image_io import imwrite

    imwrite(path, np.ascontiguousarray(rgb[:, :, ::-1]), device=device)


def draw_boxes(image, boxes, color=(1.0, 1.0, 0.0)):
    """Draw (y1, x1, y2, x2) rectangles (1px)."""
    out = image.copy()
    c = tuple(int(v * 255) for v in color)
    for y1, x1, y2, x2 in boxes.astype(int):
        draw.rectangle(out, (x1, y1), (x2, y2), c, 1)
    return out


def display_instances(image, boxes, masks, class_ids, class_names,
                      scores=None, title="", figsize=(16, 16), ax=None,
                      show_mask=True, show_bbox=True, colors=None,
                      captions=None, show=True, save_path=None,
                      device="cuda"):
    """= visualize.display_instances (visualize.py:84-170). With show=False
    returns the composited uint8 image (no matplotlib window needed).
    ``device`` is where a JPEG ``save_path`` is encoded."""
    N = boxes.shape[0]
    if N and boxes.shape[0] != masks.shape[-1]:
        raise ValueError("boxes and masks disagree")
    colors = colors or random_colors(N)
    masked = image.astype(np.float32).copy()
    if show_mask:
        for i in range(N):
            masked = apply_mask(masked, masks[:, :, i], colors[i])
    masked = masked.astype(np.uint8)
    if show_bbox and N:
        for i in range(N):
            y1, x1, y2, x2 = boxes[i].astype(int)
            c = tuple(int(v * 255) for v in colors[i])
            draw.rectangle(masked, (x1, y1), (x2, y2), c, 2)
            if captions is None:
                cid = class_ids[i]
                label = class_names[cid] if cid < len(class_names) else str(cid)
                score = scores[i] if scores is not None else None
                caption = f"{label} {score:.3f}" if score is not None else label
            else:
                caption = captions[i]
            put_text(masked, caption, (x1, max(y1 - 4, 10)),
                     FONT_HERSHEY_SIMPLEX, 0.4, c, 1)
    if save_path:
        _bgr_write(save_path, masked, device)
    if show:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(1, figsize=figsize)
        ax.imshow(masked)
        ax.set_title(title)
        ax.axis("off")
    return masked


def display_differences(image, gt_box, gt_class_id, gt_mask,
                        pred_box, pred_class_id, pred_score, pred_mask,
                        class_names, title="", ax=None, show_mask=True,
                        show_box=True, iou_threshold=0.5,
                        score_threshold=0.5, show=False, save_path=None):
    """GT and predictions on one image (= visualize.display_differences,
    visualize.py:303-352): GT green, predictions red with the red channel
    scaled by match IoU; captions carry score / IoU."""
    from slam_maskrcnn_tpu_torch.eval.metrics import compute_matches

    gt_match, pred_match, overlaps = compute_matches(
        gt_box, gt_class_id, gt_mask, pred_box, pred_class_id, pred_score,
        pred_mask, iou_threshold=iou_threshold,
        score_threshold=score_threshold)
    colors = ([(0.0, 1.0, 0.0, 0.8)] * len(gt_match)
              + [(1.0, 0.0, 0.0, 1.0)] * len(pred_match))
    class_ids = np.concatenate([gt_class_id, pred_class_id]).astype(int)
    scores = np.concatenate([np.zeros([len(gt_match)]), pred_score])
    boxes = np.concatenate([gt_box, pred_box])
    masks = np.concatenate([gt_mask, pred_mask], axis=-1)
    captions = (["" for _ in range(len(gt_match))] + [
        "{:.2f} / {:.2f}".format(
            pred_score[i],
            overlaps[i, int(pred_match[i])]
            if pred_match[i] > -1 else overlaps[i].max()
            if overlaps.shape[1] > 0 else 0.0)
        for i in range(len(pred_match))])
    return display_instances(
        image, boxes, masks, class_ids, class_names, scores, ax=ax,
        show_bbox=show_box, show_mask=show_mask,
        colors=[c[:3] for c in colors], captions=captions,
        title=title or "Ground Truth and Detections\n GT=green, pred=red",
        show=show, save_path=save_path)


def draw_rois(image, rois, refined_rois, mask, class_ids, class_names,
              limit=10, seed=0, show=False, save_path=None):
    """A random sample of proposals (dotted-gray analog: 1px gray) with
    their refined boxes (solid color) and class captions
    (= visualize.draw_rois, visualize.py:260-300). Returns the composite."""
    ids = np.arange(rois.shape[0], dtype=np.int32)
    if rois.shape[0] > limit:
        ids = np.random.RandomState(seed).choice(ids, limit, replace=False)
    out = image.copy().astype(np.uint8)
    colors = random_colors(len(ids))
    for n, i in enumerate(ids):
        y1, x1, y2, x2 = rois[i].astype(int)
        draw.rectangle(out, (x1, y1), (x2, y2), (160, 160, 160), 1)
        if class_ids[i] > 0:
            ry1, rx1, ry2, rx2 = refined_rois[i].astype(int)
            c = tuple(int(v * 255) for v in colors[n])
            draw.rectangle(out, (rx1, ry1), (rx2, ry2), c, 2)
            draw.line(out, (x1, y1), (rx1, ry1), c, 1)  # connect as the ref
            cid = int(class_ids[i])
            label = class_names[cid] if cid < len(class_names) else str(cid)
            put_text(out, label, (rx1, max(ry1 - 4, 10)),
                     FONT_HERSHEY_SIMPLEX, 0.4, c, 1)
            m = mask[:, :, i] if mask is not None and i < mask.shape[-1] \
                else None
            if m is not None:
                out = apply_mask(out.astype(np.float32), m,
                                 colors[n]).astype(np.uint8)
    if save_path:
        _bgr_write(save_path, out, "cuda")
    return out


def display_images(images, titles=None, cols=4, cmap=None, save_path=None):
    """Grid of images (visualize.py:40-57)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    titles = titles or [""] * len(images)
    rows = len(images) // cols + (len(images) % cols > 0)
    fig = plt.figure(figsize=(14, 14 * rows // max(cols, 1)))
    for i, (image, title) in enumerate(zip(images, titles)):
        ax = fig.add_subplot(rows, cols, i + 1)
        ax.set_title(title, fontsize=9)
        ax.axis("off")
        ax.imshow(image, cmap=cmap)
    if save_path:
        fig.savefig(save_path)
    return fig


def draw_box(image, box, color):
    """2px box outline drawn in-place on a numpy image
    (visualize.py:207-219)."""
    y1, x1, y2, x2 = box.astype(int) if hasattr(box, "astype") else box
    image[y1:y1 + 2, x1:x2] = color
    image[y2:y2 + 2, x1:x2] = color
    image[y1:y2, x1:x1 + 2] = color
    image[y1:y2, x2:x2 + 2] = color
    return image


def display_top_masks(image, mask, class_ids, class_names, limit=4,
                      save_path=None):
    """Most-frequent classes' union masks (visualize.py:222-246)."""
    to_display = [image]
    titles = ["H x W={}x{}".format(image.shape[0], image.shape[1])]
    unique_ids, counts = np.unique(class_ids, return_counts=True)
    order = np.argsort(counts)[::-1]
    top_ids = [unique_ids[o] for o in order if unique_ids[o] > 0][:limit]
    for cid in top_ids + [-1] * (limit - len(top_ids)):
        if cid == -1:
            to_display.append(np.zeros_like(image[:, :, 0]))
            titles.append("-")
            continue
        sel = np.where(class_ids == cid)[0]
        # instance-coded union
        coded = np.zeros(image.shape[:2])
        for k, i in enumerate(sel):
            coded[mask[:, :, i] > 0] = k + 1
        to_display.append(coded)
        titles.append(class_names[cid] if cid < len(class_names) else cid)
    return display_images(to_display, titles=titles, cols=limit + 1,
                          cmap="Blues_r", save_path=save_path)


def plot_precision_recall(AP, precisions, recalls, save_path=None):
    """PR curve (visualize.py:249-262)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1)
    ax.set_title("Precision-Recall. AP@50 = {:.3f}".format(AP))
    ax.set_ylim(0, 1.1)
    ax.set_xlim(0, 1.1)
    ax.plot(recalls, precisions)
    if save_path:
        fig.savefig(save_path)
    return fig


def plot_overlaps(gt_class_ids, pred_class_ids, pred_scores, overlaps,
                  class_names, threshold=0.5, save_path=None):
    """Detection-vs-GT IoU grid (visualize.py:265-301)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 10))
    plt.imshow(overlaps, interpolation="nearest", cmap=plt.cm.Blues)
    plt.yticks(np.arange(len(pred_class_ids)),
               ["{} ({:.2f})".format(
                   class_names[int(i)] if int(i) < len(class_names) else i,
                   pred_scores[k])
                for k, i in enumerate(pred_class_ids)])
    plt.xticks(np.arange(len(gt_class_ids)),
               [class_names[int(i)] if int(i) < len(class_names) else i
                for i in gt_class_ids], rotation=90)
    for i in range(overlaps.shape[0]):
        for j in range(overlaps.shape[1]):
            text = ""
            if overlaps[i, j] > threshold:
                text = "match" if gt_class_ids[j] == pred_class_ids[i] \
                    else "wrong"
            plt.text(j, i, "{}\n{:.3f}".format(text, overlaps[i, j]),
                     ha="center", va="center", fontsize=9)
    plt.xlabel("Ground Truth")
    plt.ylabel("Predictions")
    if save_path:
        fig.savefig(save_path)
    return fig


def display_activations(activations, channels=8, cols=8, cmap="viridis",
                        save_path=None):
    """Channel grid of an intermediate activation [H, W, C] (the
    inspect_model notebook's ``display_images(... activations)`` cells;
    pair with models/inspect.run_graph to fetch them)."""
    act = np.asarray(activations)
    if act.ndim == 4:
        act = act[0]
    C = act.shape[-1]
    imgs = [act[:, :, i] for i in range(min(channels, C))]
    titles = [f"ch {i}" for i in range(len(imgs))]
    return display_images(imgs, titles=titles, cols=cols, cmap=cmap,
                          save_path=save_path)


def display_weight_stats(model):
    """Weight table rows (the reference's display_weight_stats,
    visualize.py:455-479) via models.inspect.weight_stats, in the Flax
    names and layout."""
    from slam_maskrcnn_tpu_torch.models.inspect import weight_stats

    return weight_stats(model)
