"""Training-time augmentation: an imgaug-style composable augmenter API.

Port of slam_maskrcnn_tpu/data/augment.py (the reference accepts ``imgaug``
augmenters and applies them to image and mask with a safety filter, only
shape-preserving geometric augmenters touching the masks,
``Mask_RCNN/mrcnn/model.py:1224-1270``). Each augmenter samples its random
parameters once per image, from the numpy ``Generator`` it is given, in
the JAX package's order, so a seed gives the same parameters in both
packages; a geometric one applies the same transform to the image
(bilinear) and the mask (nearest, order 0 as ``model.py:1258`` uses),
while a photometric one leaves the mask untouched. Shapes are asserted
unchanged, as the reference does (``model.py:1263-1265``).

Where the JAX package calls OpenCV, the port has its own copies, each
equal to OpenCV 5 bit for bit: ``getRotationMatrix2D`` and ``warpAffine``
(ops/warp.py), the u8 ``GaussianBlur`` (ops/blur.py), ``resize`` with
``INTER_LINEAR`` (ops/resize.py) and ``INTER_NEAREST``
(data/dataset.py ``resize_nearest``). It runs on the host, like
data/dataset.py.

    aug = Sequential([Fliplr(0.5),
                      Sometimes(0.5, Affine(rotate=(-10, 10)))])
    data_generator(dataset, config, augmentation=aug)
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.ops import warp
from slam_maskrcnn_tpu_torch.ops.blur import gaussian_blur


class Augmenter:
    """Base: sample parameters once, then apply to image and mask."""

    geometric = False  # geometric augmenters transform masks too

    def sample(self, rng: np.random.Generator):
        return None

    def apply_image(self, image, params):
        return image

    def apply_mask(self, mask, params):
        if self.geometric:
            raise NotImplementedError
        return mask

    def __call__(self, image, mask, rng=None):
        """Augment (image [H,W,3] u8, mask [H,W,N] bool) consistently."""
        rng = rng or np.random.default_rng()
        params = self.sample(rng)
        shape_i, shape_m = image.shape, mask.shape
        image = self.apply_image(image, params)
        if self.geometric:
            mask = self.apply_mask(mask, params)
        assert image.shape == shape_i, "augmentation must not change shape"
        assert mask.shape == shape_m, "augmentation must not change shape"
        return image, mask.astype(bool)


def _rand(rng, spec, default):
    """imgaug-style parameter spec: scalar = fixed, (lo, hi) = uniform."""
    if spec is None:
        return default
    if isinstance(spec, (tuple, list)):
        return float(rng.uniform(spec[0], spec[1]))
    return float(spec)


class Fliplr(Augmenter):
    geometric = True

    def __init__(self, p=0.5):
        self.p = p

    def sample(self, rng):
        return rng.random() < self.p

    def apply_image(self, image, flip):
        return np.fliplr(image) if flip else image

    apply_mask = apply_image


class Flipud(Augmenter):
    geometric = True

    def __init__(self, p=0.5):
        self.p = p

    def sample(self, rng):
        return rng.random() < self.p

    def apply_image(self, image, flip):
        return np.flipud(image) if flip else image

    apply_mask = apply_image


class Affine(Augmenter):
    """Rotation/scale/translation/shear about the image center.
    Specs are imgaug-style: scalar or (lo, hi) uniform range."""

    geometric = True

    def __init__(self, rotate=None, scale=None, translate_percent=None,
                 shear=None):
        self.rotate = rotate
        self.scale = scale
        self.translate_percent = translate_percent
        self.shear = shear

    def sample(self, rng):
        return dict(rot=_rand(rng, self.rotate, 0.0),
                    scale=_rand(rng, self.scale, 1.0),
                    tx=_rand(rng, self.translate_percent, 0.0),
                    ty=_rand(rng, self.translate_percent, 0.0),
                    shear=_rand(rng, self.shear, 0.0))

    def _matrix(self, shape, p):
        h, w = shape[:2]
        M = warp.rotation_matrix((w / 2.0, h / 2.0), p["rot"], p["scale"])
        sh = np.tan(np.deg2rad(p["shear"]))
        S = np.array([[1.0, sh, -sh * h / 2.0], [0.0, 1.0, 0.0]])
        # compose shear after rotate/scale (2x3 affine composition)
        M3 = np.vstack([M, [0, 0, 1]])
        S3 = np.vstack([S, [0, 0, 1]])
        out = (S3 @ M3)[:2]
        out[0, 2] += p["tx"] * w
        out[1, 2] += p["ty"] * h
        return out

    def apply_image(self, image, p):
        M = self._matrix(image.shape, p)
        return warp.warp_affine(image, M, (image.shape[1], image.shape[0]),
                                warp.INTER_LINEAR)

    def apply_mask(self, mask, p):
        M = self._matrix(mask.shape, p)
        out = warp.warp_affine(mask.astype(np.uint8), M,
                               (mask.shape[1], mask.shape[0]),
                               warp.INTER_NEAREST)  # order 0, model.py:1258
        return out[..., None] if out.ndim == 2 else out


class CropAndPad(Augmenter):
    """Symmetric crop (negative) / zero-pad (positive) by a fraction,
    resized back to the original shape."""

    geometric = True

    def __init__(self, percent=(-0.1, 0.1)):
        self.percent = percent

    def sample(self, rng):
        return _rand(rng, self.percent, 0.0)

    def _do(self, arr, frac, order):
        from slam_maskrcnn_tpu_torch.data.dataset import resize_nearest
        from slam_maskrcnn_tpu_torch.ops.resize import resize_linear

        h, w = arr.shape[:2]
        dy, dx = int(round(h * frac)), int(round(w * frac))
        if dy == 0 and dx == 0:
            return arr
        if frac < 0:  # crop inward
            arr2 = arr[-dy:h + dy or None, -dx:w + dx or None]
        else:         # pad outward
            pad = [(dy, dy), (dx, dx)] + [(0, 0)] * (arr.ndim - 2)
            arr2 = np.pad(arr, pad)
        if order == 0:
            out = resize_nearest(arr2.astype(np.uint8), (h, w))
        else:
            out = resize_linear(torch.from_numpy(np.ascontiguousarray(arr2)),
                                (h, w)).numpy()
        return out.astype(arr.dtype)

    def apply_image(self, image, frac):
        return self._do(image, frac, order=1)

    def apply_mask(self, mask, frac):
        return self._do(mask.astype(np.uint8), frac, order=0)


class Multiply(Augmenter):
    """Photometric brightness multiply — mask untouched."""

    def __init__(self, mul=(0.8, 1.2)):
        self.mul = mul

    def sample(self, rng):
        return _rand(rng, self.mul, 1.0)

    def apply_image(self, image, m):
        return np.clip(image.astype(np.float32) * m, 0,
                       255).astype(image.dtype)


class AdditiveGaussianNoise(Augmenter):
    def __init__(self, scale=(0.0, 8.0)):
        self.scale = scale

    def sample(self, rng):
        return (_rand(rng, self.scale, 0.0), rng.integers(0, 2 ** 31))

    def apply_image(self, image, p):
        s, seed = p
        noise = np.random.default_rng(seed).normal(
            0.0, s, image.shape).astype(np.float32)
        return np.clip(image.astype(np.float32) + noise, 0,
                       255).astype(image.dtype)


class GaussianBlur(Augmenter):
    def __init__(self, sigma=(0.0, 2.0)):
        self.sigma = sigma

    def sample(self, rng):
        return _rand(rng, self.sigma, 0.0)

    def apply_image(self, image, s):
        if s <= 0:
            return image
        k = max(3, int(2 * round(3 * s) + 1))
        return gaussian_blur(image, k, s)


class Sequential(Augmenter):
    """Apply every child in order (each with its own sampled params)."""

    def __init__(self, children):
        self.children = list(children)
        self.geometric = any(c.geometric for c in self.children)

    def __call__(self, image, mask, rng=None):
        rng = rng or np.random.default_rng()
        for c in self.children:
            image, mask = c(image, mask, rng)
        return image, mask


class Sometimes(Augmenter):
    """Apply the child with probability p (imgaug.Sometimes)."""

    def __init__(self, p, child):
        self.p = p
        self.child = child
        self.geometric = child.geometric

    def __call__(self, image, mask, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() < self.p:
            return self.child(image, mask, rng)
        return image, mask


class OneOf(Augmenter):
    """Apply exactly one randomly-chosen child (imgaug.OneOf)."""

    def __init__(self, children):
        self.children = list(children)
        self.geometric = any(c.geometric for c in self.children)

    def __call__(self, image, mask, rng=None):
        rng = rng or np.random.default_rng()
        return self.children[rng.integers(len(self.children))](image, mask,
                                                               rng)


class SomeOf(Augmenter):
    """Apply n randomly-chosen children, in order (imgaug.SomeOf)."""

    def __init__(self, n, children):
        self.n = n
        self.children = list(children)
        self.geometric = any(c.geometric for c in self.children)

    def __call__(self, image, mask, rng=None):
        rng = rng or np.random.default_rng()
        sel = rng.choice(len(self.children), size=min(self.n,
                                                      len(self.children)),
                         replace=False)
        for i in sorted(sel):
            image, mask = self.children[i](image, mask, rng)
        return image, mask
