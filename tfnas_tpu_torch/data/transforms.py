"""Host image transforms (the port's own copy of
tfnas_tpu/data/transforms.py), reproducing the reference's torchvision
pipelines:

train: RandomResizedCrop(224) + RandomHorizontalFlip +
       ColorJitter(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.2) +
       Normalize(IMAGENET_MEAN, IMAGENET_STD)
val:   Resize(256) + CenterCrop(224) + Normalize

PIL for decode and resize, numpy for the photometric ops; HWC float32, or
uint8 pixels for normalisation on the card (`device_normalizer`). The
random draws (`sample_rrc_box`, `sample_jitter`) are shared with the C++
pipeline so both paths draw the same parameters from the same generator.
"""

from __future__ import annotations

import math

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def sample_rrc_box(w, h, rng, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """Sample a RandomResizedCrop box (x, y, cw, ch) with torchvision
    semantics (10 tries then aspect-clamped center fallback). Shared by the
    PIL path and the native C++ path so distributions are identical."""
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return x0, y0, cw, ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def sample_jitter(rng, brightness=0.4, contrast=0.4, saturation=0.4,
                  hue=0.2):
    """Sample ColorJitter order + factors. Returns (order, factors) where
    order is a permuted list of op ids (0=brightness 1=contrast 2=saturation
    3=hue) and factors is indexed by op id."""
    factors = [1.0, 1.0, 1.0, 0.0]
    ops = []
    if brightness > 0:
        factors[0] = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(0)
    if contrast > 0:
        factors[1] = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(1)
    if saturation > 0:
        factors[2] = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(2)
    if hue > 0:
        factors[3] = rng.uniform(-hue, hue)
        ops.append(3)
    order = [ops[j] for j in rng.permutation(len(ops))]
    return order, factors


def random_resized_crop(img, rng, size=224, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)):
    """torchvision.RandomResizedCrop semantics (PIL path)."""
    from PIL import Image
    w, h = img.size
    x0, y0, cw, ch = sample_rrc_box(w, h, rng, scale, ratio)
    return img.crop((x0, y0, x0 + cw, y0 + ch)).resize((size, size),
                                                       Image.BILINEAR)


def resize_center_crop(img, resize=256, crop=224):
    from PIL import Image
    w, h = img.size
    if w < h:
        nw, nh = resize, int(round(h * resize / w))
    else:
        nw, nh = int(round(w * resize / h)), resize
    img = img.resize((nw, nh), Image.BILINEAR)
    x0, y0 = (nw - crop) // 2, (nh - crop) // 2
    return img.crop((x0, y0, x0 + crop, y0 + crop))


def _rgb_to_gray(x):
    # itu-r 601-2 luma, matching PIL convert('L') used by torchvision
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])


def adjust_brightness(x, factor):
    return x * factor


def adjust_contrast(x, factor):
    mean = _rgb_to_gray(x).mean()
    return (x - mean) * factor + mean


def adjust_saturation(x, factor):
    gray = _rgb_to_gray(x)[..., None]
    return (x - gray) * factor + gray


def adjust_hue(x, factor):
    """Shift hue by `factor` (in turns, [-0.5, 0.5]) via HSV round-trip."""
    maxc = x.max(-1)
    minc = x.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(maxc == r, ((g - b) / dz) % 6.0,
                 np.where(maxc == g, (b - r) / dz + 2.0, (r - g) / dz + 4.0))
    h = np.where(delta == 0, 0.0, h) / 6.0
    h = (h + factor) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


_JITTER_FNS = [adjust_brightness, adjust_contrast, adjust_saturation,
               adjust_hue]


def apply_jitter(x, order, factors):
    """Apply sampled jitter ops in order. x: float [0,1] HWC."""
    for op in order:
        x = _JITTER_FNS[op](x, factors[op])
    return np.clip(x, 0.0, 1.0)


def color_jitter(x, rng, brightness=0.4, contrast=0.4, saturation=0.4,
                 hue=0.2):
    """Random-order jitter as torchvision.ColorJitter. x: float [0,1] HWC."""
    order, factors = sample_jitter(rng, brightness, contrast, saturation, hue)
    return apply_jitter(x, order, factors)


def normalize(x):
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def train_transform(img, rng, size=224, scale=(0.08, 1.0)):
    img = random_resized_crop(img, rng, size, scale)
    x = np.asarray(img, np.float32) / 255.0
    if rng.random() < 0.5:
        x = x[:, ::-1, :]
    x = color_jitter(x, rng)
    return normalize(x).astype(np.float32)


def val_transform(img, resize=256, crop=224):
    img = resize_center_crop(img, resize, crop)
    x = np.asarray(img, np.float32) / 255.0
    return normalize(x).astype(np.float32)


def quantize_u8(x):
    """float [0,1] -> uint8 pixels (round-half-away, matching the C++
    path's lround). Used by the uint8 output mode: pixels go to the
    card 4x smaller and are normalised there (device_normalizer)."""
    return np.clip(np.rint(x * 255.0), 0.0, 255.0).astype(np.uint8)


def train_transform_u8(img, rng, size=224, scale=(0.08, 1.0)):
    """train_transform minus normalize, quantized to uint8. Consumes the
    SAME rng draw sequence as train_transform (stream-parity)."""
    img = random_resized_crop(img, rng, size, scale)
    x = np.asarray(img, np.float32) / 255.0
    if rng.random() < 0.5:
        x = x[:, ::-1, :]
    x = color_jitter(x, rng)
    return quantize_u8(x)


def val_transform_u8(img, resize=256, crop=224):
    """val_transform minus normalize, quantized to uint8."""
    img = resize_center_crop(img, resize, crop)
    x = np.asarray(img, np.float32) / 255.0
    return quantize_u8(x)


def device_normalizer(compute_dtype):
    """prep(x): uint8 [N, H, W, 3] batches -> (x / 255 - mean) / std in
    f32, then compute_dtype, on x's device; float batches (synthetic data)
    are only cast."""
    import torch

    consts = {}

    def prep(x):
        if x.dtype == torch.uint8:
            if x.device not in consts:
                consts[x.device] = tuple(
                    torch.from_numpy(a).to(x.device)
                    for a in (IMAGENET_MEAN, IMAGENET_STD))
            mean, std = consts[x.device]
            x = (x.float() / 255.0 - mean) / std
        return x.to(compute_dtype)

    return prep
