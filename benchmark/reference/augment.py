"""The retrain cell's input pipeline in plain Python and PyTorch: the
loader's shuffle and augmentation draws, PIL decode, the train augment
(crop box, flip, colour jitter, clip), uint8 quantisation and the
normalisation on the device. A frozen copy of the port's draws
(data/transforms.py, data/imagelist.py) and of its plain augment
(runtime/card.py), which the card's augment kernel is held to."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

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


def jpeg_size(data):
    """(width, height) of a JPEG byte buffer from its SOF marker, in pure
    Python. Raises ValueError for data that is not a JPEG."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG")
    i = 2
    n = len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = (data[i + 2] << 8) | data[i + 3]
        # SOF0..SOF15 except DHT (C4), JPG (C8) and DAC (CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = (data[i + 5] << 8) | data[i + 6]
            w = (data[i + 7] << 8) | data[i + 8]
            return w, h
        i += 2 + seg_len
    raise ValueError("no SOF marker found")


def _f32(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def _bilinear_plain(img, sx, sy):
    """image_pipeline.cpp `bilinear` at every (sy[i], sx[j]), scaled to
    [0, 1]: f32 [len(sy), len(sx), 3]."""
    h, w = img.shape[:2]
    sx, sy = sx.clamp(0.0, float(w - 1)), sy.clamp(0.0, float(h - 1))
    x0, y0 = sx.long(), sy.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    fx = (sx - x0.float())[None, :, None]
    fy = (sy - y0.float())[:, None, None]
    p = img.int()
    p00, p01 = p[y0[:, None], x0[None, :]], p[y0[:, None], x1[None, :]]
    p10, p11 = p[y1[:, None], x0[None, :]], p[y1[:, None], x1[None, :]]
    top = p00.float() + (p01 - p00).float() * fx
    bot = p10.float() + (p11 - p10).float() * fx
    inv = _f32(1.0, img.device) / _f32(255.0, img.device)
    return (top + (bot - top) * fy) * inv


def _gray_plain(x):
    dev = x.device
    return ((_f32(0.299, dev) * x[..., 0] + _f32(0.587, dev) * x[..., 1])
            + _f32(0.114, dev) * x[..., 2])


def _hue_plain(x, shift):
    r, g, b = x.unbind(-1)
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    v, delta = maxc, maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    dz = delta.clamp(min=1e-12)
    hh = torch.where(maxc == r, torch.fmod((g - b) / dz, 6.0),
                     torch.where(maxc == g, (b - r) / dz + 2.0,
                                 (r - g) / dz + 4.0))
    hh = torch.where(delta == 0, 0.0, hh)
    hh = torch.where(hh < 0, hh + 6.0, hh)
    hn = hh / 6.0 + shift
    hn = hn - torch.floor(hn)
    h6 = hn * 6.0
    ii = (h6.int() % 6).long()
    fr = h6 - torch.floor(h6)
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))
    pick = [torch.stack(c, -1).gather(-1, ii[..., None])[..., 0] for c in (
        (v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))]
    return torch.stack(pick, -1)


def _jitter_plain(x, op, f):
    if op == 0:
        return x * f
    if op == 1:
        m = (_gray_plain(x).double().sum() / (x.shape[0] * x.shape[1])
             ).float()
        return (x - m) * f + m
    if op == 2:
        g = _gray_plain(x)[..., None]
        return (x - g) * f + g
    return _hue_plain(x, f)


def augment_train_plain(img, box, size, flip, order, factors):
    """The plain version of the train augment of one uint8 [H, W, 3] image,
    as f32 [size, size, 3] in [0, 1] before quantisation:
    image_pipeline.cpp `tfnas_augment_train` step by step (crop-box
    sample, flip, the jitter ops in `order` with no clip between them,
    clip)."""
    dev = img.device
    cx, cy, cw, ch = (int(v) for v in box)
    o = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    sx = (_f32(cx, dev) + o * (_f32(cw, dev) / _f32(size, dev))) - 0.5
    sy = (_f32(cy, dev) + o * (_f32(ch, dev) / _f32(size, dev))) - 0.5
    x = _bilinear_plain(img, sx, sy)
    if flip:
        x = x.flip(1)
    fac = torch.tensor(np.asarray(factors, np.float32), device=dev)
    for op in order:
        x = _jitter_plain(x, op, fac[op])
    return x.clamp(0.0, 1.0)


def quantize_plain(x):
    """f32 pixels in [0, 1] -> uint8 rint(x * 255), halves away from 0
    (image_pipeline.cpp `quantize_u8`'s lround)."""
    v = (x * 255.0).clamp(0.0, 255.0)
    return torch.floor(v.double() + 0.5).to(torch.uint8)


def pil_decode(path):
    """uint8 [H, W, 3] RGB pixels of an image file, through PIL."""
    from PIL import Image
    with Image.open(path) as img:
        return np.array(img.convert("RGB"), np.uint8)


def normalize(x):
    """uint8 [N, H, W, 3] -> (x / 255 - mean) / std in float32."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x.float() / 255.0 - mean) / std


def epoch_order(n, seed, epoch):
    """The loader's shuffled order of n entries in an epoch."""
    order = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(order)
    return order


def train_batch(root, entries, indices, seed, epoch, bi, size, rrc_scale,
                device):
    """(uint8 [n, size, size, 3] on `device`, int64 labels) of the loader's
    batch `bi`: each entry's bytes, its draws from
    default_rng((seed, epoch, bi)) image by image (crop box from the JPEG
    header's size, flip, jitter), PIL decode and the plain augment."""
    rng = np.random.default_rng((seed, epoch, bi))
    xs, ys = [], []
    for i in indices:
        rel, label = entries[i]
        path = os.path.join(root, rel)
        with open(path, "rb") as f:
            w, h = jpeg_size(f.read())
        box = sample_rrc_box(w, h, rng, rrc_scale)
        flip = rng.random() < 0.5
        order, factors = sample_jitter(rng)
        img = torch.from_numpy(pil_decode(path)).to(device)
        xs.append(quantize_plain(augment_train_plain(
            img, box, size, flip, order, factors)))
        ys.append(label)
    return torch.stack(xs), torch.tensor(ys, dtype=torch.int64,
                                         device=device)
