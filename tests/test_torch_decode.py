"""The card image pipeline's CPU-checkable parts (runtime/card.py): the
plain train and val augments against the JAX package's C++ augment
(tfnas_tpu/runtime/native.py) on pixels its libjpeg decoded, over every
jitter order (the empty one too), both flips and crop boxes at the image
edges; the card path's draws against the native path's; and the launch
wrapper's arithmetic (buffer layout, per-image arguments, tiles) with its
plain path on strided images. The kernel and nvJPEG run only on the card
(tests/test_torch_cuda.py).

Tolerances: f32 within 1e-5 of the C++ augment (g++ -O3 -march=native may
contract its multiply-adds into FMAs, the plain version rounds every
operation: measured at most 1.8e-6 apart); uint8 within one level, on at
most 1% of a case's values (measured: at most 0.058%, one value of 1728,
and 0.0012% over all train cases, at the quantiser's half-way points).
"""

import io
import itertools
import re

import numpy as np
import pytest
import torch
from PIL import Image

from tfnas_tpu.runtime import native as jnative
from tfnas_tpu_torch.data import imagelist as til
from tfnas_tpu_torch.data.transforms import sample_jitter
from tfnas_tpu_torch.runtime import card
from tfnas_tpu_torch.runtime import native as tnative

SIZE = 24
ZERO3, ONE3 = np.zeros(3, np.float32), np.ones(3, np.float32)
ORDERS = [[]] + [list(p) for p in itertools.permutations(range(4))]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jpeg(w, h, seed, quality=90):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (max(2, h // 4), max(2, w // 4), 3), np.uint8)
    img = Image.fromarray(arr).resize((w, h), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _boxes(w, h):
    """Crop boxes at the image's edges, a 1 x 1 box and the whole image."""
    return [(0, 0, w, h), (0, 0, 1, 1), (w - 5, h - 7, 5, 7),
            (w - 13, 0, 13, h), (0, h - 9, w // 2, 9), (3, 2, 17, 11)]


def _compare_u8(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    return float(np.mean(diff > 0))


@pytest.mark.parametrize("order", ORDERS, ids=lambda o: "".join(map(str, o))
                         or "none")
def test_plain_train_augment_matches_jax_cpp(order):
    data = _jpeg(37, 29, seed=len(order) * 7 + sum(order))
    pixels = jnative.decode_jpeg(data)
    img = torch.from_numpy(pixels)
    rng = np.random.default_rng(sum(10 ** i * op for i, op in
                                    enumerate(order)))
    shares = []
    for box, flip in itertools.product(_boxes(37, 29), (False, True)):
        _, factors = sample_jitter(rng)
        want = jnative.augment_train_from_array(pixels, box, SIZE, flip,
                                                order, factors, ZERO3, ONE3)
        got = card.augment_train_plain(img, box, SIZE, flip, order, factors)
        assert got.dtype == torch.float32 and got.shape == (SIZE, SIZE, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        want_u8, status = jnative.decode_augment_train_batch_u8(
            [data], [box], SIZE, [flip], [order], [factors], n_threads=1)
        assert status[0] == 0
        shares.append(_compare_u8(card.quantize_plain(got).numpy(),
                                  want_u8[0]))
        # the wrapper's CPU path is the plain version
        wrapped = card.augment_train([img], [box], SIZE, [flip], [order],
                                     [factors])
        np.testing.assert_array_equal(wrapped[0].numpy(),
                                      card.quantize_plain(got).numpy())
    assert max(shares) <= 0.01


@pytest.mark.parametrize("w,h,resize,crop", [
    (37, 29, 36, 32), (29, 37, 36, 32), (33, 33, 40, 24), (61, 23, 20, 24),
    (45, 52, 256, 224)])
def test_plain_val_augment_matches_jax_cpp(w, h, resize, crop):
    """Short side to `resize`, the centre crop (a crop larger than the
    resized image too: the corner's C division rounds toward zero)."""
    data = _jpeg(w, h, seed=w * h)
    pixels = jnative.decode_jpeg(data)
    img = torch.from_numpy(pixels)
    want = jnative.augment_val(pixels, resize, crop, ZERO3, ONE3)
    got = card.augment_val_plain(img, crop, resize)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want_u8, status = jnative.decode_augment_val_batch_u8(
        [data], resize, crop, n_threads=1)
    assert status[0] == 0
    assert _compare_u8(card.quantize_plain(got).numpy(), want_u8[0]) <= 0.01
    np.testing.assert_array_equal(
        card.augment_val([img], crop, resize)[0].numpy(),
        card.quantize_plain(got).numpy())


def test_layout_args_and_tiles():
    """The wrapper's arithmetic: images back to back at ALIGN-byte starts,
    interleaved and planar strides, the per-image arguments the kernel
    reads (its struct's size), the val geometry and the row tiles."""
    src = open(card._SOURCE).read()
    assert int(re.search(r"sizeof\(ImageArgs\) == (\d+)", src).group(1)) \
        == card.IMAGE_ARGS.itemsize
    sizes = [(37, 29), (1, 1), (8, 3), (0, 0), (300, 200)]
    offsets, total = card.decode_layout(sizes)
    assert offsets == [0, 3328, 3584, 3840, 3840]
    assert all(o % card.ALIGN == 0 for o in offsets)
    assert total == 3840 + 180_000 + 224
    rng = np.random.default_rng(0)
    buf = torch.zeros(total, dtype=torch.uint8)
    originals, views = [], []
    for (w, h), off, planar in zip(sizes, offsets, (0, 1, 1, 0, 0)):
        if not w:
            continue
        pix = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
        view = torch.as_strided(buf, (h, w, 3),
                                card.image_strides(w, h, planar), off)
        view.copy_(pix)
        if planar:  # three h x w planes
            np.testing.assert_array_equal(
                buf[off:off + 3 * w * h].view(3, h, w).permute(1, 2, 0), pix)
        originals.append(pix)
        views.append(view)
    boxes = [(2, 3, 30, 20), (0, 0, 1, 1), (1, 0, 6, 3), (100, 50, 150, 140)]
    flips = [True, False, True, False]
    orders = [[1, 3], [], [3, 2, 1, 0], [0]]
    factors = [[1.2, 0.7, 1.1, 0.3], [1.0, 1.0, 1.0, 0.0],
               [0.8, 1.3, 0.6, -0.2], [1.4, 1.0, 1.0, 0.0]]
    got = card.augment_train(views, boxes, SIZE, flips, orders, factors)
    want = card.augment_train(originals, boxes, SIZE, flips, orders, factors)
    assert got.shape == (4, SIZE, SIZE, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(card.augment_val(views, SIZE).numpy(),
                                  card.augment_val(originals, SIZE).numpy())
    a = card.image_args(views, SIZE, boxes, flips, orders, factors)
    for i, (v, off) in enumerate(zip(views, (0, 3328, 3584, 3840))):
        assert a[i]["src"] == buf.data_ptr() + off
        assert tuple(a[i][["row", "col", "chan"]]) == v.stride()
        assert (a[i]["w"], a[i]["h"]) == (v.shape[1], v.shape[0])
    assert list(a[0]["order"]) == [1, 3, -1, -1] and a[0]["flip"] == 1
    assert tuple(a[3][["ox", "oy", "num_x", "den_x", "num_y", "den_y"]]) \
        == (100, 50, 150, SIZE, 140, SIZE)
    np.testing.assert_array_equal(a[2]["factors"],
                                  np.float32([0.8, 1.3, 0.6, -0.2]))
    val = card.image_args(views, 224)
    assert tuple(val[0][["ox", "oy", "num_x", "den_x", "num_y", "den_y"]]) \
        == (51, 16, 37, 327, 29, 256)
    assert list(val[0]["order"]) == [-1] * 4
    assert card.val_geometry(200, 300, 224) == (256, 384, 16, 80)
    assert card.val_geometry(8, 3, 224) == (683, 256, 229, 16)
    for size in (1, 24, 224, 1024, 2000):
        rows = card.rows_per_block(size)
        assert rows >= 1 and rows * size <= max(card.PIXELS_PER_BLOCK, size)
        assert -(-size // rows) * rows >= size
    assert card.rows_per_block(224) == 4


class _Recorder:
    def __init__(self):
        self.calls = []

    def card_train(self, datas, sizes, boxes, size, flips, orders, factors,
                   host_pixels, device):
        self.calls.append((list(datas), boxes, flips, orders, factors))
        for j, (w, h) in enumerate(sizes):  # the sizes the draws took
            if not datas[j].startswith(b"\xff\xd8"):  # the PNG: PIL's
                assert host_pixels(j).shape == (h, w, 3)
        return torch.zeros((len(datas), size, size, 3), dtype=torch.uint8), \
            ["hardware"] * len(datas)

    def native_train(self, datas, boxes, size, flips, orders, factors):
        self.calls.append((list(datas), boxes, flips, orders, factors))
        return np.zeros((len(datas), size, size, 3), np.uint8), \
            np.zeros(len(datas), np.int32)


def test_card_path_draws_what_the_native_path_draws(tmp_path, monkeypatch):
    """The same list through DataLoader on the card path (its decode
    replaced by a recorder) and on the native path: the same files, crop
    boxes, flips, jitter orders and factors, batch by batch, and the same
    labels; a PNG (no JPEG header) takes its size from PIL on both."""
    lines = []
    for i in range(10):
        name = f"{i}.png" if i == 1 else f"{i}.jpg"
        w, h = 30 + 3 * i, 50 - 2 * i
        if name.endswith(".png"):
            Image.fromarray(np.full((h, w, 3), 99, np.uint8)).save(
                tmp_path / name)
        else:
            (tmp_path / name).write_bytes(_jpeg(w, h, seed=i))
        lines.append(f"{name} {i % 4}")
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    rec_card, rec_native = _Recorder(), _Recorder()
    monkeypatch.setattr(card, "decode_augment_train_batch",
                        rec_card.card_train)
    monkeypatch.setattr(tnative, "decode_augment_train_batch_u8",
                        rec_native.native_train)
    on_card = til.ImageList(str(tmp_path), str(lst), True, image_size=16)
    on_card.decoder = "card"  # the card path without a card
    native = til.ImageList(str(tmp_path), str(lst), True, image_size=16)
    native.decoder = "native"
    ys = []
    for ds in (on_card, native):
        dl = til.DataLoader(ds, 5, shuffle=True, num_workers=1, seed=3)
        dl.set_epoch(2)
        ys.append([y.tolist() for _, y in dl])
    assert ys[0] == ys[1] and len(ys[0]) == 2
    assert len(rec_card.calls) == len(rec_native.calls) == 2
    for a, b in zip(rec_card.calls, rec_native.calls):
        assert a == b
    assert on_card.decoded == {"hardware": 10}
