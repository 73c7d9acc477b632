"""The card image pipeline's CPU-checkable parts (runtime/card.py): the
plain train and val augments against the JAX package's C++ augment
(tfnas_tpu/runtime/native.py) on pixels its libjpeg decoded, over every
jitter order (the empty one too), both flips and crop boxes at the image
edges; the card path's draws against the native path's; and the launch
wrapper's arithmetic (buffer layout, per-image arguments, the kernel's
plan) with its plain path on strided images: the vectorised per-image
arguments against the old field-by-field packing, the plan's cover of
every output row, its launches and parameter bytes, and a mirror of the
kernel's order of the contrast gray sum against the plain mean. The
kernel and nvJPEG run only on the card (tests/test_torch_cuda.py).

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
from tfnas_tpu_torch.data.transforms import sample_jitter, sample_rrc_box
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
    reads (its struct's size), the val geometry and the kernel's blocks of
    rows (`plan`)."""
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
    for size in (1, 24, 224, 1024, 2000):  # every row in one block
        p = card.plan(size)
        assert p.rows >= 1 and p.clusters <= card.MAX_CLUSTER
        assert p.clusters * p.rows >= size > (p.clusters - 1) * p.rows
    assert card.plan(224)[1:] == (8, 28, 28, 7, 1, 1, 28, 1, 22_192)


def _image_args_by_field(images, size, boxes=None, flips=None, orders=None,
                         factors=None, resize=card.VAL_RESIZE):
    """image_args as it was packed before its columns were vectorised:
    image by image, field by field."""
    a = np.zeros(len(images), card.IMAGE_ARGS)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        a[i]["src"] = img.data_ptr()
        a[i]["row"], a[i]["col"], a[i]["chan"] = img.stride()
        a[i]["h"], a[i]["w"] = h, w
        a[i]["order"] = -1
        if boxes is None:
            nw, nh, x0, y0 = card.val_geometry(w, h, size, resize)
            a[i]["ox"], a[i]["oy"] = x0, y0
            a[i]["num_x"], a[i]["den_x"] = w, nw
            a[i]["num_y"], a[i]["den_y"] = h, nh
        else:
            cx, cy, cw, ch = (int(v) for v in boxes[i])
            a[i]["ox"], a[i]["oy"] = cx, cy
            a[i]["num_x"], a[i]["den_x"] = cw, size
            a[i]["num_y"], a[i]["den_y"] = ch, size
            a[i]["flip"] = int(bool(flips[i]))
            a[i]["order"][:len(orders[i])] = orders[i]
            a[i]["factors"] = np.asarray(factors[i], np.float32)
    return a


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("n", [1, 7, 256, 300])
def test_image_args_match_field_by_field(n, mode):
    """The vectorised image_args against the old per-image packing, byte
    for byte: n views of one decode buffer, interleaved and planar in
    turn, 1 to 600 px a side (tall and wide for val's short side), jitter
    orders of 0 to 4 ops."""
    rng = np.random.default_rng(n)
    sizes = [(int(rng.integers(1, 600)), int(rng.integers(1, 600)))
             for _ in range(n)]
    offsets, total = card.decode_layout(sizes)
    buf = torch.zeros(total, dtype=torch.uint8)
    views = [torch.as_strided(buf, (h, w, 3),
                              card.image_strides(w, h, i % 2), off)
             for i, ((w, h), off) in enumerate(zip(sizes, offsets))]
    if mode == "train":
        boxes = [sample_rrc_box(w, h, rng) for w, h in sizes]
        flips = [bool(rng.random() < 0.5) for _ in sizes]
        jitter = [sample_jitter(rng) for _ in sizes]
        orders = [o[:int(rng.integers(0, 5))] for o, _ in jitter]
        args = (views, 224, boxes, flips, orders, [f for _, f in jitter])
    else:
        args = (views, 224)
    got, want = card.image_args(*args), _image_args_by_field(*args)
    assert got.dtype == want.dtype == card.IMAGE_ARGS
    assert got.tobytes() == want.tobytes()


PLAN_SIZES = [1, 2, 24, 31, 32, 33, 37, 224, 225, 256, 257, 300, 512, 1000,
              1024, 2000, 4096]


@pytest.mark.parametrize("size", PLAN_SIZES)
def test_plan_covers_every_row_once(size):
    """The kernel's plan: every output row and column of an image taken
    by exactly one thread (block rank, warp, row pass; lane, column
    group), at most MAX_CLUSTER blocks of MAX_WARPS warps, a thread's held
    pixels within HOLD, and staging that fits a tile at any offset mod 16
    within the block's shared memory."""
    p = card.plan(size)
    assert 1 <= p.clusters <= card.MAX_CLUSTER
    assert 1 <= p.warps <= card.MAX_WARPS
    assert p.kx == -(-size // card.LANES)
    taken = np.zeros(size, int)
    for rank in range(p.clusters):
        y0 = rank * p.rows
        nr = min(p.rows, size - y0)
        assert nr >= 1  # no empty block
        for w in range(p.warps):
            passes = p.ky if p.hold else -(-nr // p.warps)
            rows = [w + p.warps * j for j in range(passes)]
            taken[[y0 + r for r in rows if r < nr]] += 1
    assert (taken == 1).all()
    cols = [lane + card.LANES * i for lane in range(card.LANES)
            for i in range(p.kx)]  # the kernel masks columns >= size
    assert (np.bincount([c for c in cols if c < size]) == 1).all()
    assert max(cols) >= size - 1
    if p.hold:
        assert p.kx * p.ky <= card.HOLD and p.warps * p.ky >= p.rows
        assert (p.tile_rows, p.buffers) == (p.rows, 1)
    else:
        assert p.kx * p.ky > card.HOLD
        assert 1 <= p.tile_rows <= p.rows
        assert p.buffers == (1 if p.tile_rows == p.rows else 2)
    tables = p.rows * card.ROW_BYTES + size * card.COL_BYTES
    assert tables + p.buffers * (3 * size * p.tile_rows + 15) <= p.smem
    assert p.smem <= card.SMEM_PER_BLOCK


def test_plan_launches_and_parameters():
    """A launch takes at most LAUNCH_IMAGES images, whose arguments and
    the plan fit in a kernel's parameters (CUDA 12.1: 32,764 bytes);
    300 images take two launches; the wrapper's constants are the
    source's; sizes whose staging cannot fit are refused."""
    # Launch: the 44-byte Plan, the output pointer at offset 48, the
    # images' arguments from offset 56
    assert 56 + card.LAUNCH_IMAGES * card.IMAGE_ARGS.itemsize <= 32_764
    assert card.launch_splits(300) == [(0, 256), (256, 44)]
    for n in (1, 7, 255, 256, 257, 1000):
        splits = card.launch_splits(n)
        assert len(splits) == -(-n // card.LAUNCH_IMAGES)
        assert [i for f, k in splits for i in range(f, f + k)] == \
            list(range(n))
        assert all(1 <= k <= card.LAUNCH_IMAGES for _, k in splits)
    src = open(card._SOURCE).read()
    for name in ("LANES", "MAX_WARPS", "MAX_CLUSTER", "HOLD",
                 "LAUNCH_IMAGES", "SMEM_PER_BLOCK"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert int(found.group(1)) == getattr(card, name), name
    fields = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)[,;]", re.sub(r"//.*", "", fields))
    assert names == ["size", "mode", "clusters", "rows", "warps", "kx",
                     "ky", "hold", "tile_rows", "buffers", "smem"]
    assert len(card.plan_ints(card.plan(224), card.MODE_TRAIN)) == 11
    for size in (0, 40_000):
        with pytest.raises(ValueError):
            card.plan(size)


def _before_contrast(img, box, size, flip, order, factors):
    """augment_train_plain's f32 image just before its contrast op."""
    def f32(v):
        return card._f32(v, img.device)
    cx, cy, cw, ch = (int(v) for v in box)
    o = torch.arange(size, dtype=torch.float32) + 0.5
    sx = (f32(cx) + o * (f32(cw) / f32(size))) - 0.5
    sy = (f32(cy) + o * (f32(ch) / f32(size))) - 0.5
    x = card._bilinear_plain(img, sx, sy)
    if flip:
        x = x.flip(1)
    fac = torch.tensor(np.asarray(factors, np.float32))
    for op in order[:order.index(1)]:
        x = card._jitter_plain(x, op, fac[op])
    return x


def _kernel_mean(gray, p):
    """The kernel's contrast mean of an S x S f32 gray image under plan p,
    summed in its order: each thread's f64 sum over its rows, then its
    columns; each warp's shuffle tree (at offset o, lane l adds lane
    l + o); the same tree over the block's warp sums, zero-padded to 32;
    the blocks' sums in rank order; the mean rounded to f32."""
    g = np.asarray(gray, np.float64)
    size, lanes = p.size, card.LANES
    blocks = []
    for rank in range(p.clusters):
        y0 = rank * p.rows
        nr = min(p.rows, size - y0)
        acc = np.zeros((p.warps, lanes))
        for j in range(-(-nr // p.warps)):
            r = np.arange(p.warps) + p.warps * j
            for i in range(p.kx):
                c = np.arange(lanes) + lanes * i
                ok = (r[:, None] < nr) & (c[None, :] < size)
                vals = g[y0 + np.minimum(r, nr - 1)][:, np.minimum(c,
                                                                  size - 1)]
                acc = acc + np.where(ok, vals, 0.0)
        for o in (16, 8, 4, 2, 1):
            acc[:, :o] = acc[:, :o] + acc[:, o:2 * o]
        v = np.zeros(lanes)
        v[:p.warps] = acc[:, 0]
        for o in (16, 8, 4, 2, 1):
            v[:o] = v[:o] + v[o:2 * o]
        blocks.append(v[0])
    m = 0.0
    for b in blocks:
        m += b
    return np.float32(m / (float(size) * size))


@pytest.mark.parametrize("size", [24, 37, 224, 225, 300])
def test_kernel_gray_sum_order_gives_plain_mean(size):
    """A mirror of the kernel's gray-sum order (per thread, the block's
    trees, the cluster's blocks in rank order) gives the plain version's
    f32 contrast mean, on images whose plan holds (24-225) and sweeps
    (300), flipped and not, contrast anywhere in the order."""
    rng = np.random.default_rng(size)
    p = card.plan(size)
    assert p.hold == (size <= 256)
    for case in range(4):
        h, w = int(rng.integers(20, 400)), int(rng.integers(20, 400))
        img = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
        box = sample_rrc_box(w, h, rng)
        order, factors = sample_jitter(rng)
        order = [op for op in order if op != 1]
        order.insert(case, 1)  # contrast at each position in turn
        x = _before_contrast(img, box, size, case % 2 == 1, order, factors)
        gray = card._gray_plain(x)
        want = (gray.double().sum() / (size * size)).float().item()
        assert _kernel_mean(gray.numpy(), p) == np.float32(want)


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
