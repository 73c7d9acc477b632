"""The port's data path against the JAX package's, on the CPU: the host
transforms (a copy), the on-device normaliser, the C++ pipeline built by
the port's own runtime/native.py, ImageList's uint8 batches (val, and
train with the same seed: exact, as the JAX package's uint8 mode), the padded DataLoader, host sharding and the
prefetcher's CPU path. Images are JPEGs written with PIL into tmp_path,
plus one PNG for the PIL path."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.data import imagelist as jil
from tfnas_tpu.data import transforms as jtr
from tfnas_tpu_torch.data import imagelist as til
from tfnas_tpu_torch.data import transforms as ttr
from tfnas_tpu_torch.runtime import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(rng, w, h):
    from PIL import Image
    arr = rng.integers(0, 255, (h, w, 3), np.uint8)
    return Image.fromarray(arr).resize((w, h), Image.BILINEAR)


@pytest.fixture(scope="module")
def image_list(tmp_path_factory):
    """11 images of mixed sizes (one a PNG) and their list file."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(11):
        w, h = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        name = f"img{i}.png" if i == 4 else f"img{i}.jpg"
        _image(rng, w, h).save(root / name, quality=90)
        lines.append(f"{name} {i % 3}")
    lst = root / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(root), str(lst)


def test_transforms_are_the_jax_packages():
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        assert ttr.sample_rrc_box(80, 60, rng_a) == jtr.sample_rrc_box(
            80, 60, rng_b)
        assert ttr.sample_jitter(rng_a) == jtr.sample_jitter(rng_b)
    img = _image(np.random.default_rng(1), 70, 50)
    np.testing.assert_array_equal(
        ttr.train_transform_u8(img, np.random.default_rng(5), 32),
        jtr.train_transform_u8(img, np.random.default_rng(5), 32))
    np.testing.assert_array_equal(
        ttr.train_transform(img, np.random.default_rng(5), 32),
        jtr.train_transform(img, np.random.default_rng(5), 32))
    np.testing.assert_array_equal(ttr.val_transform_u8(img, 36, 32),
                                  jtr.val_transform_u8(img, 36, 32))
    np.testing.assert_array_equal(ttr.val_transform(img, 36, 32),
                                  jtr.val_transform(img, 36, 32))
    x = np.linspace(-0.2, 1.2, 30, dtype=np.float32)
    np.testing.assert_array_equal(ttr.quantize_u8(x), jtr.quantize_u8(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_normalizer_matches_jax(dtype):
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (2, 5, 5, 3), np.uint8)
    f = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jprep, tprep = jtr.device_normalizer(jdt), ttr.device_normalizer(dtype)
    for arr in (u8, f):
        got = tprep(torch.from_numpy(arr))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(
            jprep(jnp.asarray(arr))).astype(np.float32), rtol=1e-6,
            atol=1e-6)


def test_native_builds_outside_the_source_tree():
    path = tnative.build_library()
    assert str(path).startswith(os.path.join(ROOT, "build",
                                             "tfnas_tpu_torch"))
    assert not [f for f in os.listdir(os.path.dirname(tnative._SOURCE))
                if f.endswith(".so")]


@pytest.mark.parametrize("training", [False, True])
def test_imagelist_batches_match_jax(image_list, training):
    root, lst = image_list
    jds = jil.ImageList(root, lst, training, image_size=32, output="uint8")
    assert jds.use_native  # the JAX reference runs its C++ path too
    tds = til.ImageList(root, lst, training, image_size=32)
    loaders = [L(ds, 4, shuffle=training, num_workers=2, seed=7,
                 drop_last=False, pad_last=True)
               for L, ds in ((jil.DataLoader, jds), (til.DataLoader, tds))]
    for epoch in (0, 1):
        for dl in loaders:
            dl.set_epoch(epoch)
        jb, tb = list(loaders[0]), list(loaders[1])
        assert len(tb) == len(jb) == 3
        for (jx, jy, jn), (tx, ty, tn) in zip(jb, tb):
            assert tx.dtype == jx.dtype == np.uint8
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            assert tn == jn
    assert tb[-1][2] == 3 and tb[-1][0].shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(tb[-1][1][3], tb[-1][1][2])
    if not training:  # padding repeats the last valid entry
        np.testing.assert_array_equal(tb[-1][0][3], tb[-1][0][2])


def test_imagelist_host_shard_and_drop_last(image_list):
    root, lst = image_list
    shards = [til.ImageList(root, lst, False, host_shard=(i, 3))
              for i in range(3)]
    ref = [jil.ImageList(root, lst, False, host_shard=(i, 3))
           for i in range(3)]
    assert [s.img_list for s in shards] == [r.img_list for r in ref]
    assert all(len(s) == 4 for s in shards)
    ds = til.ImageList(root, lst, True, image_size=32)
    dl = til.DataLoader(ds, 4, shuffle=True, num_workers=1, seed=1)
    batches = list(dl)
    assert len(batches) == len(dl) == 2 and len(batches[0]) == 2
    with pytest.raises(FileNotFoundError):
        til.ImageList(root, os.path.join(root, "missing.txt"), False)


def test_loader_rows_load_those_entries_alone(image_list):
    """rows picks positions of each batch: the entries and the decoded
    (val) images of the full batch at those positions, in that order."""
    root, lst = image_list
    ds = til.ImageList(root, lst, False, image_size=32)
    full = list(til.DataLoader(ds, 4, num_workers=1, seed=1))
    part = list(til.DataLoader(ds, 4, num_workers=1, seed=1, rows=[3, 1]))
    assert len(part) == len(full) == 2
    for (xf, yf), (xp, yp) in zip(full, part):
        np.testing.assert_array_equal(yp, yf[[3, 1]])
        np.testing.assert_array_equal(xp, xf[[3, 1]])
    with pytest.raises(ValueError):
        til.DataLoader(ds, 4, drop_last=False, rows=[0])


def test_loader_raises_what_a_batch_raised(image_list, tmp_path):
    root, _ = image_list
    lst = tmp_path / "bad.txt"
    lst.write_text("img0.jpg 0\nnot_there.jpg 1\n")
    dl = til.DataLoader(til.ImageList(root, str(lst), False, image_size=32),
                        2, shuffle=False, num_workers=1)
    with pytest.raises(FileNotFoundError):
        list(dl)


def test_prefetcher_cpu_path():
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 255, (2, 4, 4, 3), np.uint8),
                np.arange(2, dtype=np.int32), 1) for _ in range(3)]
    out = list(til.DevicePrefetcher(iter(batches), "cpu"))
    assert len(out) == 3
    for (x, y, n), (bx, by, bn) in zip(out, batches):
        assert x.dtype == torch.uint8 and y.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), bx)
        assert n == bn
