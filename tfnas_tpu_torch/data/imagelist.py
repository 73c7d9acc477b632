"""Image-list dataset, threaded batch loader and the card's prefetcher
(counterpart of tfnas_tpu/data/imagelist.py).

List files are 'relpath label' lines. `ImageList.get_batch` reads a batch's
files and makes its random draws in Python (the same draws, in the same
order, as the JAX package's), then decodes and augments the whole batch in
one go. The decoder follows the device the list feeds: for a CUDA device,
nvJPEG and the hand-written augment kernel on the card
(runtime/card.py), which returns the batch as a card tensor; elsewhere the
C++ pipeline (runtime/native.py) where it builds. Either way an entry the
decoder refuses goes through PIL and the same augment. Off the card, where
the pipeline cannot be built (no g++ or no libjpeg header), or with
use_native=False, each entry is decoded by PIL and augmented by
transforms.train_transform_u8 / val_transform_u8, as the JAX package's
ImageList.get does. `DataLoader` assembles batches in a thread pool,
shuffled per epoch, and with `pad_last` yields a padded final batch with
its valid count for exact validation.
`DevicePrefetcher` keeps two batches in flight to the card from pinned host
buffers; card batches pass through it.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import queue
import threading

import numpy as np
import torch

from ..runtime import card, native
from .transforms import (quantize_u8, sample_jitter, sample_rrc_box,
                         train_transform_u8, val_transform_u8)


def default_list_reader(list_path):
    """'relpath label' lines -> [(relpath, label)]."""
    if not os.path.exists(list_path):
        raise FileNotFoundError(
            f"image list '{list_path}' not found: run `python dataset/"
            "make_lists.py --imagenet_root <path>` for ImageNet-100, or "
            "`python dataset/make_proxy_dataset.py --out_root <path>` for "
            "the real-JPEG proxy set, or pass --synthetic")
    img_list = []
    with open(list_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            img_path, label = line.split(" ")
            img_list.append((img_path, int(label)))
    return img_list


def pil_loader(path):
    from PIL import Image
    with Image.open(path) as img:
        return img.convert("RGB").copy()


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


def image_decoder(device=None):
    """What an ImageList(use_native="auto") for `device` decodes with, as
    the drivers log it once: for a CUDA device 'nvjpeg (<its backends>;
    nvJPEG <version>)' (runtime/card.py; raises where the card pipeline
    cannot be opened); elsewhere 'native' (the C++ pipeline), or 'pil (<why
    the pipeline is not there: the first line of native.build_error>)'."""
    if device is not None and torch.device(device).type == "cuda":
        card.open_pipeline(device)
        return card.describe()
    if native.available():
        return "native"
    return f"pil ({native.build_error.splitlines()[0]})"


class ImageList:
    """Map-style dataset over a list file, of augmented uint8 pixels: they
    are normalised on the card by transforms.device_normalizer (4x fewer
    bytes to the card than the JAX package's float32 mode, which the port
    does not keep). host_shard=(i, n): this host's share of a list padded
    by wrapping to a multiple of n; its first `num_real` entries are the
    list's own, the rest wrap padding. rrc_scale: RandomResizedCrop's area
    range. device: where the batches go. For a CUDA device, use_native
    "auto" or True decodes and augments on the card (runtime/card.py,
    get_batch returns a uint8 card tensor) and raises here, with
    card.build_error, where that pipeline cannot be built or opened.
    Elsewhere "auto" decodes with the C++ pipeline where it builds
    (runtime/native.available()) and with PIL otherwise, and True insists
    on the C++ pipeline (get_batch raises where it cannot be built).
    False decodes with PIL on any device. `decoded` counts the entries by
    what decoded them ('hardware', 'default', 'pil') on the card path."""

    def __init__(self, root, list_path, training, image_size=224,
                 list_reader=default_list_reader, loader=pil_loader,
                 host_shard=None, use_native="auto", rrc_scale=(0.08, 1.0),
                 device=None):
        self.root = root
        self.img_list = list_reader(list_path)
        self.num_real = len(self.img_list)
        if host_shard is not None and host_shard[1] > 1:
            i, n = host_shard
            total = -(-len(self.img_list) // n) * n
            padded = self.img_list + self.img_list[:total - len(self.img_list)]
            self.num_real = len(range(i, len(self.img_list), n))
            self.img_list = padded[i::n]
        self.training = training
        self.image_size = image_size
        self.loader = loader
        self.device = None if device is None else torch.device(device)
        if use_native is False:
            self.decoder = "pil"
        elif self.device is not None and self.device.type == "cuda":
            card.open_pipeline(self.device)
            self.decoder = "card"
        elif use_native == "auto":
            self.decoder = "native" if native.available() else "pil"
        else:
            self.decoder = "native"
        self.use_native = self.decoder != "pil"
        self.rrc_scale = tuple(rrc_scale)
        self.decoded = collections.Counter()
        self._count_lock = threading.Lock()

    def __len__(self):
        return len(self.img_list)

    def get_batch(self, indices, rng):
        """(xs [n, S, S, 3] uint8, ys [n] int32) of the entries `indices`,
        with the random draws of training taken from `rng` image by
        image; xs is a card tensor on the card path, else numpy."""
        if self.decoder == "pil":
            return self._get_batch_pil(indices, rng)
        ys, datas, sizes, draws, pil_imgs = self._read_and_draw(indices, rng)

        def host_pixels(j):  # an entry the decoder refused: PIL decode
            img = pil_imgs.get(j)
            if img is None:
                img_path = self.img_list[indices[j]][0]
                img = self.loader(os.path.join(self.root, img_path))
            return np.asarray(img, np.uint8)

        boxes, flips, orders, factors = draws
        if self.decoder == "card":
            if self.training:
                xs, backends = card.decode_augment_train_batch(
                    datas, sizes, boxes, self.image_size, flips, orders,
                    factors, host_pixels, self.device)
            else:
                xs, backends = card.decode_augment_val_batch(
                    datas, self.image_size, host_pixels, self.device)
            with self._count_lock:
                self.decoded.update(backends)
            return xs, ys
        if self.training:
            xs, status = native.decode_augment_train_batch_u8(
                datas, boxes, self.image_size, flips, orders, factors)
        else:
            xs, status = native.decode_augment_val_batch_u8(
                datas, 256, self.image_size)
        for j in np.nonzero(status)[0]:  # not JPEG, or corrupt: PIL decode
            arr = host_pixels(j)
            if self.training:  # the same augment on PIL's pixels
                x = native.augment_train_from_array(
                    arr, boxes[j], self.image_size, flips[j], orders[j],
                    factors[j])
            else:
                x = native.augment_val(arr, 256, self.image_size)
            xs[j] = quantize_u8(x)
        return xs, ys

    def _read_and_draw(self, indices, rng):
        """(ys, the files' bytes, the (w, h) each draw was made for, the
        draws (boxes, flips, orders, factors), the entries PIL decoded for
        their size) of a batch. For training, image by image: the size
        from the JPEG header (or PIL), then sample_rrc_box, the flip,
        sample_jitter."""
        n = len(indices)
        ys = np.empty((n,), np.int32)
        datas, sizes, boxes, flips, orders, factors = [], [], [], [], [], []
        pil_imgs = {}
        for j, index in enumerate(indices):
            img_path, ys[j] = self.img_list[index]
            path = os.path.join(self.root, img_path)
            with open(path, "rb") as f:
                datas.append(f.read())
            if self.training:
                try:
                    w, h = jpeg_size(datas[-1])
                except ValueError:
                    pil_imgs[j] = self.loader(path)
                    w, h = pil_imgs[j].size
                sizes.append((w, h))
                boxes.append(sample_rrc_box(w, h, rng, self.rrc_scale))
                flips.append(rng.random() < 0.5)
                order, facs = sample_jitter(rng)
                orders.append(order)
                factors.append(facs)
        return ys, datas, sizes, (boxes, flips, orders, factors), pil_imgs

    def _get_batch_pil(self, indices, rng):
        """get_batch entry by entry through PIL: each image's draws (crop
        box from the decoded size, flip, jitter) in the JAX package's
        order (ImageList.get)."""
        s = self.image_size
        xs = np.empty((len(indices), s, s, 3), np.uint8)
        ys = np.empty((len(indices),), np.int32)
        for j, index in enumerate(indices):
            img_path, ys[j] = self.img_list[index]
            img = self.loader(os.path.join(self.root, img_path))
            xs[j] = (train_transform_u8(img, rng, s, self.rrc_scale)
                     if self.training else val_transform_u8(img, crop=s))
        return xs, ys


class DataLoader:
    """Threaded batch loader: shuffled per epoch, drop_last for fixed
    shapes, a bounded queue of batches ahead of the consumer.

    pad_last (with drop_last=False) pads the final short batch to
    batch_size by repeating its last entry and yields (x, y, n_valid), so
    metrics can mask the padding and every sample is scored once. The wrap
    padding of a host shard (entries from the dataset's `num_real` on)
    counts as padding too: in an unshuffled order it ends the last
    batches.

    rows: the positions within each batch to load, in this order (None:
    all); the others are never read or decoded. The batches' entries stay
    those of the full batch_size, but the augmentation draws follow the
    rows loaded."""

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=4,
                 seed=0, drop_last=True, prefetch=4, pad_last=False,
                 rows=None):
        if rows is not None and not drop_last:
            raise ValueError("rows needs full batches (drop_last)")
        self.rows = None if rows is None else np.asarray(rows)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        # more threads than cores only adds GIL contention
        self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_last = pad_last and not drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        order = np.arange(len(self.dataset))
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            rng.shuffle(order)
        nb = len(self)
        real = getattr(self.dataset, "num_real", len(self.dataset))
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_batch(bi):
            idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            n_valid = int(np.sum(idxs < real))
            if self.pad_last and len(idxs) < self.batch_size:
                idxs = np.concatenate(
                    [idxs, np.full(self.batch_size - len(idxs), idxs[-1])])
            if self.rows is not None:
                idxs = idxs[self.rows]
            sub = np.random.default_rng((self.seed, self.epoch, bi))
            xs, ys = self.dataset.get_batch([int(i) for i in idxs], sub)
            return (xs, ys, n_valid) if self.pad_last else (xs, ys)

        def put(item):
            # gives up when the consumer is gone, so an abandoned iterator
            # cannot leave the producer blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        failure = []

        def producer():
            window = self.num_workers + self.prefetch
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    futs = {}
                    nxt = 0
                    for bi in range(nb):
                        while nxt < nb and len(futs) < window:
                            futs[nxt] = pool.submit(load_batch, nxt)
                            nxt += 1
                        if stop.is_set() or not put(futs.pop(bi).result()):
                            break
            except Exception as e:  # handed to the consumer, which raises
                failure.append(e)
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if failure:
                raise failure[0]
        finally:
            stop.set()


class DevicePrefetcher:
    """Batches of numpy arrays or card tensors (and a trailing valid count)
    -> tensors on `device`, `depth` batches ahead of the consumer.

    On the card each numpy array is copied into pinned host memory and
    sent with non_blocking copies on a side stream; a batch that is already
    on the card (the card decoder's, made on a stream its loader thread
    synchronised) passes through. The consumer's stream waits on the copy's
    event before it uses the batch, and takes over its memory. Labels
    become int64. On the CPU the arrays are wrapped without a copy."""

    def __init__(self, it, device, depth=2):
        self.it = iter(it)
        self.device = torch.device(device)
        self.depth = depth

    @staticmethod
    def _host(batch):
        x, y = batch[0], batch[1]
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return (x, torch.from_numpy(np.asarray(y, np.int64))), batch[2:]

    def __iter__(self):
        if self.device.type != "cuda":
            for batch in self.it:
                tensors, rest = self._host(batch)
                yield tensors + tuple(rest)
            return
        stream = torch.cuda.Stream(self.device)
        pending = collections.deque()
        for batch in self.it:
            tensors, rest = self._host(batch)
            pinned = [t if t.is_cuda else t.pin_memory() for t in tensors]
            with torch.cuda.stream(stream):
                on_card = tuple(t.to(self.device, non_blocking=True)
                                for t in pinned)
                ready = torch.cuda.Event()
                ready.record(stream)
            pending.append((on_card, tuple(rest), ready))
            if len(pending) > self.depth:
                yield self._take(pending.popleft())
        while pending:
            yield self._take(pending.popleft())

    @staticmethod
    def _take(item):
        on_card, rest, ready = item
        consumer = torch.cuda.current_stream(on_card[0].device)
        consumer.wait_event(ready)
        for t in on_card:  # the memory belongs to the consumer's stream now
            t.record_stream(consumer)
        return on_card + rest
