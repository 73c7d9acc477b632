"""Synthetic image batches (counterpart of tfnas_tpu/data/synthetic.py).

Pseudo-images with class-correlated means, so training steps have signal
to descend on. `SyntheticImages` makes the JAX package's numpy batches from
the same seed; `device_batches` makes batches of the same distribution
directly on a device, from a torch.Generator there.

Under data parallelism rank i of n takes its rows of each global batch,
`shard=(i, n)`, so that n ranks see exactly one process's batches.
"""

from __future__ import annotations

import numpy as np
import torch


class SyntheticImages:
    def __init__(self, num_classes=100, image_size=224, seed=0):
        self.num_classes = num_classes
        self.image_size = image_size
        self.seed = seed

    def batches(self, batch_size, steps, shard=None):
        """`steps` batches of `batch_size`; shard=(i, n): rows [i * b, (i +
        1) * b) of each, b = batch_size / n."""
        rng = np.random.default_rng(self.seed)
        rows = slice(None)
        if shard is not None:
            if batch_size % shard[1]:
                raise ValueError(f"batch {batch_size} does not divide over "
                                 f"{shard[1]} ranks")
            b = batch_size // shard[1]
            rows = slice(shard[0] * b, (shard[0] + 1) * b)
        for _ in range(steps):
            y = rng.integers(0, self.num_classes, batch_size).astype(np.int32)
            x = rng.standard_normal(
                (batch_size, self.image_size, self.image_size, 3),
                np.float32)
            x += (y[:, None, None, None] / self.num_classes - 0.5)
            yield x[rows], y[rows]


def synthetic_loader(batch_size, steps, num_classes=100, image_size=224,
                     seed=0, shard=None):
    return SyntheticImages(num_classes, image_size, seed).batches(
        batch_size, steps, shard)


def device_batches(batch_size, steps, generator, num_classes=100,
                   image_size=224, dtype=torch.float32):
    """(x [N, H, W, 3] in dtype, y int64 [N]) batches made on the
    generator's device."""
    dev = generator.device
    for _ in range(steps):
        y = torch.randint(0, num_classes, (batch_size,), generator=generator,
                          device=dev)
        x = torch.randn((batch_size, image_size, image_size, 3),
                        generator=generator, device=dev)
        x += (y.float() / num_classes - 0.5)[:, None, None, None]
        yield x.to(dtype), y
