"""Host images per second of the threaded DataLoader over a real image
list, delivered to the device (counterpart of the repository's
tools_loader_throughput.py): the rate that must exceed the search's
consumption (steps/s x batch size) for the search not to wait on its input.

    python -m tfnas_tpu_torch.tools_loader_throughput --img_root DIR \\
        --list DIR/proxy_train.txt [--val] [--no_native] [--workers 4] \\
        [--batches 40] [--chip_steps_per_sec 5.65] [--device cuda]

ImageList decodes with the C++ pipeline where it builds and with PIL
elsewhere (`native` in the output says which); --no_native forces PIL.
Batches go through DevicePrefetcher to --device, as the drivers feed the
card (pinned host buffers, copies on a side stream); on the CPU the
prefetcher wraps the arrays without a copy. One batch is loaded before the
clock starts (thread pool start, page cache). The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .data import DataLoader, DevicePrefetcher, ImageList
from .device import describe, resolve_device


def measure(ds, batch_size, workers, n_batches, device, seed=0):
    """Images per second over n_batches batches on `device`, after one."""
    dl = DataLoader(ds, batch_size, shuffle=True, num_workers=workers,
                    seed=seed)
    it = iter(DevicePrefetcher(dl, device))
    next(it)
    tic = time.perf_counter()
    n = 0
    for _ in range(n_batches):
        x, y = next(it)
        n += len(y)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - tic
    it.close()
    return n / dt


parser = argparse.ArgumentParser("loader throughput")
parser.add_argument("--img_root", required=True)
parser.add_argument("--list", dest="list_path", required=True)
parser.add_argument("--batch_size", type=int, default=32)
parser.add_argument("--workers", type=int, default=4)
parser.add_argument("--batches", type=int, default=40)
parser.add_argument("--image_size", type=int, default=224)
parser.add_argument("--val", action="store_true",
                    help="val transform (resize + crop) instead of the "
                         "train RandomResizedCrop")
parser.add_argument("--no_native", action="store_true",
                    help="decode with PIL even where the C++ pipeline "
                         "builds")
parser.add_argument("--chip_steps_per_sec", type=float, default=0.0,
                    help="the device's consumption (steps/s at this batch "
                         "size) for the verdict keys")
parser.add_argument("--device", type=str, default="cuda")


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    ds = ImageList(args.img_root, args.list_path, training=not args.val,
                   image_size=args.image_size,
                   use_native=False if args.no_native else "auto")
    print(f"dataset: {len(ds)} images, native={ds.use_native}, "
          f"training={ds.training}", flush=True)
    rate = measure(ds, args.batch_size, args.workers, args.batches, device)
    out = {"metric": "loader_images_per_sec", "value": rate,
           "native": ds.use_native, "workers": args.workers,
           "batch_size": args.batch_size, "image_size": args.image_size,
           "training": ds.training, **describe(device)}
    if args.chip_steps_per_sec > 0:
        demand = args.chip_steps_per_sec * args.batch_size
        out["chip_demand_images_per_sec"] = demand
        out["loader_vs_demand"] = rate / demand
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
