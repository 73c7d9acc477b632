"""Host images per second of the threaded DataLoader over a real image
list, delivered to the device (counterpart of the repository's
tools_loader_throughput.py): the rate that must exceed the search's
consumption (steps/s x batch size) for the search not to wait on its input.

    python -m tfnas_tpu_torch.tools_loader_throughput --img_root DIR \\
        --list DIR/proxy_train.txt [--val] [--no_native] [--workers 4] \\
        [--batches 40] [--chip_steps_per_sec 5.65] [--device cpu] \\
        [--search_iters 24]

ImageList decodes for the device, as the drivers' lists do: on the card
(the default device) with nvJPEG and the augment kernel
(runtime/card.py); on the CPU with the C++ pipeline where it builds and
with PIL elsewhere. `decoder` in the output says which, and `decoded`
counts the entries by what decoded them (nvJPEG's hardware or default
backend, or PIL for the entries nvJPEG refused). --no_native forces PIL.
Batches go through DevicePrefetcher to the device, as the drivers feed
the card (host batches from pinned buffers on a side stream; card batches
pass through); on the CPU the prefetcher wraps the arrays without a copy.
One batch is loaded before the clock starts (thread pool start, page
cache, the card pipeline's build). The last line is one JSON object.

--search_iters N (on the card, a train list) then feeds the search:
bench.py's schedule (a weight step every iteration, an arch step every
second one; the full-width supernet at this batch size, 100 classes,
bf16), replayed from CUDA graphs, each iteration's batch taken from this
loader through the prefetcher and the on-card normaliser as train_search
takes it, against the same steps fed one synthetic batch the same way:
N iterations each, in turns (loader, synthetic, synthetic, loader), after
warm-up iterations that capture the graphs; then 4 iterations of each
under torch.profiler for the card's busy share of the window and the
augment kernel's device ms in it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
import time

import torch

from .data import DataLoader, DevicePrefetcher, ImageList, device_normalizer
from .device import describe, resolve_device

SEARCH_WARM = 4     # iterations before timing: the graphs' captures
SEARCH_PROFILED = 4


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


def _busy(path):
    """(window ms, busy share, augment kernel ms) of the profiler trace at
    `path`: the union of the device's kernels and copies inside the
    'window' range over its length."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "window")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    dev = sorted((e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e),
        key=lambda e: e["ts"])
    busy, reach, aug = 0.0, t0, 0.0
    for e in dev:
        a, b = max(e["ts"], reach), min(e["ts"] + e["dur"], t1)
        if b > a:
            busy += b - a
        reach = max(reach, e["ts"] + e["dur"])
        if "augment_" in e.get("name", "") and t0 <= e["ts"] < t1:
            aug += e["dur"]
    return (t1 - t0) / 1e3, busy / (t1 - t0), aug / 1e3


def search_feed(ds, args, device):
    """ms per iteration and the card's busy share of bench.py's captured
    search schedule fed from the loader against one synthetic batch (see
    the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .search.compiled import GraphFamily
    from .search.train_step import make_search_steps
    from .tools_setup import search_iter, search_setup

    bs, size = args.batch_size, args.image_size
    net, state, target, gen = search_setup(device, batch=bs, size=size)
    family = GraphFamily(device)
    steps = make_search_steps(net, num_classes=net.num_classes,
                              target_lat=target, family=family)
    st = family.adopt(dict(state))
    prep = device_normalizer(torch.bfloat16)
    dl = DataLoader(ds, bs, shuffle=True, num_workers=args.workers, seed=1)

    def loader_batches():
        for epoch in itertools.count():
            dl.set_epoch(epoch)
            yield from DevicePrefetcher(dl, device)

    g = torch.Generator(device=device).manual_seed(1)
    synth = (torch.randint(0, 256, (bs, size, size, 3), generator=g,
                           device=device, dtype=torch.uint8),
             torch.randint(0, 100, (bs,), generator=g, device=device))
    sources = {"loader": loader_batches(), "synthetic": itertools.repeat(
        synth)}
    count = itertools.count()

    def run(name, n):
        for _ in range(n):
            x, y = next(sources[name])[:2]
            st["x"], st["y"] = prep(x), y
            search_iter(steps, st, gen, next(count))

    for name in sources:
        run(name, SEARCH_WARM)
    torch.cuda.synchronize(device)
    ms = {name: [] for name in sources}
    for name in ("loader", "synthetic", "synthetic", "loader"):
        t = time.perf_counter()
        run(name, args.search_iters)
        torch.cuda.synchronize(device)
        ms[name].append(1e3 * (time.perf_counter() - t) / args.search_iters)
    out = {"iteration_ms": ms, "iterations": args.search_iters}
    with tempfile.TemporaryDirectory() as tmp:
        for name in sources:
            path = os.path.join(tmp, f"{name}.json")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("window"):
                    run(name, SEARCH_PROFILED)
                    torch.cuda.synchronize(device)
            prof.export_chrome_trace(path)
            window, share, aug = _busy(path)
            out[f"{name}_profiled"] = {
                "window_ms_per_iteration": window / SEARCH_PROFILED,
                "busy_share": share,
                "augment_device_ms_per_iteration": aug / SEARCH_PROFILED}
    return out


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
parser.add_argument("--device", type=str, default=None,
                    help="default: the card")
parser.add_argument("--search_iters", type=int, default=0,
                    help="then time the captured search fed from this "
                         "loader against a synthetic batch (on the card)")


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    ds = ImageList(args.img_root, args.list_path, training=not args.val,
                   image_size=args.image_size,
                   use_native=False if args.no_native else "auto",
                   device=device)
    print(f"dataset: {len(ds)} images, decoder={ds.decoder}, "
          f"training={ds.training}", flush=True)
    rate = measure(ds, args.batch_size, args.workers, args.batches, device)
    out = {"metric": "loader_images_per_sec", "value": rate,
           "native": ds.use_native, "decoder": ds.decoder,
           "decoded": dict(ds.decoded), "workers": args.workers,
           "batch_size": args.batch_size, "image_size": args.image_size,
           "training": ds.training, **describe(device)}
    if args.chip_steps_per_sec > 0:
        demand = args.chip_steps_per_sec * args.batch_size
        out["chip_demand_images_per_sec"] = demand
        out["loader_vs_demand"] = rate / demand
    if args.search_iters > 0:
        if device.type != "cuda" or not ds.training:
            raise SystemExit("--search_iters needs the card and a train "
                             "list")
        out["search"] = search_feed(ds, args, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
