"""Learnability probe of the procedural proxy dataset (counterpart of the
repository's tools_proxy_learnability.py).

    python -m tfnas_tpu_torch.tools_proxy_learnability [--version 3]
        [--num_classes 60] [--tasks coarse,fine,full] [--augs center,rrc]
        [--depth_chs 32,64,128,256] [--steps 1200] [--from_disk ROOT]

Before a long search on the proxy set, this tells which link is broken
when a search sits at chance: the task itself, the augmentation, or the
input pipeline. In memory (the default), it renders the proxy images with
dataset/make_proxy_dataset.py's generator (no JPEG, no loader), keeps the
whole set on the device, and trains a tiny CNN (3x3 stride-2 convolutions,
each with batch-statistics BN and ReLU, then global average pooling and a
linear layer; Adam) for each task (full: the label; coarse: label % 5 or
10; fine: label // 5 or 10) and augmentation (center: a centre crop;
rrc: one random square window per batch, area 0.08-1, resized by nearest
neighbour, and a flip per image), reporting val top-1 against chance.
'|' in --depth_chs runs several widths on the same data. --from_disk ROOT
trains the same CNN on batches from the port's real pipeline instead
(ImageList uint8 pixels -> DataLoader -> DevicePrefetcher) over
ROOT/proxy_train.txt and scores ROOT/proxy_val.txt.

The CNN and its Adam step are the JAX tool's (optax.adam ->
torch.optim.Adam, same defaults); the random streams are torch's. The
result is one JSON object (indented, as the JAX tool prints it).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from .data import DataLoader, DevicePrefetcher, ImageList
from .device import resolve_device
from .tools_setup import ROOT


def _render_fns():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from dataset.make_proxy_dataset import render_example, render_example_v3
    return render_example, render_example_v3


def gen_split(n_per_class, num_classes, gen_size, seed, tag, version=2):
    """[N, H, W, 3] uint8 images and labels, deterministic per (seed, tag,
    version)."""
    render_v2, render_v3 = _render_fns()
    render = render_v3 if version == 3 else render_v2
    imgs = np.empty((num_classes * n_per_class, gen_size, gen_size, 3),
                    np.uint8)
    labels = np.empty((num_classes * n_per_class,), np.int64)
    tag_seed = zlib.crc32(tag.encode()) % 2**31
    k = 0
    for label in range(num_classes):
        for i in range(n_per_class):
            rng = np.random.default_rng((seed, label, i, tag_seed, version))
            imgs[k] = render(label, rng, gen_size)
            labels[k] = label
            k += 1
    return imgs, labels


def _same_pad(x, k, stride):
    """TF 'SAME' padding of NCHW x for a k x k window at `stride`."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def build_tiny_cnn(depth_chs=(32, 64, 128, 256)):
    """(init_params, forward) of the probe CNN. Parameters are the JAX
    tool's tree: {"convs": [{"w" [3, 3, cin, ch], "b", "g", "be"}], "wf"
    [cin, num_out], "bf"}; forward takes NHWC uint8 or float pixels and
    normalises them (x / 255 - 0.5) itself."""

    def init_params(generator, num_out, device):
        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device)
        convs, cin = [], 3
        for ch in depth_chs:
            convs.append({"w": normal(3, 3, cin, ch) * math.sqrt(
                2.0 / (9 * cin)), "b": torch.zeros(ch, device=device),
                "g": torch.ones(ch, device=device),
                "be": torch.zeros(ch, device=device)})
            cin = ch
        return {"convs": convs, "wf": normal(cin, num_out) * 0.01,
                "bf": torch.zeros(num_out, device=device)}

    def forward(params, x):
        x = (x.float() / 255.0 - 0.5).permute(0, 3, 1, 2)
        for lyr in params["convs"]:
            x = F.conv2d(_same_pad(x, 3, 2), lyr["w"].permute(3, 2, 0, 1),
                         stride=2)
            m = x.mean((0, 2, 3), keepdim=True)
            v = x.var((0, 2, 3), unbiased=False, keepdim=True)
            x = ((x - m) * torch.rsqrt(v + 1e-5) * lyr["g"][:, None, None]
                 + lyr["be"][:, None, None])
            x = F.relu(x)
        x = x.mean((2, 3))
        return x @ params["wf"] + params["bf"]

    return init_params, forward


def param_list(params):
    return [t for lyr in params["convs"] for t in lyr.values()] + [
        params["wf"], params["bf"]]


def make_step(forward, params, lr):
    """step(x, y) -> loss: one Adam step (optax.adam's defaults) on the
    mean softmax cross-entropy, updating `params` in place."""
    leaves = param_list(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr)

    def step(x, y):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(forward(params, x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def crop_batch(imgs, crop, aug, generator):
    """[B, S, S, 3] -> [B, crop, crop, 3]: the centre crop, or (rrc) one
    random square window per batch (area 0.08-1 of the image, side at
    least 8) resized to crop by nearest neighbour, each image flipped with
    probability 1/2."""
    s = imgs.shape[1]
    dev = imgs.device
    if aug == "center":
        o = (s - crop) // 2
        return imgs[:, o:o + crop, o:o + crop]
    u = torch.rand(3, generator=generator, device=dev)
    area = 0.08 + 0.92 * u[0]
    side = int(torch.clamp(area.sqrt() * s, 8, s))
    offy, offx = (int(v * (s - side + 1)) for v in u[1:])
    pos = ((torch.arange(crop, device=dev) + 0.5) / crop * side).long()
    ys = torch.clamp(pos + offy, 0, s - 1)
    xs = torch.clamp(pos + offx, 0, s - 1)
    out = imgs[:, ys][:, :, xs]
    flip = torch.rand((imgs.shape[0], 1, 1, 1), generator=generator,
                      device=dev) < 0.5
    return torch.where(flip, out.flip(2), out)


def run_from_disk(args, device):
    """The same CNN on batches from the port's image pipeline."""
    root = args.from_disk
    train_ds = ImageList(root, f"{root}/proxy_train.txt", training=True,
                         image_size=args.image_size,
                         rrc_scale=(args.rrc_min_scale, 1.0))
    val_ds = ImageList(root, f"{root}/proxy_val.txt", training=False,
                       image_size=args.image_size)
    tl = DataLoader(train_ds, args.batch_size, shuffle=True, num_workers=1,
                    seed=args.seed)
    vl = DataLoader(val_ds, args.batch_size, shuffle=False, num_workers=1,
                    drop_last=False, pad_last=True)
    init_params, forward = build_tiny_cnn(
        tuple(int(c) for c in args.depth_chs.split(",")))
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    params = init_params(gen, args.num_classes, device)
    step = make_step(forward, params, args.lr)

    t0 = time.time()
    s, epoch, losses = 0, 0, []
    while s < args.steps:
        tl.set_epoch(epoch)
        for x, y in DevicePrefetcher(tl, device):
            loss = step(x, y)
            if s % 50 == 0:
                losses.append(float(loss))
                print(f"[disk/{args.image_size}px/rrc{args.rrc_min_scale}] "
                      f"step {s} loss {losses[-1]:.3f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            s += 1
            if s >= args.steps:
                break
        epoch += 1

    correct, total = 0, 0
    with torch.no_grad():
        for x, y, n_valid in DevicePrefetcher(vl, device):
            ok = forward(params, x).argmax(-1) == y
            correct += int(ok[:n_valid].sum())
            total += int(n_valid)
    acc = correct / max(total, 1)
    print(f"[disk] val top-1 {acc * 100:.1f}% (chance "
          f"{100.0 / args.num_classes:.0f}%) over {total} samples",
          flush=True)
    return {"disk/val_top1": acc, "final_loss": losses[-1],
            "steps": args.steps, "image_size": args.image_size,
            "rrc_min_scale": args.rrc_min_scale}


def probe_tasks(args, device, results, depth_chs, data, n_coarse, n_fine,
                tag_chs):
    tr_xd, tr_y, va_xd, va_y = data
    init_params, forward = build_tiny_cnn(depth_chs)
    for task in args.tasks.split(","):
        if task == "coarse":
            proj, n_out = (lambda y: y % n_coarse), n_coarse
        elif task == "fine":
            proj, n_out = (lambda y: y // n_coarse), n_fine
        else:
            proj, n_out = (lambda y: y), args.num_classes
        tr_yp = torch.from_numpy(proj(tr_y)).to(device)
        va_yp = torch.from_numpy(proj(va_y)).to(device)
        for aug in args.augs.split(","):
            gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            params = init_params(gen, n_out, device)
            step = make_step(forward, params, args.lr)
            chs_s = ",".join(str(c) for c in depth_chs)
            tag = f"{task}/{aug}" + (f"/chs={chs_s}" if tag_chs else "")
            t1 = time.time()
            losses = []
            for s in range(args.steps):
                idx = torch.randint(0, len(tr_xd), (args.batch_size,),
                                    generator=gen, device=device)
                loss = step(crop_batch(tr_xd[idx], args.crop, aug, gen),
                            tr_yp[idx])
                if s % 100 == 0:
                    losses.append(float(loss))
                    print(f"[{tag}] step {s} loss {losses[-1]:.3f}",
                          flush=True)
            correct = 0
            with torch.no_grad():
                for a in range(0, len(va_xd), 250):
                    x = crop_batch(va_xd[a:a + 250], args.crop, "center",
                                   None)
                    correct += int((forward(params, x).argmax(-1)
                                    == va_yp[a:a + 250]).sum())
            acc = correct / len(va_xd)
            chance = 1.0 / n_out
            print(f"[{tag}] val top-1 {acc * 100:.1f}% (chance "
                  f"{chance * 100:.0f}%) in {time.time() - t1:.0f}s",
                  flush=True)
            results[tag] = {"val_top1": acc, "chance": chance,
                            "final_loss": losses[-1], "steps": args.steps}


parser = argparse.ArgumentParser("proxy learnability probe")
parser.add_argument("--train_per_class", type=int, default=60)
parser.add_argument("--val_per_class", type=int, default=15)
parser.add_argument("--num_classes", type=int, default=100)
parser.add_argument("--gen_size", type=int, default=96)
parser.add_argument("--crop", type=int, default=64)
parser.add_argument("--steps", type=int, default=1200)
parser.add_argument("--batch_size", type=int, default=256)
parser.add_argument("--lr", type=float, default=2e-3)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--tasks", default="coarse,fine,full")
parser.add_argument("--augs", default="center,rrc")
parser.add_argument("--json_out", default="")
parser.add_argument("--from_disk", default="",
                    help="dataset root: train the probe on batches from the "
                         "port's image pipeline instead of in-memory "
                         "renders")
parser.add_argument("--image_size", type=int, default=96,
                    help="--from_disk crop size given to ImageList")
parser.add_argument("--rrc_min_scale", type=float, default=0.08)
parser.add_argument("--version", type=int, default=2, choices=(2, 3),
                    help="proxy generator version (3: capacity-graded)")
parser.add_argument("--depth_chs", default="32,64,128,256",
                    help="conv channels of the probe CNN, comma-separated; "
                         "'|' separates settings run on the same data")
parser.add_argument("--device", type=str, default="cuda")


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.from_disk:
        results = run_from_disk(args, device)
    else:
        t0 = time.time()
        tr_x, tr_y = gen_split(args.train_per_class, args.num_classes,
                               args.gen_size, args.seed, "train",
                               args.version)
        va_x, va_y = gen_split(args.val_per_class, args.num_classes,
                               args.gen_size, args.seed, "val", args.version)
        print(f"generated {len(tr_x)} train / {len(va_x)} val "
              f"@{args.gen_size}px in {time.time() - t0:.0f}s", flush=True)
        # the whole set lives on the device; batches are gathered there
        data = (torch.from_numpy(tr_x).to(device), tr_y,
                torch.from_numpy(va_x).to(device), va_y)
        n_coarse = 5 if args.version == 3 else 10
        n_fine = 12 if args.version == 3 else 10
        settings = [tuple(int(c) for c in s.split(","))
                    for s in args.depth_chs.split("|")]
        results = {}
        for depth_chs in settings:
            probe_tasks(args, device, results, depth_chs, data, n_coarse,
                        n_fine, len(settings) > 1)
    print(json.dumps(results, indent=1), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
