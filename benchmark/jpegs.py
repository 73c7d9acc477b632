"""The retrain cell's JPEG set: a frozen copy of the v2 renderer of
dataset/make_proxy_dataset.py (a compositional texture task: the class is
the texture inside a minority figure region, colours carry nothing), made
once per checkout from a fixed seed into a directory of its own.

    make_set(out_dir, spec) -> the list file's path

spec: {"seed", "classes", "per_class", "min_size", "max_size", "quality",
"list_repeats", "workers"}. Each image's size is drawn in [min_size,
max_size]; the list file names every image `list_repeats` times, so that an
epoch of the loader lasts longer than a run's window. `workers` processes
render it into a sibling directory, which is renamed into place when
complete.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np

N_FINE = 10
N_COARSE = 10


def _coords(size, rng, jitter=0.05):
    """Image-plane coordinates with a small per-image rotation jitter."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    a = rng.normal(0.0, jitter)
    ca, sa = np.cos(a), np.sin(a)
    return ca * xx + sa * yy, -sa * xx + ca * yy


def fine_field(kind, size, rng):
    """Binary [size,size] float32 field for fine-texture identity `kind`.

    All 10 kinds are distinguishable by SHAPE under horizontal flip and
    ~3.5x scale jitter (RandomResizedCrop area 0.08-1.0): orientation
    classes are {0deg, 90deg, one diagonal}, plus checker/ring/blob/grid/
    zigzag/dot families. Frequency itself is NOT a class cue.
    """
    x, y = _coords(size, rng)
    f = 9.0 * rng.uniform(0.88, 1.15)
    ph = rng.uniform(0, 2 * np.pi)
    if kind == 0:    # horizontal stripes
        return (np.sin(2 * np.pi * f * y + ph) > 0).astype(np.float32)
    if kind == 1:    # vertical stripes
        return (np.sin(2 * np.pi * f * x + ph) > 0).astype(np.float32)
    if kind == 2:    # diagonal stripes (45deg; hflip maps to 135 — one class)
        return (np.sin(2 * np.pi * f * (x + y) * 0.7071 + ph) > 0).astype(np.float32)
    if kind == 3:    # axis-aligned checker
        return (((np.floor(f * x + ph / 6) + np.floor(f * y)) % 2)).astype(np.float32)
    if kind == 4:    # diagonal checker
        u, v = (x + y) * 0.7071, (x - y) * 0.7071
        return (((np.floor(f * u + ph / 6) + np.floor(f * v)) % 2)).astype(np.float32)
    if kind == 5:    # fine concentric rings, random center
        cx, cy = rng.uniform(0.25, 0.75, 2)
        r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        return (np.sin(2 * np.pi * f * r + ph) > 0).astype(np.float32)
    if kind == 6:    # smooth blobs
        field = (np.sin(2 * np.pi * f * x + ph)
                 + np.sin(2 * np.pi * f * 0.73 * y + 1.7 * ph))
        return (field > 0.0).astype(np.float32)
    if kind == 7:    # thin grid lines (not checker: line skeleton, low duty)
        gx = (f * x + ph / 6) % 1.0 < 0.28
        gy = (f * y) % 1.0 < 0.28
        return (gx | gy).astype(np.float32)
    if kind == 8:    # zigzag / chevron stripes
        tri = 2.0 * np.abs(((0.5 * f * y) % 1.0) - 0.5)
        return (np.sin(2 * np.pi * f * x + 2.6 * np.pi * tri + ph) > 0).astype(np.float32)
    # kind == 9: dot lattice (small discs, low duty — distinct from blobs)
    dx = ((f * x + ph / 6) % 1.0) - 0.5
    dy = ((f * y) % 1.0) - 0.5
    return (np.sqrt(dx * dx + dy * dy) < 0.29).astype(np.float32)


def coarse_mask(kind, size, rng):
    """Binary [size,size] float32 mask for coarse-structure identity `kind`.

    The `1` region is the minority "figure" (~35% area) so figure/ground is
    unambiguous even for periodic patterns. Low frequency (~2.5 cycles) so
    any RandomResizedCrop window contains both regions.
    """
    x, y = _coords(size, rng)
    f = 2.5 * rng.uniform(0.85, 1.2)
    ph = rng.uniform(0, 2 * np.pi)
    duty = 0.35            # figure fraction
    thr = np.cos(np.pi * duty)   # sin(t) > thr on `duty` of each period
    if kind == 0:    # horizontal bands (narrow band = figure)
        return (np.sin(2 * np.pi * f * y + ph) > thr).astype(np.float32)
    if kind == 1:    # vertical bands
        return (np.sin(2 * np.pi * f * x + ph) > thr).astype(np.float32)
    if kind == 2:    # diagonal bands
        return (np.sin(2 * np.pi * f * (x + y) * 0.7071 + ph) > thr).astype(np.float32)
    if kind == 3:    # square islands on a grid (asymmetric checker)
        sx = ((f * x + ph / 6) % 1.0) < 0.59
        sy = ((f * y) % 1.0) < 0.59
        return (sx & sy).astype(np.float32)
    if kind == 4:    # coarse concentric rings, near-central
        cx, cy = rng.uniform(0.4, 0.6, 2)
        r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        return (np.sin(2 * np.pi * f * r + ph) > thr).astype(np.float32)
    if kind == 5:    # pinwheel wedges (6 sectors, narrow sector = figure)
        cx, cy = rng.uniform(0.4, 0.6, 2)
        th = np.arctan2(y - cy, x - cx)
        return (np.sin(3.0 * th + ph) > thr).astype(np.float32)
    if kind == 6:    # coarse blobs
        field = (np.sin(2 * np.pi * f * x + ph)
                 + np.sin(2 * np.pi * f * 0.73 * y + 1.7 * ph))
        return (field > 0.9).astype(np.float32)
    if kind == 7:    # diamond islands (diagonal lattice of squares)
        u, v = (x + y) * 0.7071, (x - y) * 0.7071
        su = ((f * u + ph / 6) % 1.0) < 0.59
        sv = ((f * v) % 1.0) < 0.59
        return (su & sv).astype(np.float32)
    if kind == 8:    # thick grid bands (cross lattice)
        gx = ((f * x + ph / 6) % 1.0) < 0.19
        gy = ((f * y) % 1.0) < 0.19
        return (gx | gy).astype(np.float32)
    # kind == 9: big discs on a lattice
    dx = ((f * x + ph / 6) % 1.0) - 0.5
    dy = ((f * y) % 1.0) - 0.5
    return (np.sqrt(dx * dx + dy * dy) < 0.335).astype(np.float32)


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    fr = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * fr), v * (1 - s * (1 - fr))
    i = int(i) % 6
    return [(v, t, p), (q, v, p), (p, v, t),
            (t, p, v), (p, q, v), (v, p, q)][i]


def _color_pair(rng):
    """One light + one dark random-hue color (keeps the pattern visible
    regardless of hue); order randomized so light/dark carries no signal."""
    light = np.asarray(_hsv_to_rgb(rng.uniform(0, 1), rng.uniform(0.3, 0.9),
                                   rng.uniform(0.65, 0.95)), np.float32)
    dark = np.asarray(_hsv_to_rgb(rng.uniform(0, 1), rng.uniform(0.3, 0.9),
                                  rng.uniform(0.15, 0.5)), np.float32)
    return (light, dark) if rng.uniform() < 0.5 else (dark, light)


def render_example(label, rng, size):
    """One [size,size,3] uint8 image of class `label` (= 10*fine + coarse)."""
    fine_id, coarse_id = label // N_COARSE, label % N_COARSE
    # per-image distractor texture != the class texture
    distractor = int(rng.integers(N_FINE - 1))
    if distractor >= fine_id:
        distractor += 1

    mask = coarse_mask(coarse_id, size, rng)[..., None]
    tex_fig = fine_field(fine_id, size, rng)[..., None]
    tex_gnd = fine_field(distractor, size, rng)[..., None]

    c1f, c2f = _color_pair(rng)
    c1g, c2g = _color_pair(rng)
    fig = tex_fig * c1f + (1 - tex_fig) * c2f
    gnd = tex_gnd * c1g + (1 - tex_gnd) * c2g
    img = mask * fig + (1 - mask) * gnd

    img = img + rng.normal(0, rng.uniform(0.02, 0.06),
                           img.shape).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cx, cy = rng.uniform(0.3, 0.7, 2)
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    img = img * (1.0 - rng.uniform(0.0, 0.25) * d2)[..., None]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def render_part(out_dir, spec, part, parts):
    """Write the images of every `parts`-th job starting at `part`."""
    from PIL import Image
    for j, (rel, label, i) in enumerate(jobs(spec)):
        if j % parts != part:
            continue
        rng = np.random.default_rng((spec["seed"], label, i, 2))
        size = int(rng.integers(spec["min_size"], spec["max_size"] + 1))
        img = render_example(label, rng, size)
        Image.fromarray(img).save(os.path.join(out_dir, rel),
                                  quality=spec["quality"])


def jobs(spec):
    return [(f"class_{label:03d}/img_{i:05d}.jpg", label, i)
            for label in range(spec["classes"])
            for i in range(spec["per_class"])]


def make_set(out_dir, spec):
    """The set under out_dir (made when missing, by `workers` processes
    that this call starts and waits for); returns the list path."""
    lst = os.path.join(out_dir, "train.txt")
    if os.path.exists(lst):
        return lst
    tmp = out_dir + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    for label in range(spec["classes"]):
        os.makedirs(os.path.join(tmp, f"class_{label:03d}"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n = spec["workers"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.jpegs", tmp, json.dumps(spec),
         str(k), str(n)], cwd=root) for k in range(n)]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise RuntimeError(f"rendering the JPEG set failed: {codes}")
    lines = [f"{rel} {label}" for rel, label, _ in jobs(spec)]
    with open(os.path.join(tmp, "train.txt"), "w") as f:
        f.write("\n".join(lines * spec["list_repeats"]) + "\n")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.replace(tmp, out_dir)
    return lst


if __name__ == "__main__":
    render_part(sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3]),
                int(sys.argv[4]))
