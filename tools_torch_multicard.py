#!/usr/bin/env python3
"""The port's data-parallel drivers on several cards, launched by torchrun
(NCCL), each held against a reference run:

    python3 tools_torch_multicard.py [--nproc 2] \
        [--runs pareto_dp,pareto_tiny,pareto_groups,dp_step]

1. pareto_dp: `train_search_pareto` with one target, one group
   data-parallel over the cards (cross-replica BN and the gradient
   all-reduce inside the captured steps), bf16, a group batch of 32 at
   full width: captured against --eager on the same cards (the same
   bytes);
2. pareto_tiny: the same search on the tiny space (32^2, 10 classes, a
   group batch of 8) in f32, on the cards against one card (every float
   within TOL). The tiny space, as full width in f32 would carry the
   amplified rounding that dp_step describes;
3. pareto_groups: two targets in bf16, one group per card, against the
   two groups in turn on one card (the same bytes: each group's work is
   the same);
4. dp_step: one data-parallel train step of TF-NAS-A
   (configs/tfnas_a_tpu.config, 1000 classes, 224^2) at a global batch of
   32 in float64, parameters included, on the cards against one card:
   every float within F64_TOL. The step is that of `train_eval`
   (parallel/train_dp.py); float64 because in f32 this network's
   first-layer gradients carry the rounding of the reduction order
   amplified (on the CPU, 2 ranks of `train_eval` against one process
   are 0.026 apart after 2 f32 steps at a global batch of 16, this step
   1.3e-8: the gradient mean goes through an f32 buffer), so only
   float64 can tell a fault from it.

Every process runs with TF32 off and deterministic cuDNN. TOL: a float
leaf's largest |difference| is at most 1e-4 * max(1, its largest
|value|); F64_TOL the same with 1e-6; the integer leaves (widths,
epochs) are equal. Each run prints one JSON line: wall
seconds (process start and the host's synthetic batches included) and per
pickle its difference from its reference (bytes identical, the largest
|difference| of its floats, the leaf where it lies, that leaf's largest
|value|) and the verdict. Exits 1 when a verdict fails. Writes under
build/multicard (ignored by git) and deletes its run directories at the
end.
"""

import argparse
import glob
import importlib
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "multicard")
TOL = 1e-4
F64_TOL = 1e-6
# what a child process runs, a driver module or DP_STEP (set by `run`)
CHILD = "MULTICARD_DRIVER"
SEARCH = ["--synthetic", "--epochs", "2", "--warmup_epochs", "1",
          "--steps_per_epoch", "4", "--print_freq", "2", "--lookup_path",
          os.path.join(HERE, "latency_pkl", "latency_h100.pkl")]
TINY = ["--synthetic", "--space", "tiny", "--image_size", "32",
        "--num_classes", "10", "--epochs", "2", "--warmup_epochs", "1",
        "--steps_per_epoch", "4", "--print_freq", "2", "--target_lats",
        "0.04", "--batch_size", "8", "--no_bf16"]
DP_STEP = "dp_step"  # the CHILD value of the float64 step check


def dp_step(argv):
    """One float64 data-parallel train step of TF-NAS-A on this rank's
    rows of a seeded global batch; rank 0 pickles the state to
    <--save>/run/step.pkl."""
    import torch
    import torch.distributed as dist

    from tfnas_tpu_torch.convert import params_to_jax
    from tfnas_tpu_torch.device import resolve_device
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.parallel import train_dp
    from tfnas_tpu_torch.parallel.mesh import (local_device,
                                               maybe_distributed_init)
    from tfnas_tpu_torch.search.train_step import tree_map

    ap = argparse.ArgumentParser()
    ap.add_argument("--save", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--image_size", type=int, default=224)
    args = ap.parse_args(argv)
    dev = local_device(resolve_device(args.device))
    rank, world = maybe_distributed_init(dev)
    with open(os.path.join(HERE, "configs", "tfnas_a_tpu.config")) as f:
        net = EvalNetwork.from_config(1000, json.load(f))
    params, bn = (tree_map(lambda a: a.to(dev, torch.float64), t)
                  for t in net.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    n, b = args.image_size, args.batch_size // world
    x = rng.standard_normal((args.batch_size, n, n, 3))[rank * b:][:b]
    y = rng.integers(0, 1000, args.batch_size)[rank * b:][:b]
    train, _ = train_dp.make_eval_steps(
        net, num_classes=1000, compute_dtype=torch.float64,
        group=dist.group.WORLD if world > 1 else None)
    momentum = tree_map(torch.zeros_like, params)
    state, _ = train(train_dp.EvalTrainState(params, bn, momentum, 0),
                     torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                     torch.tensor(0.2, dtype=torch.float64, device=dev))
    if rank == 0:
        os.makedirs(os.path.join(args.save, "run"))
        with open(os.path.join(args.save, "run", "step.pkl"), "wb") as f:
            pickle.dump({"params": params_to_jax(state.params),
                         "momentum": params_to_jax(state.momentum),
                         "bn_state": tree_map(lambda a: a.cpu().numpy(),
                                              state.bn_state)}, f)


def child():
    """The driver (or the step check) in this process, with strict f32
    math."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if os.environ[CHILD] == DP_STEP:
        return dp_step(sys.argv[1:])
    importlib.import_module(os.environ[CHILD]).main(sys.argv[1:])


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(nproc, module, argv, name):
    """`module` on `nproc` ranks (torchrun) or one process (nproc 0), its
    run directory under OUT/name; returns (run directory, wall seconds).
    Raises with the log's end when it fails."""
    cmd = [sys.executable]
    if nproc:
        cmd += ["-m", "torch.distributed.run", "--nnodes", "1",
                "--nproc_per_node", str(nproc), "--master_addr", "localhost",
                "--master_port", str(free_port())]
    cmd += [os.path.abspath(__file__)] + argv + [
        "--save", os.path.join(OUT, name)]
    log = os.path.join(OUT, f"{name}.log")
    t = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(cmd, cwd=HERE, stdout=f, timeout=300,
                              stderr=subprocess.STDOUT,
                              env=dict(os.environ, **{CHILD: module}))
    if proc.returncode:
        with open(log) as f:
            raise RuntimeError(f"{module} on {nproc} ranks failed:\n"
                               f"{f.read()[-4000:]}")
    (run_dir,) = glob.glob(os.path.join(OUT, name, "*"))
    return run_dir, time.perf_counter() - t


def leaf_diffs(a, b, path="", tol=TOL):
    """[(path, max |a - b|, max |b|, within tol)] over the array and
    number leaves (exact for integers)."""
    if isinstance(a, dict):
        return [d for k in sorted(b) for d in leaf_diffs(a[k], b[k],
                                                         f"{path}/{k}", tol)]
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return [(path, float("inf"), 0.0, False)]
    if not a.size or a.dtype.kind not in "fiub":
        return [(path, 0.0, 0.0, bool(np.array_equal(a, b)))]
    d = float(np.abs(a.astype(np.float64) - b).max())
    ref = float(np.abs(b.astype(np.float64)).max())
    ok = d <= tol * max(1.0, ref) if a.dtype.kind == "f" else d == 0.0
    return [(path, d, ref, ok)]


def compare(dir_a, dir_b, exact, tol=TOL):
    """{pickle: {same_bytes, max_abs_diff, leaf, leaf_max_abs, ok}}: ok is
    identical bytes when `exact`, else every leaf within tol."""
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(dir_b, "*.pkl")))
    out = {}
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            ba, bb = fa.read(), fb.read()
        diffs = leaf_diffs(pickle.loads(ba), pickle.loads(bb), tol=tol)
        leaf, d, ref, _ = max(diffs, key=lambda t: t[1])
        out[name] = {"same_bytes": ba == bb, "max_abs_diff": d,
                     "leaf": leaf, "leaf_max_abs": ref,
                     "ok": ba == bb if exact else all(t[3] for t in diffs)}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--runs",
                    default="pareto_dp,pareto_tiny,pareto_groups,dp_step",
                    help="which of the four runs, comma-separated")
    args = ap.parse_args()
    runs, n = args.runs.split(","), args.nproc
    os.makedirs(OUT, exist_ok=True)
    verdicts = []

    def emit(rec, **comparisons):
        rec.update(cards=n, **comparisons)
        rec["ok"] = bool(comparisons) and all(
            v["ok"] for c in comparisons.values() for v in c.values())
        verdicts.append(rec["ok"])
        print(json.dumps(rec), flush=True)

    mod = "tfnas_tpu_torch.train_search_pareto"
    if "pareto_dp" in runs:
        dp = SEARCH + ["--target_lats", "4.5", "--batch_size", "32"]
        cap, s_cap = run(n, mod, dp, "dp_captured")
        eag, s_eag = run(n, mod, dp + ["--eager"], "dp_eager")
        emit({"run": "pareto_dp", "group_batch": 32, "dtype": "bf16",
              "seconds": {"captured": s_cap, "eager": s_eag}},
             captured_vs_eager=compare(cap, eag, exact=True))

    if "pareto_tiny" in runs:
        cards, s_cards = run(n, mod, TINY, "tiny_cards")
        one, s_one = run(0, mod, TINY, "tiny_one")
        emit({"run": "pareto_tiny", "group_batch": 8, "dtype": "f32",
              "seconds": {"cards": s_cards, "one": s_one}},
             cards_vs_one_card=compare(cards, one, exact=False))

    if "pareto_groups" in runs:
        groups = SEARCH + ["--target_lats", "4.5,6.0", "--batch_size", "32"]
        cards, s_cards = run(2, mod, groups, "groups_cards")
        one, s_one = run(0, mod, groups, "groups_one")
        emit({"run": "pareto_groups", "ranks": 2, "dtype": "bf16",
              "seconds": {"cards": s_cards, "one": s_one}},
             cards_vs_one_card=compare(cards, one, exact=True))

    if "dp_step" in runs:
        cards, s_cards = run(n, DP_STEP, [], "step_cards")
        one, s_one = run(0, DP_STEP, [], "step_one")
        emit({"run": "dp_step", "dtype": "f64", "global_batch": 32,
              "seconds": {"cards": s_cards, "one": s_one}},
             cards_vs_one_card=compare(cards, one, exact=False,
                                       tol=F64_TOL))
    for p in glob.glob(os.path.join(OUT, "*")):
        if os.path.isdir(p):
            shutil.rmtree(p)
    return 0 if verdicts and all(verdicts) else 1


if __name__ == "__main__":
    sys.exit(child() if os.environ.get(CHILD) else main())
