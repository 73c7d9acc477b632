#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tfnas_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line as soon as it ends:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the nvcc build of the kernel library (sm_90a).
2. kernel: the hand-written fused depthwise kernel against its plain
   PyTorch version at every (H, C, stride, act) of the search's soft and
   sampled sites at batch 32, in f32 and bf16 (TF32 off): y, the two
   per-channel sums and the four input gradients. Then times at bf16: the
   kernel, the plain version, one depthwise F.conv2d as a library yardstick,
   and the least time the card could take (bytes over 3.35 TB/s).
3. search: the full-width MBConv supernet (batch 32, 224^2, 100 classes,
   bf16 activations, latency_pkl/latency_tpu.pkl) on synthetic data made on
   the card: 2 warmup, 2 bi-sampling weight and 2 arch steps, one
   parse + shrink/expand + mask rewrite, one val step. It checks finite
   losses, frozen masked channels, and exactly 18 kernel launches per
   sampled or soft forward. It writes only into a temporary directory.

The line before the last holds the kernels' summary; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a run without a card, a run without the package beside this file, and
a run past the 10-minute deadline.
"""

import json
import math
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time

DEADLINE_S = 600
BATCH = 32
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
TARGET_LAT = 0.25           # ms, inside latency_tpu.pkl's range


def emit(obj):
    print(json.dumps(obj), flush=True)


def _deadline(signum, frame):
    raise TimeoutError(f"chip_smoke.py passed its {DEADLINE_S} s deadline")


# -- phase 1 ------------------------------------------------------------------

def phase_env(torch, fused_dw):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    fused_dw.build_library()
    wall = time.perf_counter() - t0
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kernel_build_s": round(wall, 3),
          "nvcc_flags": " ".join(fused_dw.NVCC_FLAGS),
          "ptxas": fused_dw.build_info["log"][-800:]})


# -- phase 2 ------------------------------------------------------------------

def main_path_sites(tss):
    """Distinct (H, C, stride, act, path) of the depthwise sites of the
    full search at 224^2: soft width 48 * ic, sampled width 8 * ic."""
    from tfnas_tpu_torch.models.supernet import block_sites
    out = []
    for site in block_sites(tss):
        h = tss.BLOCK_INPUT_RES[site.stage][int(site.block[5:]) - 1]
        for path, c in (("soft", 48 * site.ic), ("sampled", 8 * site.ic)):
            case = (h, c, site.stride, site.act, path)
            if case not in out:
                out.append(case)
    return out


def _inputs(torch, gen, h, c, dtype):
    dev = gen.device
    x = torch.randn((BATCH, h, h, c), generator=gen, device=dev).to(dtype)
    w = torch.randn((5, 5, c), generator=gen, device=dev) * 0.2
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    offset = torch.randn(c, generator=gen, device=dev) * 0.1
    return x, w, scale, offset


def _timed(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(x, w, stride):
    """Least time for the kernel's work: each input read once, each output
    written once, over the memory rate; the 25 multiply-adds per output
    over the f32 rate. Returns (ms, 'bytes' or 'operations')."""
    n, h, wd, c = x.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    out = n * ho * wo * c
    nbytes = (x.numel() * x.element_size() + w.numel() * 4 + 2 * c * 4
              + out * x.element_size() + 2 * c * 4)
    flops = 2 * 25 * out + 4 * x.numel()
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def phase_kernel(torch, fused_dw, tss):
    F = torch.nn.functional
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    failures, per_stride = [], {1: [], 2: []}
    for h, c, stride, act, path in main_path_sites(tss):
        for dtype in (torch.float32, torch.bfloat16):
            bf = dtype == torch.bfloat16
            x, w, scale, offset = _inputs(torch, gen, h, c, dtype)
            args = [t.clone().requires_grad_() for t in (x, w, scale, offset)]
            got = fused_dw.fused_dw_norm_act(*args, stride, act)
            ref_args = [t.clone().requires_grad_()
                        for t in (x, w, scale, offset)]
            want = fused_dw.fused_dw_plain(*ref_args, stride, act)
            # one loss through both: random weights on y and on the sums
            ry = torch.randn(want[0].shape, generator=gen, device="cuda")
            rs = torch.randn(c, generator=gen, device="cuda")
            rq = torch.randn(c, generator=gen, device="cuda") * 1e-3
            for (y, s, q), a in ((got, args), (want, ref_args)):
                ((y.float() * ry).sum() + (s * rs).sum()
                 + (q * rq).sum()).backward()
            yf = want[0].float()
            err_y = (got[0].float() - yf).abs().max().item()
            tol_y = (2e-2 if bf else 2e-4) * max(1.0, yf.abs().max().item())
            # sums: the kernel sums its f32 accumulator, the plain version
            # the rounded y (bf16: up to 2^-8 of sum |y| apart)
            rel = 2 ** -7 if bf else 1e-5
            err_s = ((got[1] - want[1]).abs()
                     / (rel * yf.abs().sum((0, 1, 2)) + 1e-3)).max().item()
            err_q = ((got[2] - want[2]).abs()
                     / (rel * (yf * yf).sum((0, 1, 2)) + 1e-3)).max().item()
            grad_errs = [((a.grad - b.grad).abs().max()
                          / b.grad.abs().max().clamp_min(1e-12)).item()
                         for a, b in zip(args, ref_args)]
            tol_g = 2e-2 if bf else 1e-3
            ok = (err_y <= tol_y and err_s <= 1.0 and err_q <= 1.0
                  and max(grad_errs) <= tol_g
                  and all(math.isfinite(e) for e in grad_errs))
            case = {"phase": "kernel", "h": h, "c": c, "stride": stride,
                    "act": act, "path": path,
                    "dtype": "bf16" if bf else "f32",
                    "max_abs_err_y": err_y, "tol_y": tol_y,
                    "sum_err_over_tol": err_s, "sumsq_err_over_tol": err_q,
                    "grad_rel_errs_x_w_scale_offset": grad_errs,
                    "tol_grad": tol_g, "ok": ok}
            emit(case)
            if not ok:
                failures.append(case)
            if bf:
                per_stride[stride].append((h, c, err_y))
            del args, ref_args, got, want, ry
    torch.backends.cudnn.allow_tf32 = True
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version in "
                             f"{len(failures)} cases")

    # times at bf16, the search's activation dtype
    times = {}
    for h, c, stride, act, path in main_path_sites(tss):
        x, w, scale, offset = _inputs(torch, gen, h, c, torch.bfloat16)
        x1 = fused_dw._elementwise(x, scale, offset, act).permute(0, 3, 1, 2)
        wk = fused_dw._dw_weight(w, x.dtype)
        with torch.no_grad():
            t_k = _timed(torch, lambda: fused_dw.fused_dw_cuda(
                x, w, scale, offset, stride, act))
            t_p = _timed(torch, lambda: fused_dw.fused_dw_plain(
                x, w, scale, offset, stride, act))
            t_l = _timed(torch, lambda: F.conv2d(x1, wk, None, stride, 2, 1,
                                                 c))
        bound_ms, bound_by = _bound(x, w, stride)
        row = {"phase": "kernel_time", "h": h, "c": c, "stride": stride,
               "act": act, "path": path, "dtype": "bf16", "ms": t_k,
               "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound_ms,
               "bound_by": bound_by}
        emit(row)
        times[(h, c, stride)] = row
        del x, x1
    return per_stride, times


# -- phase 3 ------------------------------------------------------------------

def phase_search(torch, fused_dw, tmpdir):
    from tfnas_tpu_torch.cost.lut import lat_vectors_for_mc, load_lat_lookup
    from tfnas_tpu_torch.data.synthetic import device_batches
    from tfnas_tpu_torch.models import search_space as ss
    from tfnas_tpu_torch.models.supernet import SuperNetwork
    from tfnas_tpu_torch.search.bisample import (gumbel_uniform,
                                                 sample_gumbel_indices,
                                                 sample_random_excluding)
    from tfnas_tpu_torch.search.elasticity import (rewrite_masks_by_l1,
                                                   shrink_or_expand)
    from tfnas_tpu_torch.search.parser import (get_mc_num_dddict,
                                               get_op_and_depth_weights,
                                               parse_architecture)
    from tfnas_tpu_torch.search.train_step import (adam_init,
                                                   make_search_steps,
                                                   tree_leaves,
                                                   zeros_like_tree)
    from tfnas_tpu_torch.utils.checkpoint import to_numpy_tree

    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    lut = load_lat_lookup(os.path.join(here, "latency_pkl",
                                       "latency_tpu.pkl"))
    net = SuperNetwork(100)
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    params, arch = net.init(gen)
    mc_mask = ss.build_mc_mask_dddict()
    masks = net.device_masks(mc_mask, dev)
    umasks = net.update_masks(params, mc_mask)
    lat_vec = torch.from_numpy(lat_vectors_for_mc(
        lut, get_mc_num_dddict(mc_mask))).to(dev)
    steps = make_search_steps(net, num_classes=100, lambda_lat=0.1,
                              target_lat=TARGET_LAT)
    data = device_batches(BATCH, 7, gen, 100, 224, torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "search_setup", "init_s": time.perf_counter() - t0,
          "params_M": sum(p.numel() for p in tree_leaves(params)) / 1e6})

    frozen0 = {(s, b): {k: params[s][b][k]["kernel"].clone()
                        for k in ("expand", "depth", "project")}
               for s in ss.STAGE_NAMES for b in params[s]}
    mom, opt_a = zeros_like_tree(params), adam_init(arch)
    lr, T = 0.025, 5.0
    fused_dw.reset_launches()  # every count at 0 before the main path

    def run(name, expect, fn):
        before = sum(fused_dw.launches.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        launched = sum(fused_dw.launches.values()) - before
        loss = float(out["loss"] if "loss" in out else out["loss_a"])
        emit({"phase": "search", "step": name, "ms": ms, "loss": loss,
              "kernel_launches": launched, "expected": expect,
              "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
        if launched != expect:
            raise AssertionError(f"{name}: {launched} kernel launches, "
                                 f"expected {expect}")
        if not math.isfinite(loss):
            raise AssertionError(f"{name}: loss {loss}")

    for i in range(2):
        x, y = next(data)
        idx = sample_gumbel_indices(arch["log_alphas"], gen)

        def warm():
            nonlocal params, mom
            params, mom, m = steps.warmup_step(params, arch, mom, masks,
                                               umasks, x, y, lr, idx)
            return m
        run(f"warmup{i}", 18, warm)
    for i in range(2):
        x, y = next(data)
        ig = sample_gumbel_indices(arch["log_alphas"], gen)
        ir = sample_random_excluding(ig, 8, gen)

        def weight():
            nonlocal params, mom
            params, mom, m = steps.weight_step(params, arch, mom, masks,
                                               umasks, x, y, lr, ig, ir)
            return m
        run(f"weight{i}", 36, weight)
    for i in range(2):
        x, y = next(data)
        u = gumbel_uniform(arch["log_alphas"].shape, gen)

        def arch_step():
            nonlocal arch, opt_a
            arch, opt_a, m = steps.arch_step(params, arch, opt_a, masks, x,
                                             y, lat_vec, lut["base"], T, u)
            return m
        run(f"arch{i}", 18, arch_step)

    # masked-out and padded entries never moved; padding is still zero
    for (s, b), kernels in frozen0.items():
        for k, old in kernels.items():
            um = umasks[s][b][k]["kernel"].expand_as(old) == 0
            new = params[s][b][k]["kernel"]
            if not torch.equal(new[um], old[um]):
                raise AssertionError(f"{s}/{b}/{k}: masked entries moved")
    pad = params["stage1"]["block1"]["depth"]["kernel"][0, 16 * 4:]
    if pad.numel() == 0 or pad.abs().max().item() != 0.0:
        raise AssertionError("e3 padding of stage1/block1 is not zero")

    t = time.perf_counter()
    op_w, depth_w = get_op_and_depth_weights(
        {"arch_params": to_numpy_tree(arch)})
    parsed = parse_architecture(op_w, depth_w)
    mc_num, before_lat, after_lat = shrink_or_expand(
        parsed, get_mc_num_dddict(mc_mask),
        get_mc_num_dddict(mc_mask, is_max=True), ss.lat_lookup_key_dddict,
        lut, TARGET_LAT)
    mc_mask = rewrite_masks_by_l1(parsed, mc_num, mc_mask, params)
    path = os.path.join(tmpdir, "arch_params_01.pkl")
    with open(path, "wb") as f:
        pickle.dump({"arch_params": to_numpy_tree(arch),
                     "mc_mask_dddict": mc_mask, "epoch": 1, "T": T}, f)
    reparsed = parse_architecture(*get_op_and_depth_weights(path))
    if reparsed != parsed:
        raise AssertionError("arch_params pickle does not parse back")
    emit({"phase": "search", "step": "parse_shrink_rewrite",
          "ms": 1e3 * (time.perf_counter() - t), "parsed": {
              s: list(d.values()) for s, d in parsed.items()},
          "lat_before": before_lat, "lat_after": after_lat})

    masks = net.device_masks(mc_mask, dev)
    x, y = next(data)
    idx = sample_gumbel_indices(arch["log_alphas"], gen)
    run("val", 18, lambda: steps.val_step(params, arch, masks, x, y, idx))
    return dict(fused_dw.launches)


def main():
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from tfnas_tpu_torch.kernels import fused_dw
    from tfnas_tpu_torch.models import search_space as tss

    t_start = time.perf_counter()
    phase_env(torch, fused_dw)
    per_stride, times = phase_kernel(torch, fused_dw, tss)
    with tempfile.TemporaryDirectory() as tmpdir:
        launches = phase_search(torch, fused_dw, tmpdir)
    for stride, n in launches.items():
        if n == 0:
            raise AssertionError(f"stride-{stride} kernel never launched on "
                                 f"the main path")

    kernels = []
    for stride, name, replaces in (
            (1, "fused_dw_norm_act stride 1",
             "tfnas_tpu/kernels/fused_dw.py:76 (_kernel, launched at :304)"),
            (2, "fused_dw_norm_act stride 2",
             "tfnas_tpu/kernels/fused_dw.py:132 (_kernel_s2, launched at "
             ":245)")):
        # headline shape: the largest site of this stride on the main path
        h, c, _ = max(times, key=lambda k: (k[2] == stride,
                                            k[0] * k[0] * k[1]))
        row = times[(h, c, stride)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tfnas_tpu_torch/csrc/fused_dw.cu",
            "replaces": replaces, "launches": launches[stride],
            "max_abs_err": max(e for _, _, e in per_stride[stride]),
            "shape": [BATCH, h, h, c], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
