#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tfnas_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line as soon as it ends:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions, the nvcc builds (sm_90a) of the three libraries, one nvcc
   each, started together: the fused depthwise kernel, the card image
   pipeline (nvJPEG decode and the augment kernel) and the fused
   epilogue; nvJPEG's version and
   whether its hardware backend opens; and what the host offers the port:
   g++ and libjpeg's header (`gxx`, `jpeglib_h`: the C++ image pipeline),
   and whether PIL and triton import (`pil`, `triton`: each one's
   version, or false).
2. kernel: the hand-written fused depthwise kernel against its plain
   PyTorch version at every (H, C, stride, act) of the search's soft and
   sampled sites at batch 32, and at ragged edge shapes (N 1 and 3, H and
   W 1 to 57, C not a multiple of the copy width) at both strides and
   both activations, in f32 and bf16 (TF32 off): y, the two per-channel
   sums and the four input gradients, and bit-identical sums over two
   runs. Then times at bf16, each site: `ms` (CUDA events around 20
   back-to-back Python calls: device and host time, whichever is longer),
   `device_ms` (events around the replay of a CUDA graph of the 20 calls:
   device time alone), `cold_ms` (events around each of 10 calls, a
   128 MB buffer written before each: cold L2) and `host_us` (host clock
   per call, enqueue only), for the kernel and for one depthwise F.conv2d
   as a library yardstick (`library_*`); the plain version's `plain_ms`;
   and the least time the card could take (`bound_ms`). Then the fused
   epilogue kernel (kernels/bias_act.py) against its plain version at the
   served net's sites (EPILOGUE_SITES: 112^2 x 32 and 48, 56^2 x 144,
   7^2 x 1152 and 192 with a residual, the SE gate, [32, 1152] and
   [32, 1000] rows), its bias f32 and bf16, within one bf16 ulp and a
   rerun bit for bit, and its times at each site the same ways (`epilogue`
   lines).
3. search: the full-width MBConv supernet (batch 32, 224^2, 100 classes,
   bf16 activations, latency_pkl/latency_tpu.pkl) on synthetic data made on
   the card: 2 warmup, 2 bi-sampling weight and 2 arch steps (eager), one
   parse + shrink/expand + mask rewrite, one val step. It checks finite
   losses, frozen masked channels, and exactly 18 kernel launches per
   sampled or soft forward. It writes only into a temporary directory.
4. profile: torch.profiler over one more steady weight step and one arch
   step: for each, the device busy share of the step's window, the fused
   kernel's device time and share, the 10 device kernels with the most
   time, and the kernels launched next to the fused one (a copy or
   transpose there would mean the NHWC hand-over is not free). The
   search's state is then saved as searched_model_01.pkl in the driver's
   format.
5. capture: the same net's warmup, weight and arch steps replayed from CUDA
   graphs (search/compiled.py) against the eager steps from the same state,
   inputs and draws, with cuDNN deterministic (bit for bit, else 1e-5);
   both kernel strides among each graph's nodes (counted at capture) and
   in the device time of a profiled captured weight and arch step; graph
   build seconds and peak memory; eager and captured ms per step kind in
   turns; the scanned iteration of K = 2 units over the captured weight
   and arch steps against its eager loop (same generator seed: equal
   draws).
6. driver: `train_search` at full width on synthetic data, --scan_units 2,
   3 epochs of 8 batches (one warmup; the second ends with shrink/expand,
   the third steps on the rewritten masks), from CUDA graphs and with
   --eager: every arch_params_NN.pkl and the final supernet agree (1e-5).
7. lut: `make_lat_lut --mode measure` on its first two keys (a table that
   load_lat_lookup reads, monotone); one block's chain time against the
   profiler's device time for the same launches (not below it by more than
   5%) beside the empty chain's time; --print_lat's measurement on
   TF-NAS-A at batch 32 and 1.
8. eval: search -> parse -> retrain -> test -> fold on the card. The
   port's parsing_model writes model.config from that checkpoint and
   EvalNetwork.from_config builds it. TF-NAS-A (configs/tfnas_a_tpu.config,
   1000 classes, 224^2) takes EVAL_STEPS timed train steps at batch 256,
   bf16, on synthetic uint8 batches through the prefetcher and the on-card
   normaliser, with the lr of cosine_lr_with_warmup (step ms from the
   second step, loss, peak memory), and one more under torch.profiler
   (busy share, top kernels); the parsed net takes two. Each writes
   an eval checkpoint that must read back exactly. test.py's validation
   (f32) scores 1000 images at batch 256, the last batch padded, and must
   equal the same images scored unpadded (1e-4). BN folding and the
   space-to-depth stem must equal the unfolded forward: f32 with TF32 off
   within 1e-4 x max|logit|, bf16 within 2e-2 x max|logit|; then bf16
   inference images/s of the unfolded, folded and s2d nets at batch 256
   (CUDA events, in turns); the folded bf16 forward replayed from a CUDA
   graph (search/compiled.py), whose fused epilogue nodes must number the
   net's epilogue sites with none left unfused (`epilogue` in the fold
   line). The eval path launches no fused depthwise kernel: its depthwise
   convolutions are cuDNN's, as they are XLA's in JAX.

9. hybrid: the full-width HybridSuperNetwork (the 9-op conv/ViT space,
   batch 32, 224^2, 100 classes, bf16, latency_pkl/latency_h100_hybrid.pkl):
   eager warmup, weight and arch steps against their CUDA-graph replays bit
   for bit (cuDNN deterministic), the weight steps' draws forced to the ViT
   candidate at one site in each trunk; both kernel strides among each
   graph's nodes; an epoch boundary whose parse (ViT picks),
   shrink_or_expand and L1 rewrite change a ViT mask, written into the
   graphs' buffers, then captured = eager again; eager and captured ms in
   turns; the busy share of a profiled captured weight and arch step and
   the ViT share (the device time of the 9 ViT branches' forward and
   backward, replayed alone from a graph, per trunk); `train_search
   --space hybrid` (one warmup and one search epoch of 4 batches) captured
   and --eager, whose arch_params_NN.pkl must be the same bytes; then an
   eval net with the ViT candidate at stage5/block1 and stage6/block1:
   two bf16 train steps at batch 256, the folds against the unfolded
   forward and the graphed folded forward's epilogue nodes, folded bf16
   images/s and its latency at batch 32. The
   kernel's checks of phase 2 cover the hybrid sites: their depthwise
   shapes are the MBConv sites'.
10. parallel: the full-width MBConv Pareto search of G = 2 targets (4.5
   and 6.0 ms on latency_pkl/latency_h100.pkl, batch 32 per group, 224^2,
   100 classes, bf16; one card runs both groups in turn): captured against
   eager steps bit for bit (cuDNN deterministic), each group's first
   weight and arch step against a single search's step from the same
   state and draws; the fused kernel nodes per replayed Pareto step at
   both strides; eager and captured Pareto step ms in turns (per group
   too) and peak memory; `train_search_pareto` for 2 epochs of 4 batches
   (one warmup), captured and --eager, whose per-group pickles must be
   the same bytes; a G = 4 run of one epoch of 2 batches for its peak
   memory; then a 1-rank NCCL process group: the TF-NAS-A data-parallel
   train step (batch 256, bf16) and one Pareto weight and arch step of one
   group with the group against group=None, eagerly and replayed from CUDA
   graphs (the collectives inside them), bit for bit, and the graphs'
   replay ms with and without the group, in turns.

11. lowerings: the JAX package's opt-in lowerings at full width (batch
   32, 224^2, 100 classes, bf16, latency_pkl/latency_h100.pkl; one set of
   params, masks, batches and draws; cuDNN deterministic): remat_blocks'
   captured warmup, weight and arch steps against its eager steps and
   against the captured steps without remat (bit for bit, else 1e-5), its
   fused nodes (twice the plain ones), the eager steps' peak memory and
   the captured weight and arch ms in turns; the soft path's einsum and
   grouped project with and without the k3/k5 depthwise split, each
   captured arch step against its eager step, log_alphas and loss_a
   against einsum's, arch ms in turns, fused nodes (none with the split);
   cond_width_split's eager weight step (loss against the plain net's,
   launches, ms in turns; capture refused); apply_multi_sampled's f32
   logits (TF32 off) against apply_sampled_pair within 1e-4 x max|logit|
   and its captured bf16 fwd + bwd against the pair's, in turns;
   `train_search --profile_steps 2` over a warmup epoch of 4 batches,
   whose trace must hold the kernel at both strides; and `python -m
   tfnas_tpu_torch.tools_profile --only "sampled fwd"` as a user runs it.
   Phase 2 checks and times the kernel at the lowerings' widths too.

12. tools (data and tools, about 2.5 min): the kernel's forward (y and
   both sums, and a rerun bit for bit) against its plain version at
   batches 128 and 256, the occupancy sweep's, at the largest site of
   each stride (up to 2.5e9 input elements), f32 with TF32 off and bf16;
   a proxy set of real JPEGs (dataset/make_proxy_dataset.py: 8 classes,
   24 train and 8 val images each, 256-352 px); the card image pipeline on
   it (`phase_decode`, decode lines): nvJPEG's pixels against PIL's (mean
   and max |diff| per image of a batch of 32), the augment kernel against
   its plain version on that batch and on 256 images (the batch repeated),
   train with the driver's draws and val, at 224^2 (uint8 within one
   level, the unequal share, one kernel launch a call; ms, device ms, host
   ms, plain ms, bound), and the loader's images/s on the card pipeline at
   batch 32 and 256 beside PIL's at 32; then the set searched by
   `train_search` from CUDA graphs (one warmup and one search epoch of 4
   batches, full width), decoded and augmented on the card, whose log
   must name its decoder once (`image decode: nvjpeg (...)`), which must
   launch the augment kernel, and whose replays must hold both strides;
   then the root tools as a user runs them (`python -m`), subprocesses in
   two lanes at once, each cut to fit: `tools_occupancy_ab --batches 32,64
   --n_timed 4 --warm 2`, `tools_hybrid_bench --iters 3` and
   `tools_eval_throughput` at batch 256 in one lane; the occupancy tool
   with --remat_blocks, `tools_scan_ab --units 1,2 --timed_units 2
   --rounds 1` and `tools_loader_throughput` on the proxy set in the
   other. Each lane's tools are capped at a share of the card's memory
   (LANE_FRACTIONS, above their peaks alone), and the phase fails first
   if the caps and the tools' contexts do not fit in what is free, so
   tools that overlap cannot run the card out of memory; the card's
   memory in use is sampled while the lanes run (`lanes_memory`). Each
   must exit 0 with a JSON last line, and each search tool (occupancy,
   scan, hybrid) must run both strides (eager launches plus replayed
   nodes, from its last line).

The line before the last holds the kernels' summary, with each path's
launches (`launches_tools`: the phase 12 search tools', by stride), the
fused epilogue's nodes per graphed folded forward against the net's
epilogue sites, and the augment kernel's launches in the real-JPEG
search; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a run without a card, a run without the package beside this file, and
a run past the 10-minute deadline.
"""

import collections
import json
import math
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

DEADLINE_S = 600
BATCH = 32
EVAL_BATCH = 256
EVAL_STEPS = 5
VAL_IMAGES = 1000           # 3 full batches of 256 and one padded
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
TARGET_LAT = 0.25           # ms, inside latency_tpu.pkl's range
HYBRID_TARGET_LAT = 4.5     # ms, inside latency_h100_hybrid.pkl's range
PARETO_TARGETS = (4.5, 6.0)  # ms, inside latency_h100.pkl's 4.193-7.350
FLUSH_BYTES = 128 << 20     # written between launches for the cold-L2 time
# the fused epilogue's sites in the served TF-NAS-A-class net at batch 32
# (kernels/bias_act.py): its widest maps (the stem's and stage 1's at 112^2,
# stage 2's at 56^2), the stage-5 block at 7^2 (expand, SE gate, project
# with its residual), that block's SE expand (an [N, C] sigmoid) and the
# logits; (name, shape, act, bias, gate, residual)
EPILOGUE_SITES = (
    ("stem 32@112^2", (32, 32, 112, 112), "relu", True, False, False),
    ("stage1 expand 48@112^2", (32, 48, 112, 112), "relu", True, False,
     False),
    ("stage2 expand 144@56^2", (32, 144, 56, 56), "swish", True, False,
     False),
    ("stage5 expand 1152@7^2", (32, 1152, 7, 7), "swish", True, False,
     False),
    ("stage5 SE gate 1152@7^2", (32, 1152, 7, 7), None, False, True, False),
    ("stage5 project 192@7^2 + residual", (32, 192, 7, 7), None, True,
     False, True),
    ("stage5 SE expand 1152, sigmoid", (32, 1152), "sigmoid", True, False,
     False),
    ("classifier 1000", (32, 1000), None, True, False, False),
)
# ragged shapes the main path does not reach: (N, H, W, C); C 30 and 194
# take the channel-pair copies in both dtypes, 200 the 16-byte ones
EDGE_SHAPES = ((1, 1, 1, 30), (3, 7, 13, 194), (1, 13, 57, 200),
               (3, 57, 7, 30), (1, 57, 57, 194))


def emit(obj):
    print(json.dumps(obj), flush=True)


def _deadline(signum, frame):
    raise TimeoutError(f"chip_smoke.py passed its {DEADLINE_S} s deadline")


# -- phase 1 ------------------------------------------------------------------

def phase_env(torch, fused_dw, card, bias_act):
    import concurrent.futures as cf
    from tfnas_tpu_torch.kernels import nvcc
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(3) as pool:  # one nvcc per source, at once
        builds = [pool.submit(lib.build_library)
                  for lib in (fused_dw, card, bias_act)]
        for b in builds:
            b.result()
    wall = time.perf_counter() - t0
    built = {"fused_dw": dict(fused_dw.build_info),
             "image_decode": dict(card.build_info),
             "bias_act": dict(bias_act.build_info)}
    nvjpeg = card.open_pipeline("cuda")
    # the C++ image pipeline (runtime/native.py) needs g++ and libjpeg's
    # header; the smoke does not use it, it records whether they are here
    probe = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=60) \
        if shutil.which("g++") else None
    versions = {}
    for mod in ("PIL", "triton"):  # whether each imports here, its version
        proc = subprocess.run(
            [sys.executable, "-c", f"import {mod}; print({mod}.__version__)"],
            capture_output=True, text=True, timeout=120)
        versions[mod] = proc.stdout.strip() if proc.returncode == 0 else False
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kernel_build_s": round(wall, 3),
          "build_s": {k: v["seconds"] for k, v in built.items()},
          "nvcc_flags": " ".join(nvcc.SM90A_FLAGS),
          "ptxas": built["fused_dw"]["log"][-800:],
          "ptxas_image_decode": built["image_decode"]["log"][-800:],
          "ptxas_bias_act": built["bias_act"]["log"][-800:],
          "nvjpeg": nvjpeg["nvjpeg"], "nvjpeg_library": nvjpeg["library"],
          "nvjpeg_hardware_backend": nvjpeg["hardware"],
          "nvjpeg_hardware_status": nvjpeg["hardware_status"],
          "nvjpeg_flags": nvjpeg["flags"],
          "gxx": shutil.which("g++"),
          "jpeglib_h": probe is not None and probe.returncode == 0,
          "pil": versions["PIL"], "triton": versions["triton"]})


# -- phase 2 ------------------------------------------------------------------

def main_path_sites(tss):
    """Distinct (H, C, stride, act, path) of the depthwise sites of the
    full search at 224^2: soft width 48 * ic, sampled width 8 * ic; and
    the widths the opt-in lowerings give the kernel: 4 * ic
    (cond_width_split's e3 picks) and 16 * ic (apply_multi_sampled)."""
    from tfnas_tpu_torch.models.supernet import block_sites
    out = []
    for site in block_sites(tss):
        h = tss.BLOCK_INPUT_RES[site.stage][int(site.block[5:]) - 1]
        for path, c in (("soft", 48 * site.ic), ("sampled", 8 * site.ic),
                        ("sampled_e3", 4 * site.ic),
                        ("multi", 16 * site.ic)):
            case = (h, c, site.stride, site.act, path)
            if case not in out:
                out.append(case)
    return out


def _inputs(torch, gen, h, c, dtype, n=BATCH, w=None):
    dev = gen.device
    x = torch.randn((n, h, w or h, c), generator=gen, device=dev).to(dtype)
    wk = torch.randn((5, 5, c), generator=gen, device=dev) * 0.2
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    offset = torch.randn(c, generator=gen, device=dev) * 0.1
    return x, wk, scale, offset


def _timed(torch, fn, reps=20):
    """ms per call from CUDA events around `reps` back-to-back calls: the
    device time, or the host's where enqueueing a call takes longer."""
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


def _timings(torch, fn, flush, reps=20):
    """The same `reps` calls timed three more ways: device ms per call from
    events around the replay of a CUDA graph of them (median of 5 replays),
    cold-L2 ms per call from events around each call after `flush` is
    written, and host us per call (enqueue only, nothing in the queue)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    dev = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / reps)
    del graph
    cold = []
    for _ in range(10):
        flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        cold.append((start, end))
    torch.cuda.synchronize()
    cold_ms = sum(a.elapsed_time(b) for a, b in cold) / len(cold)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = 1e6 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return sorted(dev)[len(dev) // 2], cold_ms, host_us


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


def _forward_errors(got, want, bf):
    """(max |y error|, its tolerance, sum and sum-of-squares errors over
    their tolerances) of the kernel's (y, sum y, sum y^2) against the plain
    version's."""
    yf = want[0].float()
    err_y = (got[0].float() - yf).abs().max().item()
    tol_y = (2e-2 if bf else 2e-4) * max(1.0, yf.abs().max().item())
    # sums: the kernel sums its f32 accumulator, the plain version the
    # rounded y (bf16: up to 2^-8 of sum |y| apart)
    rel = 2 ** -7 if bf else 1e-5
    err_s = ((got[1] - want[1]).abs()
             / (rel * yf.abs().sum((0, 1, 2)) + 1e-3)).max().item()
    err_q = ((got[2] - want[2]).abs()
             / (rel * (yf * yf).sum((0, 1, 2)) + 1e-3)).max().item()
    return err_y, tol_y, err_s, err_q


def _check(torch, fused_dw, gen, n, h, w, c, stride, act, dtype):
    """The kernel (forward, backward) against the plain version on one
    shape, and its sums over two runs; returns the case's JSON record."""
    bf = dtype == torch.bfloat16
    x, wk, scale, offset = _inputs(torch, gen, h, c, dtype, n, w)
    args = [t.clone().requires_grad_() for t in (x, wk, scale, offset)]
    got = fused_dw.fused_dw_norm_act(*args, stride, act)
    ref_args = [t.clone().requires_grad_() for t in (x, wk, scale, offset)]
    want = fused_dw.fused_dw_plain(*ref_args, stride, act)
    # one loss through both: random weights on y and on the sums
    ry = torch.randn(want[0].shape, generator=gen, device="cuda")
    rs = torch.randn(c, generator=gen, device="cuda")
    rq = torch.randn(c, generator=gen, device="cuda") * 1e-3
    for (y, s, q), a in ((got, args), (want, ref_args)):
        ((y.float() * ry).sum() + (s * rs).sum() + (q * rq).sum()).backward()
    with torch.no_grad():
        err_y, tol_y, err_s, err_q = _forward_errors(got, want, bf)
    grad_errs = [((a.grad - b.grad).abs().max()
                  / b.grad.abs().max().clamp_min(1e-12)).item()
                 for a, b in zip(args, ref_args)]
    tol_g = 2e-2 if bf else 1e-3
    with torch.no_grad():
        again = fused_dw.fused_dw_cuda(x, wk, scale, offset, stride, act)
    same = all(torch.equal(a, b.detach()) for a, b in zip(again, got))
    ok = (err_y <= tol_y and err_s <= 1.0 and err_q <= 1.0
          and max(grad_errs) <= tol_g and same
          and all(math.isfinite(e) for e in grad_errs))
    return {"phase": "kernel", "n": n, "h": h, "w": w or h, "c": c,
            "stride": stride, "act": act, "dtype": "bf16" if bf else "f32",
            "max_abs_err_y": err_y, "tol_y": tol_y,
            "sum_err_over_tol": err_s, "sumsq_err_over_tol": err_q,
            "grad_rel_errs_x_w_scale_offset": grad_errs, "tol_grad": tol_g,
            "bit_identical_rerun": same, "ok": ok}


def phase_kernel(torch, fused_dw, tss):
    F = torch.nn.functional
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    failures, per_stride = [], {1: [], 2: []}
    cases = [(BATCH, h, None, c, stride, act, path)
             for h, c, stride, act, path in main_path_sites(tss)]
    cases += [(n, h, w, c, stride, act, "edge")
              for n, h, w, c in EDGE_SHAPES for stride in (1, 2)
              for act in ("relu", "swish")]
    for n, h, w, c, stride, act, path in cases:
        for dtype in (torch.float32, torch.bfloat16):
            case = _check(torch, fused_dw, gen, n, h, w, c, stride, act,
                          dtype)
            case["path"] = path
            emit(case)
            if not case["ok"]:
                failures.append(case)
            if dtype == torch.bfloat16 and path != "edge":
                per_stride[stride].append((h, c, case["max_abs_err_y"]))
    torch.backends.cudnn.allow_tf32 = True
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version in "
                             f"{len(failures)} cases")

    # times at bf16, the search's activation dtype
    times = {}
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for h, c, stride, act, path in main_path_sites(tss):
        x, w, scale, offset = _inputs(torch, gen, h, c, torch.bfloat16)
        x1 = fused_dw._elementwise(x, scale, offset, act).permute(0, 3, 1, 2)
        wk = fused_dw._dw_weight(w, x.dtype)

        def kernel():
            return fused_dw.fused_dw_cuda(x, w, scale, offset, stride, act)

        def library():
            return F.conv2d(x1, wk, None, stride, 2, 1, c)

        with torch.no_grad():
            t_k = _timed(torch, kernel)
            dev_k, cold_k, host_k = _timings(torch, kernel, flush)
            t_p = _timed(torch, lambda: fused_dw.fused_dw_plain(
                x, w, scale, offset, stride, act))
            t_l = _timed(torch, library)
            dev_l, cold_l, host_l = _timings(torch, library, flush)
        bound_ms, bound_by = _bound(x, w, stride)
        row = {"phase": "kernel_time", "h": h, "c": c, "stride": stride,
               "act": act, "path": path, "dtype": "bf16", "ms": t_k,
               "device_ms": dev_k, "cold_ms": cold_k, "host_us": host_k,
               "plain_ms": t_p, "library_ms": t_l,
               "library_device_ms": dev_l, "library_cold_ms": cold_l,
               "library_host_us": host_l, "bound_ms": bound_ms,
               "bound_by": bound_by}
        emit(row)
        times[(h, c, stride)] = row
        del x, x1
    del flush
    return per_stride, times


def epilogue_operands(torch, gen, shape, bias, gate, residual,
                      bias_dtype=None):
    """x (bf16, channels_last or [N, C]), the bias (f32, or `bias_dtype`),
    a bf16 gate and a residual of an epilogue site; None where the site
    has no such operand."""
    def draw():
        t = (torch.randn(shape, generator=gen, device="cuda") * 3.0).to(
            torch.bfloat16)
        return (t.contiguous(memory_format=torch.channels_last)
                if t.dim() == 4 else t)
    n, c = shape[:2]
    b = torch.randn(c, generator=gen, device="cuda") if bias else None
    if b is not None and bias_dtype is not None:
        b = b.to(bias_dtype)
    s = (torch.rand((n, c), generator=gen, device="cuda").bfloat16()
         if gate else None)
    return draw(), b, s, draw() if residual else None


def epilogue_bound_ms(x, b, s, r):
    """The least time for an epilogue on the card: x read and out written
    once, the residual, bias and gate read once, at the HBM rate."""
    nbytes = 2 * x.numel() * x.element_size()
    nbytes += sum(t.numel() * t.element_size() for t in (b, s, r)
                  if t is not None)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def bf16_ulps(torch, got, want):
    """The largest |got - want| in units in the last place of want's bf16
    value."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return float(((got.float() - w).abs() / ulp).max())


def phase_epilogue(torch, bias_act):
    """The fused epilogue kernel against its plain version at the served
    net's sites (EPILOGUE_SITES), the bias f32 as folded and bf16 as a
    server casts it: within one bf16 ulp, a rerun bit for bit. Then each
    site's times in bf16, as phase 2 times the depthwise kernel, beside
    the plain version's and the HBM bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    rows, failures = [], []
    for name, shape, act, *kinds in EPILOGUE_SITES:
        row = {"phase": "epilogue", "site": name, "shape": list(shape),
               "act": act}
        for tag, bias_dtype in (("f32", None), ("bf16", torch.bfloat16)):
            x, b, s, r = epilogue_operands(torch, gen, shape, *kinds,
                                           bias_dtype)
            with torch.no_grad():
                got = bias_act.bias_act_cuda(x, b, act, s, r)
                again = bias_act.bias_act_cuda(x, b, act, s, r)
                want = bias_act.bias_act_plain(x, b, act, s, r)
            row[f"max_ulps_{tag}_bias"] = bf16_ulps(torch, got, want)
            row[f"bit_identical_rerun_{tag}_bias"] = torch.equal(got, again)
        row["ok"] = all(row[f"max_ulps_{t}_bias"] <= 1.0
                        and row[f"bit_identical_rerun_{t}_bias"]
                        for t in ("f32", "bf16"))
        x, b, s, r = epilogue_operands(torch, gen, shape, *kinds)

        def kernel():
            return bias_act.bias_act_cuda(x, b, act, s, r)

        with torch.no_grad():
            row["ms"] = _timed(torch, kernel)
            row["device_ms"], row["cold_ms"], row["host_us"] = _timings(
                torch, kernel, flush)
            row["plain_ms"] = _timed(torch, lambda: bias_act.bias_act_plain(
                x, b, act, s, r))
        row["bound_ms"], row["bound_by"] = epilogue_bound_ms(x, b, s, r), \
            "bytes"
        emit(row)
        rows.append(row)
        if not row["ok"]:
            failures.append(name)
    del flush
    if failures:
        raise AssertionError(f"the epilogue kernel disagrees with its plain "
                             f"version at {failures}")
    return rows


def _epilogue_sites(net):
    """The epilogue sites of a BN-folded eval net, from its layers: the
    first stem, the feature-mix layer and the classifier, each ConvLayer,
    and in an MBConv block each 1x1 and depthwise convolution and the SE's
    reduce, expand and gate (ViT blocks have none)."""
    from tfnas_tpu_torch.ops.layers import (ConvLayer, MBConvPreNorm,
                                            MBInvertedResBlock)
    n = 2 + (net.feature_mix_layer is not None)
    for b in [net.second_stem] + [b for _, _, b in net.iter_blocks()]:
        if isinstance(b, ConvLayer):
            n += 1
        elif isinstance(b, MBInvertedResBlock):
            n += b.has_expand + 2 + 3 * b.has_se
        elif isinstance(b, MBConvPreNorm):
            n += b.has_proj + 6
    return n


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
    data = device_batches(BATCH, 8, gen, 100, 224, torch.bfloat16)
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

    # phase 4: one more steady weight and arch step under the profiler
    from torch.profiler import ProfilerActivity, profile, record_function
    umasks = net.update_masks(params, mc_mask)
    x, y = next(data)
    ig = sample_gumbel_indices(arch["log_alphas"], gen)
    ir = sample_random_excluding(ig, 8, gen)
    u = gumbel_uniform(arch["log_alphas"].shape, gen)

    def weight_p():
        nonlocal params, mom
        params, mom, m = steps.weight_step(params, arch, mom, masks, umasks,
                                           x, y, lr, ig, ir)
        return m

    def arch_p():
        nonlocal arch, opt_a
        arch, opt_a, m = steps.arch_step(params, arch, opt_a, masks, x, y,
                                         lat_vec, lut["base"], T, u)
        return m

    for name, expect, fn in (("weight", 36, weight_p), ("arch", 18, arch_p)):
        trace = os.path.join(tmpdir, f"trace_{name}.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("step"):
                run(f"{name}_profiled", expect, fn)
        prof.export_chrome_trace(trace)
        emit(_profile_summary(name, trace))
    launches = dict(fused_dw.launches)

    from tfnas_tpu_torch.convert import params_to_jax
    from tfnas_tpu_torch.utils.checkpoint import save_checkpoint_file
    searched = os.path.join(tmpdir, "searched_model_01.pkl")
    t = time.perf_counter()
    save_checkpoint_file(to_numpy_tree({
        "params": params_to_jax(params), "arch_params": arch,
        "mc_mask_dddict": mc_mask, "epoch": 1, "T": T}), searched)
    emit({"phase": "search", "step": "save_searched_model",
          "ms": 1e3 * (time.perf_counter() - t),
          "MB": os.path.getsize(searched) / 1e6})
    return launches, searched


# -- phase 6 ------------------------------------------------------------------

def _tree_err(torch, a, b):
    """Largest |a - b| over the tensor leaves of two trees (inf when a
    shape differs)."""
    from tfnas_tpu_torch.search.compiled import leaves_of
    err = 0.0
    for x, y in zip(leaves_of(a), leaves_of(b)):
        if x.shape != y.shape:
            return math.inf
        if x.numel():
            err = max(err, (x.double() - y.double()).abs().max().item())
    return err


def _clone(torch, tree):
    from tfnas_tpu_torch.search.compiled import _flatten, _unflatten
    leaves = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([l.clone() for l in leaves]))


def _events_ms(torch, fn, n):
    """ms per call from CUDA events around n calls (host and device)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _counted(fused_dw, into, fn, *args):
    """fn(*args), adding the fused kernel launches that this call alone
    made, by stride, to `into` (a capture's warm-ups and other calls in
    between stay out of the count)."""
    before = dict(fused_dw.launches)
    out = fn(*args)
    for stride, n in fused_dw.launches.items():
        into[stride] = into.get(stride, 0) + n - before[stride]
    return out


_FUSED_STRIDE = (r"fused_dw_kernel(?:I\w*?Li([12])E|<[^,>]*,\s*"
                 r"(?:\(int\))?([12]))")


def _fused_stride(name):
    """The stride template argument of a fused kernel's (mangled or
    demangled) name."""
    import re
    m = re.search(_FUSED_STRIDE, name)
    return int(m.group(1) or m.group(2)) if m else 0


def phase_capture(torch, fused_dw, tmpdir):
    """Captured warmup, weight and arch steps against the eager steps from
    the same state, inputs and draws (cuDNN deterministic); the K-unit
    scanned iteration over the captured steps against its eager loop;
    build times, peak memory, eager and captured ms in turns, fused kernel
    nodes, and profiles of one captured weight and arch step. Returns the
    per-graph fused kernel nodes."""
    from tfnas_tpu_torch.cost.lut import lat_vectors_for_mc, load_lat_lookup
    from tfnas_tpu_torch.data.synthetic import device_batches
    from tfnas_tpu_torch.models import search_space as ss
    from tfnas_tpu_torch.models.supernet import SuperNetwork
    from tfnas_tpu_torch.search.bisample import (gumbel_uniform,
                                                 sample_gumbel_indices,
                                                 sample_random_excluding)
    from tfnas_tpu_torch.search.compiled import GraphFamily
    from tfnas_tpu_torch.search.parser import get_mc_num_dddict
    from tfnas_tpu_torch.search.train_step import (adam_init,
                                                   make_scanned_search_iter,
                                                   make_search_steps,
                                                   zeros_like_tree)
    from torch.profiler import ProfilerActivity, profile, record_function

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    lut = load_lat_lookup(os.path.join(here, "latency_pkl",
                                       "latency_tpu.pkl"))
    net = SuperNetwork(100)
    gen = torch.Generator(device=dev).manual_seed(3)
    params, arch = net.init(gen)
    mc_mask = ss.build_mc_mask_dddict()
    kw = dict(num_classes=100, lambda_lat=0.1, target_lat=TARGET_LAT)
    fam = GraphFamily(dev)
    state = fam.adopt({
        "params": params, "arch": arch, "mom": zeros_like_tree(params),
        "opt": adam_init(arch), "masks": net.device_masks(mc_mask, dev),
        "umasks": net.update_masks(params, mc_mask),
        "lat": torch.from_numpy(lat_vectors_for_mc(
            lut, get_mc_num_dddict(mc_mask))).to(dev),
        "lr": torch.tensor(0.025, device=dev),
        "T": torch.tensor(5.0, device=dev),
        "base": torch.tensor(float(lut["base"]), device=dev)})
    del params, arch
    eager = make_search_steps(net, **kw)
    capt = make_search_steps(net, family=fam, **kw)
    data = device_batches(BATCH, 12, gen, 100, 224, torch.bfloat16)
    batches = [next(data) for _ in range(6)]

    def call(steps, kind, st, i):
        x, y = batches[i]
        la = st["arch"]["log_alphas"]
        g = torch.Generator(device=dev).manual_seed(100 + i)
        if kind == "arch":
            u = gumbel_uniform(la.shape, g)
            a, o, m = steps.arch_step(st["params"], st["arch"], st["opt"],
                                      st["masks"], x, y, st["lat"],
                                      st["base"], st["T"], u)
            return {"arch": a, "opt": o}, m
        ig = sample_gumbel_indices(la, g)
        if kind == "warmup":
            p, mo, m = steps.warmup_step(st["params"], st["arch"], st["mom"],
                                         st["masks"], st["umasks"], x, y,
                                         st["lr"], ig)
        else:
            ir = sample_random_excluding(ig, 8, g)
            p, mo, m = steps.weight_step(st["params"], st["arch"], st["mom"],
                                         st["masks"], st["umasks"], x, y,
                                         st["lr"], ig, ir)
        return {"params": p, "mom": mo}, m

    # peak memory of an eager weight and arch step above the state
    snap = _clone(torch, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for kind in ("weight", "arch"):
        snap.update(call(eager, kind, snap, 0)[0])
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() - base_mem
    del snap
    torch.cuda.reset_peak_memory_stats()
    failures = []
    for i, kind in enumerate(("warmup", "weight", "arch", "weight", "arch")):
        snap = _clone(torch, state)
        want, wm = call(eager, kind, snap, i)
        del snap
        got, gm = call(capt, kind, state, i)
        errs = {k: _tree_err(torch, got[k], want[k]) for k in got}
        errs["metrics"] = _tree_err(torch, gm, wm)
        worst = max(errs.values())
        rec = {"phase": "capture", "step": kind, "replay": i,
               "max_abs_err": errs, "bit_identical": worst == 0.0,
               "tol": 1e-5}
        emit(rec)
        if not worst <= 1e-5:
            failures.append(rec)
        for k, v in got.items():  # carry the captured state on
            state[k] = v
    peak_capt = torch.cuda.max_memory_allocated() - base_mem
    graphs = {g.name: g for g in fam.graphs}
    nodes = {n: g.nodes["fused_dw"] for n, g in graphs.items()}
    emit({"phase": "capture", "step": "graphs",
          "build_s": {n: g.build_s for n, g in graphs.items()},
          "fused_nodes_by_stride": nodes,
          "peak_mem_GB_eager_steps": peak_eager / 1e9,
          "peak_mem_GB_captures_and_checks": peak_capt / 1e9,
          "reserved_GB": torch.cuda.memory_reserved() / 1e9})
    for name in ("warmup_step", "weight_step", "arch_step"):
        if not (nodes[name].get(1) and nodes[name].get(2)):
            failures.append(f"{name}: fused nodes {nodes[name]}")

    # eager and captured step ms, in turns (eager, captured, captured, eager)
    times = collections.defaultdict(list)
    est = _clone(torch, state)
    for kind in ("warmup", "weight", "arch"):
        for mode in ("eager", "captured", "captured", "eager"):
            st = est if mode == "eager" else state
            steps = eager if mode == "eager" else capt

            def once():
                out, _ = call(steps, kind, st, 5)
                st.update(out)
            once()
            times[(kind, mode)].append(_events_ms(torch, once, 3))
    emit({"phase": "capture", "step": "times_ms",
          **{f"{k}_{m}": v for (k, m), v in times.items()}})
    del est

    # the K-unit scanned iteration, eager and over the captured weight and
    # arch steps, from the same state and generator seed
    K = 2
    xw = torch.stack([b[0] for b in batches[:2 * K]]).reshape(
        K, 2, *batches[0][0].shape)
    yw = torch.stack([b[1] for b in batches[:2 * K]]).reshape(K, 2, -1)
    xa = torch.stack([b[0] for b in batches[2 * K:3 * K]])
    ya = torch.stack([b[1] for b in batches[2 * K:3 * K]])
    results, unit_ms = {}, collections.defaultdict(list)
    iters = {"eager": make_scanned_search_iter(net, steps=eager, **kw),
             "captured": make_scanned_search_iter(net, steps=capt, **kw)}
    start = _clone(torch, state)
    for name, run in iters.items():
        st = _clone(torch, start)
        g = torch.Generator(device=dev).manual_seed(7)
        t = time.perf_counter()
        out = run(st["params"], st["mom"], st["arch"], st["opt"],
                  st["masks"], st["umasks"], xw, yw, xa, ya, st["lr"],
                  st["T"], st["lat"], st["base"], g)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        results[name] = _clone(torch, out)
        unit_ms[name].append(first_s * 1e3)

        def again():
            o = run(st["params"], st["mom"], st["arch"], st["opt"],
                    st["masks"], st["umasks"], xw, yw, xa, ya, st["lr"],
                    st["T"], st["lat"], st["base"], g)
            st.update(params=o[0], mom=o[1], arch=o[2], opt=o[3])
        st.update(params=out[0], mom=out[1], arch=out[2], opt=out[3])
        unit_ms[name].append(_events_ms(torch, again, 2) / K)
        del st, out
    errs = {"captured": _tree_err(torch, results["captured"],
                                  results["eager"])}
    draws_equal = all(
        torch.equal(results[n][4][k], results["eager"][4][k])
        for n in errs for k in ("idx_g", "idx_r")) and all(
        torch.equal(results[n][5]["gumbel_u"], results["eager"][5][
            "gumbel_u"]) for n in errs)
    rec = {"phase": "capture", "step": "scanned", "K": K,
           "first_call_ms_then_ms_per_unit": dict(unit_ms),
           "max_abs_err_vs_eager": errs, "draws_equal": draws_equal,
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    if not (max(errs.values()) <= 1e-5 and draws_equal):
        failures.append(rec)
    del results, start

    # one captured weight and arch step under the profiler
    profiles = {}
    for kind in ("weight", "arch"):
        trace = os.path.join(tmpdir, f"trace_captured_{kind}.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("step"):
                out, _ = call(capt, kind, state, 5)
                torch.cuda.synchronize()
        state.update(out)
        prof.export_chrome_trace(trace)
        profiles[kind] = _profile_summary(f"captured_{kind}", trace)
        emit(dict(profiles[kind], phase="capture_profile"))
        os.remove(trace)
        by_stride = profiles[kind]["fused_dw_ms_by_stride"]
        if not (by_stride.get(1) and by_stride.get(2)):
            failures.append(f"captured {kind} step: fused kernel device ms "
                            f"by stride {by_stride}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    del state, capt, fam
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"captured steps disagree: {failures}")
    return nodes, profiles, times


def phase_driver(torch, tmpdir):
    """The driver at full width on synthetic data, --scan_units 2, three
    epochs (one warmup; the second ends with shrink/expand and the third
    steps on the rewritten masks), from CUDA graphs and eagerly: every
    arch_params_NN.pkl and the final supernet must agree."""
    from tfnas_tpu_torch import train_search
    here = os.path.dirname(os.path.abspath(__file__))
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    from tfnas_tpu_torch.kernels import fused_dw
    runs, counts = {}, {}
    for mode in ("captured", "eager"):
        fused_dw.reset_launches()
        t = time.perf_counter()
        run = train_search.main([
            "--synthetic", "--epochs", "3", "--warmup_epochs", "1",
            "--steps_per_epoch", "8", "--scan_units", "2", "--save",
            os.path.join(tmpdir, f"driver_{mode}"), "--save_freq", "100",
            "--print_freq", "4", "--target_lat", str(TARGET_LAT),
            "--lookup_path", os.path.join(here, "latency_pkl",
                                          "latency_tpu.pkl")]
            + (["--eager"] if mode == "eager" else []))
        runs[mode] = (run, time.perf_counter() - t)
        counts[mode] = {"launches": dict(fused_dw.launches),
                        "captured": dict(fused_dw.captured),
                        "replayed": dict(fused_dw.replayed)}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    errs, identical = {}, True
    import numpy as np
    for name in sorted(os.listdir(runs["eager"][0])):
        if not name.endswith(".pkl"):
            continue
        a = pickle.load(open(os.path.join(runs["captured"][0], name), "rb"))
        b = pickle.load(open(os.path.join(runs["eager"][0], name), "rb"))
        identical &= (open(os.path.join(runs["captured"][0], name),
                           "rb").read()
                      == open(os.path.join(runs["eager"][0], name),
                              "rb").read())

        def walk(x, y):
            if isinstance(x, dict):
                return max([walk(x[k], y[k]) for k in x] or [0.0])
            if isinstance(x, np.ndarray) and x.dtype.kind == "f":
                return float(np.abs(x.astype(np.float64) - y).max()) \
                    if x.size else 0.0
            return 0.0 if np.array_equal(x, y) else math.inf
        errs[name] = walk(a, b)
    rec = {"phase": "driver", "scan_units": 2, "epochs": 3,
           "seconds": {m: r[1] for m, r in runs.items()},
           "fused_dw_counts": counts,
           "max_abs_err": errs, "bytes_identical": identical, "tol": 1e-5}
    emit(rec)
    for mode in runs:
        shutil.rmtree(runs[mode][0])
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"captured driver run disagrees: {rec}")
    if not all(counts["captured"]["replayed"].values()):
        raise AssertionError(f"the captured driver run replayed no fused "
                             f"kernel of some stride: {counts}")
    return counts["captured"]["replayed"]


def phase_lut(torch, tmpdir):
    """make_lat_lut in measure mode on its first two keys; for one
    block, the measured chain time against the profiler's device time of
    the same launches, and the empty chain's time; --print_lat's
    measurement on TF-NAS-A."""
    import contextlib
    import io
    from tfnas_tpu_torch import make_lat_lut, parsing_model
    from tfnas_tpu_torch.cost.lut import load_lat_lookup
    from tfnas_tpu_torch.cost.measure import Chain, measure_latency_in_ms
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.ops.layers import MBInvertedResBlock
    from tfnas_tpu_torch.search.train_step import tree_map
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmpdir, "lut.pkl")
    t = time.perf_counter()
    make_lat_lut.main(["--mode", "measure", "--max_keys", "2",
                       "--stride_points", "3", "--output", out])
    build_s = time.perf_counter() - t
    lut = load_lat_lookup(out)
    keys = [k for k in lut if k != "base"]
    ok = (len(keys) == 2 and lut["base"] > 0 and all(
        all(math.isfinite(v) and v > 0 for v in lut[k].values())
        and list(lut[k].values()) == sorted(lut[k].values()) for k in keys))

    # one block at its widest: the chain's time per call against the
    # device time the profiler sees for the same launches
    key, res, cin, se, cout, k, stride, act, max_mc = \
        make_lat_lut.site_keys()[0]
    block = MBInvertedResBlock(cin, max_mc, se, cout, kernel_size=k,
                               stride=stride, affine=True, act_func=act)
    params, state = block.init(torch.Generator(device=dev).manual_seed(0))
    params = tree_map(lambda v: v.to(torch.bfloat16), params)
    x = torch.randn((BATCH, cin, res, res), device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def fwd(p, s, xx):
        return block.apply(p, s, xx, training=False)[0]
    iters = 50
    chain = Chain(fwd, (params, state, x), iters)
    chain.run()
    chain_ms = float(sorted(chain.time_ms(5))[2])
    trace = os.path.join(tmpdir, "trace_chain.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("step"):
            chain.run()
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    summary = _profile_summary("lut_chain", trace)
    os.remove(trace)
    device_ms = summary["device_busy_ms"] / iters
    empty_ms = measure_latency_in_ms(lambda xx: xx, (x,), 10, iters)
    del chain

    with open(os.path.join(here, "configs", "tfnas_a_tpu.config")) as f:
        tfnas_a = EvalNetwork.from_config(1000, json.load(f))
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        lat = parsing_model.print_latency(
            tfnas_a, load_lat_lookup(os.path.join(
                here, "latency_pkl", "latency_tpu.pkl")), 224, dev)
    printed = buf.getvalue().strip().splitlines()
    rec = {"phase": "lut", "build_s": build_s, "keys": keys,
           "base_ms": lut["base"],
           "key_ms_range": {k: [min(lut[k].values()), max(lut[k].values())]
                            for k in keys},
           "block": key, "mc": max_mc, "chain_ms_per_call": chain_ms,
           "profiler_device_ms_per_call": device_ms,
           "chain_over_device": chain_ms / device_ms,
           "empty_chain_ms_per_call": empty_ms,
           "chain_kernels_per_call": summary["kernels"] / iters,
           "tfnas_a_print_lat": printed,
           "tfnas_a_ms": {f"bs{b}": v for b, v in lat.items()},
           "print_lat_s": time.perf_counter() - t}
    emit(rec)
    if not ok:
        raise AssertionError(f"measured LUT is malformed: {rec}")
    if not chain_ms >= 0.95 * device_ms:
        raise AssertionError(f"chain time below the device time: {rec}")
    if not (len(printed) == 3 and all(math.isfinite(v) and v > 0
                                      for v in lat.values())):
        raise AssertionError(f"--print_lat on TF-NAS-A: {printed}")


# -- phase 5 ------------------------------------------------------------------

def _u8_batches(np, n, seed, valid=None):
    """n synthetic uint8 [EVAL_BATCH, 224, 224, 3] batches and int32
    labels; with `valid`, the last holds that many images, padded to the
    batch by repeating its last one, and comes as (x, y, valid)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.integers(0, 256, (EVAL_BATCH, 224, 224, 3), dtype=np.uint8)
        y = rng.integers(0, 1000, EVAL_BATCH).astype(np.int32)
        if valid is not None and i == n - 1:
            x[valid:], y[valid:] = x[valid - 1], y[valid - 1]
            out.append((x, y, valid))
        else:
            out.append((x, y))
    return out


def _same_tree(torch, a, b):
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_same_tree(torch, a[k], b[k]) for k in a))
    return torch.equal(a, b)


def _retrain(torch, np, name, net, n_steps, tmpdir, profile=False):
    """n_steps bf16 train steps of `net` at EVAL_BATCH through the
    prefetcher and the on-card normaliser (with `profile`, the last one
    under torch.profiler), then an eval checkpoint that must read back
    exactly. Returns (state, the step's record)."""
    from torch.profiler import ProfilerActivity, profile as profiler
    from torch.profiler import record_function
    from tfnas_tpu_torch.convert import eval_state_from_jax, params_to_jax
    from tfnas_tpu_torch.cost import (calculate_FLOPs_in_M,
                                      count_parameters_in_MB)
    from tfnas_tpu_torch.data import DevicePrefetcher, device_normalizer
    from tfnas_tpu_torch.parallel.train_dp import (cosine_lr_with_warmup,
                                                   init_eval_train_state,
                                                   make_eval_steps)
    from tfnas_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    state = init_eval_train_state(net, gen)
    train_step, _ = make_eval_steps(net, num_classes=1000)
    prep = device_normalizer(torch.bfloat16)
    lr = cosine_lr_with_warmup(0.2, 250, 0, EVAL_BATCH)
    host = _u8_batches(np, 2, 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    batches = (host[i % 2] for i in range(n_steps))
    for x, y in DevicePrefetcher(batches, dev):
        if profile and len(step_ms) == n_steps - 1:
            trace = os.path.join(tmpdir, f"trace_{name}.json")
            with profiler(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                with record_function("step"):
                    state, m = train_step(state, prep(x), y, lr,
                                          net.draw_keep(len(y), gen))
                    torch.cuda.synchronize()
            prof.export_chrome_trace(trace)
            summary = _profile_summary(f"eval_train_{name}", trace)
            emit({k: v for k, v in summary.items()
                  if not k.startswith(("fused_dw", "copy_or"))})
            continue
        t = time.perf_counter()
        state, m = train_step(state, prep(x), y, lr,
                              net.draw_keep(len(y), gen))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{name}: loss {losses[-1]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    path = save_checkpoint({
        "epoch": 1, "params": params_to_jax(state.params),
        "bn_state": params_to_jax(state.bn_state),
        "momentum": params_to_jax(state.momentum),
        "best_acc_top1": 0.0, "best_acc_top5": 0.0,
        "model_config": net.config}, False, tmpdir, f"{name}_checkpoint.pkl")
    back = eval_state_from_jax(load_checkpoint(path), dev)
    save_ms = 1e3 * (time.perf_counter() - t)
    if not all(_same_tree(torch, getattr(state, k), getattr(back, k))
               for k in ("params", "bn_state", "momentum")):
        raise AssertionError(f"{name}: the checkpoint does not read back")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    rec = {"phase": "eval", "step": "retrain", "model": name,
           "batch": EVAL_BATCH, "dtype": "bf16", "lr": lr,
           "step_ms": step_ms, "steady_step_ms": steady,
           "train_images_per_s": EVAL_BATCH / steady * 1e3,
           "loss": losses, "peak_mem_GB": peak,
           "params_M": count_parameters_in_MB(state.params),
           "flops_M": calculate_FLOPs_in_M(net, 224),
           "checkpoint_MB": os.path.getsize(path) / 1e6,
           "checkpoint_roundtrip_ms": save_ms}
    emit(rec)
    return state, rec


def _test(torch, np, net, state):
    """test.py's validation (f32, the padded final batch masked) over
    VAL_IMAGES images, against the same images scored without padding."""
    from tfnas_tpu_torch.data import device_normalizer
    from tfnas_tpu_torch.parallel.train_dp import make_eval_steps
    from tfnas_tpu_torch.train_eval import validate

    dev = torch.device("cuda")
    nb = -(-VAL_IMAGES // EVAL_BATCH)
    valid = VAL_IMAGES - (nb - 1) * EVAL_BATCH
    batches = _u8_batches(np, nb, 11, valid)
    _, val_step = make_eval_steps(net, num_classes=1000,
                                  compute_dtype=torch.float32)
    prep = device_normalizer(torch.float32)
    t = time.perf_counter()
    loss, top1, top5 = validate(val_step, state, batches, prep, dev)
    ms = 1e3 * (time.perf_counter() - t)
    sums = np.zeros(4)
    for b in batches:
        n = b[2] if len(b) > 2 else EVAL_BATCH
        x = torch.from_numpy(b[0][:n]).to(dev)
        y = torch.from_numpy(b[1][:n]).to(dev).long()
        m = val_step(state, prep(x), y)
        sums += [float(m["loss"]) * n, float(m["top1"]) * n,
                 float(m["top5"]) * n, n]
    want = sums[:3] / sums[3]
    err = float(np.abs(np.array([loss, top1, top5]) - want).max())
    rec = {"phase": "eval", "step": "test", "images": VAL_IMAGES,
           "batch": EVAL_BATCH, "padded": EVAL_BATCH - valid,
           "loss": float(loss), "top1": float(top1), "top5": float(top5),
           "unpadded": want.tolist(), "max_abs_err": err, "ms": ms}
    emit(rec)
    if not (err <= 1e-4 and all(math.isfinite(v) for v in want)):
        raise AssertionError(f"padded validation disagrees: {rec}")


def _folds(torch, np, net, state):
    """BN folding and the s2d stem against the unfolded forward, f32
    (TF32 off) and bf16; then bf16 inference images/s, in turns; then the
    folded bf16 forward replayed from a CUDA graph, as the serving cell
    runs it: a fused epilogue node at each of its epilogue sites, none
    left unfused. Returns that replay's epilogue counts."""
    from tfnas_tpu_torch.data import device_normalizer
    from tfnas_tpu_torch.kernels import bias_act
    from tfnas_tpu_torch.models.folding import (fold_batchnorm,
                                                fold_stem_space_to_depth)
    from tfnas_tpu_torch.search import compiled
    from tfnas_tpu_torch.search.train_step import tree_map

    dev = torch.device("cuda")
    x8 = torch.from_numpy(_u8_batches(np, 1, 13)[0][0]).to(dev)
    folded, fparams = fold_batchnorm(net, state.params, state.bn_state)
    s2d, sparams = fold_stem_space_to_depth(folded, fparams)
    nets = {"unfolded": (net, state.params, state.bn_state),
            "folded": (folded, fparams, {}), "s2d": (s2d, sparams, {})}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec = {"phase": "eval", "step": "fold", "batch": EVAL_BATCH}
    failures = []
    with torch.no_grad():
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            x = device_normalizer(dtype)(x8)
            ref = net.apply(state.params, state.bn_state, x)[0].float()
            scale = ref.abs().max().item()
            tag = "f32" if dtype == torch.float32 else "bf16"
            for name in ("folded", "s2d"):
                n2, p2, s2 = nets[name]
                got = n2.apply(p2, s2, x)[0].float()
                err = (got - ref).abs().max().item()
                rec[f"{name}_{tag}_max_abs_err"] = err
                rec[f"{name}_{tag}_tol"] = rel * scale
                rec[f"{name}_{tag}_top1_agree"] = (
                    got.argmax(-1) == ref.argmax(-1)).float().mean().item()
                if not err <= rel * scale:
                    failures.append((name, tag, err, rel * scale))
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        # serving form: bf16 parameters, cast once
        x = device_normalizer(torch.bfloat16)(x8)
        fwd = {}
        for name, (n2, p2, s2) in nets.items():
            p16 = tree_map(lambda t: t.to(torch.bfloat16), p2)
            fwd[name] = (lambda n2=n2, p16=p16, s2=s2:
                         n2.apply(p16, s2, x))
        ms = collections.defaultdict(list)
        for name in ("unfolded", "folded", "s2d", "s2d", "folded",
                     "unfolded"):
            ms[name].append(_timed(torch, fwd[name], reps=10))
        for name, t in ms.items():
            rec[f"{name}_bf16_ms"] = t
            rec[f"{name}_bf16_images_per_s"] = [EVAL_BATCH / v * 1e3
                                                for v in t]
        p16 = tree_map(lambda t: t.to(torch.bfloat16), fparams)
        bias_act.reset_counts()
        graphed = compiled.AutoGraphed(
            lambda xx: (folded.apply(p16, {}, xx)[0],), {}, "folded",
            compiled.GraphFamily(dev))
        for _ in range(2):
            graphed(x)
        torch.cuda.synchronize()
        epi = {"sites": _epilogue_sites(folded),
               "graph_nodes": graphed.graphed.nodes["bias_act"]["epilogue"],
               **bias_act.counts()}
        rec["epilogue"] = epi
        if epi["graph_nodes"] != epi["sites"] or epi["unfused"]:
            failures.append(("epilogue", epi))
        del graphed
    emit(rec)
    if failures:
        raise AssertionError(f"folded forward disagrees: {failures}")
    return epi


def phase_eval(torch, tmpdir, searched):
    """Returns the fused epilogue's counts in the folded net's graphed
    forward (`_folds`)."""
    import numpy as np
    from tfnas_tpu_torch import parsing_model
    from tfnas_tpu_torch.models.eval_net import EvalNetwork

    here = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(tmpdir, "model.config")
    t = time.perf_counter()
    model = parsing_model.main([
        "--model_path", searched, "--save_path", cfg_path, "--print_lat",
        "--lookup_path", os.path.join(here, "latency_pkl", "latency_tpu.pkl")])
    with open(cfg_path) as f:
        parsed = EvalNetwork.from_config(1000, json.load(f), 0.2, 0.2)
    if parsed.config != model.config:
        raise AssertionError("model.config does not build the parsed net")
    emit({"phase": "eval", "step": "parse",
          "ms": 1e3 * (time.perf_counter() - t),
          "depths": [len(b) for b in parsed.stages.values()]})

    with open(os.path.join(here, "configs", "tfnas_a_tpu.config")) as f:
        tfnas_a = EvalNetwork.from_config(1000, json.load(f), 0.2, 0.2)
    state, _ = _retrain(torch, np, "tfnas_a", tfnas_a, EVAL_STEPS + 1,
                        tmpdir, profile=True)
    _retrain(torch, np, "parsed", parsed, 2, tmpdir)
    _test(torch, np, tfnas_a, state)
    return _folds(torch, np, tfnas_a, state)


# -- phase 9 ------------------------------------------------------------------

def _vit_branch_ms(torch, net, params, dtype):
    """Device ms of the 9 ViT branches' forward and backward at the search
    step's shapes (batch 32, 224^2, `dtype`), replayed from one CUDA graph:
    the ViT part of one sampled trunk."""
    from tfnas_tpu_torch.models import search_space as ss
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    items = []
    for g, (stage, block, entry) in net.vit.items():
        res = ss.BLOCK_INPUT_RES[stage][int(block[5:]) - 1]
        x = torch.randn((BATCH, entry[0], res, res), generator=gen,
                        device=dev).to(dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        p = {k: {kk: v.detach().requires_grad_() for kk, v in d.items()}
             for k, d in params[stage][block]["vit"].items()}
        items.append((net.vit_blocks[g], p, x))

    def body():
        for vb, p, x in items:
            y = vb.apply(p, {}, x, training=True)[0]
            leaves = [x] + [v for d in p.values() for v in d.values()]
            torch.autograd.grad(y.float().square().mean(), leaves)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        body()
    graph.replay()
    ms = _events_ms(torch, graph.replay, 5)
    del graph, items
    return ms


def _release(torch):
    """Free the card memory of graphs no longer referenced, those a
    reference cycle keeps too (a train_search run's graphs hold some 10 GB
    of private pools)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_hybrid(torch, fused_dw, tmpdir):
    """The hybrid conv/ViT space on the card: the full-width
    HybridSuperNetwork's eager and captured steps (weight-step draws with a
    ViT pick in each trunk) bit for bit, across an epoch boundary whose
    rewrite changes a ViT mask; step ms in turns; profiles; the driver's
    --space hybrid run captured and --eager; then a hybrid eval net
    retrained, folded and timed. Returns (eager launches by stride, fused
    nodes per replayed step by graph, the driver's replayed launches)."""
    import numpy as np
    from tfnas_tpu_torch import train_search
    from tfnas_tpu_torch.cost.lut import lat_vectors_for_mc, load_lat_lookup
    from tfnas_tpu_torch.cost.measure import measure_model_latency_in_ms
    from tfnas_tpu_torch.data.synthetic import device_batches
    from tfnas_tpu_torch.models import hybrid_space as hs
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.models.supernet_hybrid import HybridSuperNetwork
    from tfnas_tpu_torch.search.bisample import (gumbel_uniform,
                                                 sample_gumbel_indices,
                                                 sample_random_excluding)
    from tfnas_tpu_torch.search.compiled import GraphFamily, copy_tree_
    from tfnas_tpu_torch.search.elasticity import (rewrite_masks_by_l1,
                                                   shrink_or_expand)
    from tfnas_tpu_torch.search.parser import (get_mc_num_dddict,
                                               parse_architecture)
    from tfnas_tpu_torch.search.train_step import (adam_init,
                                                   make_search_steps,
                                                   tree_leaves,
                                                   zeros_like_tree)
    from torch.profiler import ProfilerActivity, profile, record_function

    here = os.path.dirname(os.path.abspath(__file__))
    lut_path = os.path.join(here, "latency_pkl", "latency_h100_hybrid.pkl")
    _release(torch)  # the graphs of the earlier phases' driver runs
    mem0 = torch.cuda.memory_allocated()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    dev = torch.device("cuda")
    lut = load_lat_lookup(lut_path)
    keys = hs.build_lat_lookup_key_dddict()
    net = HybridSuperNetwork(100)
    gen = torch.Generator(device=dev).manual_seed(4)
    t0 = time.perf_counter()
    params, arch = net.init(gen)
    mc_mask = hs.build_mc_mask_dddict()
    valid = net.valid_mask(dev)
    kw = dict(num_classes=100, lambda_lat=0.1, target_lat=HYBRID_TARGET_LAT,
              valid_mask=valid)
    fam = GraphFamily(dev)
    state = fam.adopt({
        "params": params, "arch": arch, "mom": zeros_like_tree(params),
        "opt": adam_init(arch), "masks": net.device_masks(mc_mask, dev),
        "umasks": net.update_masks(params, mc_mask),
        "lat": torch.from_numpy(lat_vectors_for_mc(
            lut, get_mc_num_dddict(mc_mask), keys, hs.NUM_OPS)).to(dev),
        "lr": torch.tensor(0.025, device=dev),
        "T": torch.tensor(5.0, device=dev),
        "base": torch.tensor(float(lut["base"]), device=dev)})
    n_params = sum(p.numel() for p in tree_leaves(params)) / 1e6
    del params, arch
    eager = make_search_steps(net, **kw)
    capt = make_search_steps(net, family=fam, **kw)
    data = device_batches(BATCH, 6, gen, 100, 224, torch.bfloat16)
    batches = [next(data) for _ in range(6)]
    torch.cuda.synchronize()
    emit({"phase": "hybrid", "step": "setup", "init_s":
          time.perf_counter() - t0, "params_M": n_params,
          "lut": os.path.relpath(lut_path, here),
          "mem_GB_before_phase": mem0 / 1e9,
          "vit_keys": sorted(k for k in lut if k.startswith("ViTBlock"))})

    def draws(la, g, kind):
        """Masked draws; the weight step's forced to op 8 at stage5/block1
        (the gumbel pick) and stage6/block1 (its partner)."""
        ig = sample_gumbel_indices(la, g, valid)
        ig[13] = hs.VIT_OP_IDX
        if kind == "warmup":
            return (ig,)
        ig[17] = 0
        ir = sample_random_excluding(ig, hs.NUM_OPS, g, valid)
        ir[17] = hs.VIT_OP_IDX
        return ig, ir

    def call(steps, kind, st, i):
        x, y = batches[i]
        la = st["arch"]["log_alphas"]
        g = torch.Generator(device=dev).manual_seed(200 + i)
        if kind == "arch":
            u = gumbel_uniform(la.shape, g)
            a, o, m = steps.arch_step(st["params"], st["arch"], st["opt"],
                                      st["masks"], x, y, st["lat"],
                                      st["base"], st["T"], u)
            return {"arch": a, "opt": o}, m
        fn = steps.warmup_step if kind == "warmup" else steps.weight_step
        p, mo, m = fn(st["params"], st["arch"], st["mom"], st["masks"],
                      st["umasks"], x, y, st["lr"], *draws(la, g, kind))
        return {"params": p, "mom": mo}, m

    failures = []
    launches = {}   # the eager steps' own launches, by stride

    def check(kind, i, tag):
        snap = _clone(torch, state)
        want, wm = _counted(fused_dw, launches, call, eager, kind, snap, i)
        del snap
        got, gm = call(capt, kind, state, i)
        errs = {k: _tree_err(torch, got[k], want[k]) for k in got}
        errs["metrics"] = _tree_err(torch, gm, wm)
        rec = {"phase": "hybrid", "step": kind, "replay": i, "at": tag,
               "max_abs_err": errs,
               "bit_identical": max(errs.values()) == 0.0,
               "loss": float(gm.get("loss", gm.get("loss_a")))}
        emit(rec)
        if not (rec["bit_identical"] and math.isfinite(rec["loss"])):
            failures.append(rec)
        for k, v in got.items():
            state[k] = v

    # the main path: eager and captured steps; each eager call counted
    fused_dw.reset_launches()
    for i, kind in enumerate(("warmup", "weight", "arch", "weight", "arch")):
        check(kind, i, "start")
    graphs = {g.name: g for g in fam.graphs}
    nodes = {n: dict(g.nodes["fused_dw"]) for n, g in graphs.items()}
    emit({"phase": "hybrid", "step": "graphs",
          "build_s": {n: g.build_s for n, g in graphs.items()},
          "fused_nodes_by_stride": nodes, "eager_launches": launches,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    for name in ("warmup_step", "weight_step", "arch_step"):
        if not (nodes[name].get(1) and nodes[name].get(2)):
            failures.append(f"{name}: fused nodes {nodes[name]}")

    # the epoch boundary: a parsed arch with ViT picks through
    # shrink_or_expand and the L1 rewrite; new masks into the buffers
    op_w = [np.eye(hs.NUM_OPS)[1] for _ in range(18)]
    op_w[13] = op_w[17] = np.eye(hs.NUM_OPS)[hs.VIT_OP_IDX]
    parsed = parse_architecture(op_w, [np.eye(d)[-1] for d in
                                       (2, 3, 4, 4, 4, 1)], space=hs)
    mc_num = get_mc_num_dddict(mc_mask)
    lat_now = lut["base"] + sum(
        lut[keys[s][b][o]][mc_num[s][b][o]]
        for s, d in parsed.items() for b, o in d.items())
    new_num, before, after = shrink_or_expand(
        parsed, mc_num, get_mc_num_dddict(mc_mask, is_max=True), keys, lut,
        0.8 * lat_now)
    old = {s: {b: np.array(mc_mask[s][b][8]) for b in ("block1",)}
           for s in ("stage5", "stage6")}
    mc_mask = rewrite_masks_by_l1(parsed, new_num, mc_mask, state["params"])
    vit_changed = {s: int((old[s]["block1"] != mc_mask[s]["block1"][8])
                          .sum()) for s in old}
    copy_tree_(state["masks"], net.device_masks(mc_mask, dev))
    copy_tree_(state["umasks"], net.update_masks(state["params"], mc_mask))
    copy_tree_(state["lat"], torch.from_numpy(lat_vectors_for_mc(
        lut, get_mc_num_dddict(mc_mask), keys, hs.NUM_OPS)).to(dev))
    emit({"phase": "hybrid", "step": "epoch_boundary", "lat_before": before,
          "lat_after": after, "vit_mask_entries_changed": vit_changed})
    if not any(vit_changed.values()):
        failures.append(f"the rewrite changed no ViT mask: {vit_changed}")
    check("weight", 5, "after_vit_rewrite")
    check("arch", 4, "after_vit_rewrite")

    # eager and captured step ms, in turns
    times = collections.defaultdict(list)
    est = _clone(torch, state)
    for kind in ("weight", "arch"):
        for mode in ("eager", "captured", "captured", "eager"):
            st = est if mode == "eager" else state
            steps = eager if mode == "eager" else capt

            def once():
                out, _ = call(steps, kind, st, 5)
                st.update(out)
            once()
            times[(kind, mode)].append(_events_ms(torch, once, 3))
    emit({"phase": "hybrid", "step": "times_ms",
          **{f"{k}_{m}": v for (k, m), v in times.items()}})
    del est

    # one captured weight and arch step under the profiler; the ViT
    # branches' own device time from a graph of them alone
    vit_ms = _vit_branch_ms(torch, net, state["params"], torch.bfloat16)
    profiles = {}
    for kind, trunks in (("weight", 2), ("arch", 1)):
        trace = os.path.join(tmpdir, f"trace_hybrid_{kind}.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("step"):
                out, _ = call(capt, kind, state, 5)
                torch.cuda.synchronize()
        state.update(out)
        prof.export_chrome_trace(trace)
        summary = _profile_summary(f"hybrid_captured_{kind}", trace)
        os.remove(trace)
        summary["vit_fwd_bwd_ms_per_trunk"] = vit_ms
        summary["vit_share_of_busy"] = (trunks * vit_ms
                                        / summary["device_busy_ms"])
        profiles[kind] = summary
        emit(dict(summary, phase="hybrid_profile"))
    for kind in ("weight", "arch"):
        by_stride = profiles[kind]["fused_dw_ms_by_stride"]
        if not (by_stride.get(1) and by_stride.get(2)):
            failures.append(f"captured hybrid {kind} step: fused kernel "
                            f"device ms by stride {by_stride}")
    del state, capt, eager, fam
    _release(torch)

    # the driver, --space hybrid, captured and --eager
    runs, counts = {}, {}
    for mode in ("captured", "eager"):
        fused_dw.reset_launches()
        t = time.perf_counter()
        run = train_search.main([
            "--synthetic", "--space", "hybrid", "--epochs", "2",
            "--warmup_epochs", "1", "--steps_per_epoch", "4",
            "--save", os.path.join(tmpdir, f"hybrid_{mode}"),
            "--save_freq", "100", "--print_freq", "2",
            "--target_lat", str(HYBRID_TARGET_LAT), "--lookup_path",
            lut_path] + (["--eager"] if mode == "eager" else []))
        runs[mode] = (run, time.perf_counter() - t)
        counts[mode] = {"launches": dict(fused_dw.launches),
                        "replayed": dict(fused_dw.replayed)}
        _release(torch)
    same = {}
    for name in sorted(os.listdir(runs["eager"][0])):
        if name.startswith("arch_params_"):
            with open(os.path.join(runs["captured"][0], name), "rb") as f:
                a = f.read()
            with open(os.path.join(runs["eager"][0], name), "rb") as f:
                same[name] = a == f.read()
    rec = {"phase": "hybrid", "step": "driver", "epochs": 2,
           "seconds": {m: r[1] for m, r in runs.items()},
           "fused_dw_counts": counts, "arch_params_bytes_identical": same}
    emit(rec)
    for mode in runs:
        shutil.rmtree(runs[mode][0])
    if not (len(same) == 3 and all(same.values())):
        failures.append(rec)
    if not all(counts["captured"]["replayed"].values()):
        failures.append(f"the captured hybrid driver replayed no fused "
                        f"kernel of some stride: {counts}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det

    # a hybrid eval net: ViT at stage5/block1 and stage6/block1
    eval_parsed = parse_architecture(op_w, [np.eye(d)[-1] for d in
                                            (2, 3, 4, 4, 4, 1)], space=hs)
    evnet = EvalNetwork.from_parsed_arch(
        1000, eval_parsed, get_mc_num_dddict(hs.build_mc_mask_dddict()),
        0.2, 0.2)
    n_vit = sum(b.name == "ViTBlock" for _, _, b in evnet.iter_blocks())
    fused_dw.reset_launches()
    estate, _ = _retrain(torch, np, "hybrid", evnet, 2, tmpdir)
    _folds(torch, np, evnet, estate)
    lat32 = measure_model_latency_in_ms(evnet, BATCH, 224, torch.bfloat16,
                                        device=dev)
    rec = {"phase": "hybrid", "step": "eval", "vit_blocks": n_vit,
           "config_vit": [c for s in ("stage5", "stage6")
                          for c in evnet.config[s]
                          if c["name"] == "ViTBlock"],
           "lut_ms": evnet.get_lookup_latency(lut),
           "folded_bf16_ms_bs32": lat32,
           "fused_dw_launches": sum(fused_dw.launches.values())}
    emit(rec)
    if n_vit != 2 or not (math.isfinite(lat32) and lat32 > 0):
        failures.append(rec)
    if failures:
        raise AssertionError(f"hybrid phase: {failures}")
    return launches, nodes, counts["captured"]["replayed"]


# -- phase 10 -----------------------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_parallel(torch, fused_dw, tmpdir):
    """The Pareto search and data parallelism on the card: the full-width
    MBConv Pareto steps of G = 2 targets (one card holds both groups and
    runs them in turn) captured against eager bit for bit, each group's
    steps against a single search's step from the same state and draws,
    step ms in turns and peak memory; the train_search_pareto driver
    captured and --eager (equal per-group pickles); then a 1-rank NCCL
    process group: the TF-NAS-A data-parallel train step and one Pareto
    weight and arch step with the group against group=None, eager and
    captured, bit for bit. Returns (eager launches by stride, fused nodes
    per replayed Pareto step by kind, the driver's replayed launches)."""
    import torch.distributed as dist
    from tfnas_tpu_torch import train_search_pareto
    from tfnas_tpu_torch.cost.lut import lat_vectors_for_mc, load_lat_lookup
    from tfnas_tpu_torch.data.synthetic import device_batches
    from tfnas_tpu_torch.models import search_space as ss
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.models.supernet import SuperNetwork
    from tfnas_tpu_torch.parallel import pareto, train_dp
    from tfnas_tpu_torch.parallel.mesh import ParetoMesh, make_mesh, pair_seed
    from tfnas_tpu_torch.search.bisample import (gumbel_uniform,
                                                 sample_gumbel_indices,
                                                 sample_random_excluding)
    from tfnas_tpu_torch.search.compiled import AutoGraphed, GraphFamily
    from tfnas_tpu_torch.search.parser import get_mc_num_dddict
    from tfnas_tpu_torch.search.train_step import make_search_steps

    here = os.path.dirname(os.path.abspath(__file__))
    lut_path = os.path.join(here, "latency_pkl", "latency_h100.pkl")
    _release(torch)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    dev = torch.device("cuda")
    lut = load_lat_lookup(lut_path)
    keys = ss.build_lat_lookup_key_dddict()
    G = len(PARETO_TARGETS)
    failures = []
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    def group_inputs(net, groups, fam):
        """The state and step inputs of `groups` (initial widths), in
        fam's static buffers when fam is given."""
        st = pareto.init_pareto_state(net, [
            torch.Generator(device=dev).manual_seed(pair_seed(2, g))
            for g in groups])
        mc = ss.build_mc_mask_dddict()
        lat = torch.from_numpy(lat_vectors_for_mc(
            lut, get_mc_num_dddict(mc), keys, ss.NUM_OPS)).to(dev)
        inp = {"state": st,
               "masks": [net.device_masks(mc, dev) for _ in groups],
               "umasks": [net.update_masks(p, mc) for p in st.params],
               "lat": [lat.clone() for _ in groups],
               "lr": [torch.tensor(0.025, device=dev) for _ in groups],
               "T": [torch.tensor(5.0, device=dev) for _ in groups],
               "base": torch.tensor(float(lut["base"]), device=dev)}
        return inp if fam is None else fam.adopt(inp)

    gen = torch.Generator(device=dev).manual_seed(5)
    data = device_batches(BATCH, 2 * 6, gen, 100, 224, torch.bfloat16)
    flat = [next(data) for _ in range(2 * 6)]
    batches = [(torch.stack([flat[2 * i][0], flat[2 * i + 1][0]]),
                torch.stack([flat[2 * i][1], flat[2 * i + 1][1]]))
               for i in range(6)]
    del flat

    def draws(st, i, kind):
        """Group j's draws of call i: its own generator, as the driver's
        are seeded by the group."""
        out = []
        for j, a in enumerate(st.arch_params):
            g = torch.Generator(device=dev).manual_seed(300 + 10 * i + j)
            la = a["log_alphas"]
            if kind == "weight":
                ig = sample_gumbel_indices(la, g)
                out.append((ig, sample_random_excluding(ig, ss.NUM_OPS, g)))
            else:
                out.append(gumbel_uniform(la.shape, g))
        return out

    def call(steps, kind, s, i):
        x, y = batches[i]
        d = draws(s["state"], i, kind)
        if kind == "weight":
            st, m = steps[0](s["state"], s["masks"], s["umasks"], x, y,
                             s["lr"], d)
        else:
            st, m = steps[1](s["state"], s["masks"], x, y, s["lat"],
                             s["base"], s["T"], d)
        return st, m, d

    # G = 2 on one card: captured against eager, every count at 0 first
    t0 = time.perf_counter()
    net = SuperNetwork(100)
    mesh = make_mesh(1, G, 0)
    fam = GraphFamily(dev)
    s = group_inputs(net, mesh.local_groups, fam)
    kw = dict(num_classes=100, targets=PARETO_TARGETS)
    eager = pareto.make_pareto_search_steps(net, mesh, **kw)
    capt = pareto.make_pareto_search_steps(net, mesh, family=fam, **kw)
    torch.cuda.synchronize()
    emit({"phase": "parallel", "step": "setup", "groups": G,
          "targets_ms": list(PARETO_TARGETS), "init_s":
          time.perf_counter() - t0, "lut": os.path.relpath(lut_path, here),
          "mem_GB_state": (torch.cuda.memory_allocated() - mem0) / 1e9})
    fused_dw.reset_launches()
    launches = {}   # the eager Pareto steps' own launches, by stride
    for i, kind in enumerate(("weight", "arch", "weight", "arch")):
        snap = _clone(torch, s)
        est, em, d = _counted(fused_dw, launches, call, eager, kind, snap, i)
        cst, cm, _ = call(capt, kind, s, i)
        errs = [_tree_err(torch, [f[j] for f in est], [f[j] for f in cst])
                for j in range(G)]
        rec = {"phase": "parallel", "step": kind, "call": i,
               "max_abs_err_by_group": errs,
               "metrics_err": _tree_err(torch, em, cm),
               "loss": (cm.get("loss", cm.get("loss_a"))).tolist()}
        if i < 2:
            # each group against one search's step from the same state
            single = []
            for j, g in enumerate(mesh.local_groups):
                one = make_search_steps(net, num_classes=100,
                                        target_lat=PARETO_TARGETS[g])
                ss_ = snap["state"]
                if kind == "weight":
                    p, mo, _ = one.weight_step(
                        ss_.params[j], ss_.arch_params[j], ss_.momentum[j],
                        snap["masks"][j], snap["umasks"][j],
                        batches[i][0][j], batches[i][1][j], snap["lr"][j],
                        *d[j])
                    single.append(_tree_err(torch, [p, mo], [
                        est.params[j], est.momentum[j]]))
                else:
                    a, o, _ = one.arch_step(
                        ss_.params[j], ss_.arch_params[j], ss_.opt_a[j],
                        snap["masks"][j], batches[i][0][j],
                        batches[i][1][j], snap["lat"][j], snap["base"],
                        snap["T"][j], d[j])
                    single.append(_tree_err(torch, [a, o], [
                        est.arch_params[j], est.opt_a[j]]))
            rec["single_search_err_by_group"] = single
            if max(single) != 0.0:
                failures.append(rec)
        del snap, est, em
        emit(rec)
        if not (max(errs) == 0.0 and rec["metrics_err"] == 0.0
                and all(math.isfinite(v) for v in rec["loss"])):
            failures.append(rec)
        s["state"] = cst
    nodes = {k: {st: sum(gr.nodes["fused_dw"][st] for gr in fam.graphs
                         if gr.name == f"{k}_step") for st in (1, 2)}
             for k in ("weight", "arch")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "parallel", "step": "graphs",
          "graphs": [gr.name for gr in fam.graphs],
          "build_s": [gr.build_s for gr in fam.graphs],
          "fused_nodes_per_pareto_step": nodes, "eager_launches": launches,
          "replayed": dict(fused_dw.replayed), "peak_mem_GB": peak})
    for k, n in nodes.items():
        if not (n[1] and n[2]):
            failures.append(f"captured Pareto {k} step: fused nodes {n}")

    # eager and captured Pareto step ms (both groups), in turns
    times = collections.defaultdict(list)
    est = _clone(torch, s)
    for kind in ("weight", "arch"):
        for mode in ("eager", "captured", "captured", "eager"):
            st_in, steps = (est, eager) if mode == "eager" else (s, capt)

            def once():
                st_in["state"] = call(steps, kind, st_in, 5)[0]
            once()
            times[(kind, mode)].append(_events_ms(torch, once, 3))
    emit({"phase": "parallel", "step": "times_ms", "groups": G,
          **{f"{k}_{m}": v for (k, m), v in times.items()},
          **{f"{k}_{m}_per_group": [t / G for t in v]
             for (k, m), v in times.items()},
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    del est, s, eager, capt, fam
    _release(torch)

    # the driver, captured and --eager: the same per-group pickles
    runs, counts = {}, {}
    for mode in ("captured", "eager"):
        fused_dw.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        run = train_search_pareto.main([
            "--synthetic", "--target_lats",
            ",".join(str(v) for v in PARETO_TARGETS), "--epochs", "2",
            "--warmup_epochs", "1", "--steps_per_epoch", "4",
            "--batch_size", str(BATCH), "--print_freq", "2",
            "--lookup_path", lut_path,
            "--save", os.path.join(tmpdir, f"pareto_{mode}")]
            + (["--eager"] if mode == "eager" else []))
        runs[mode] = (run, time.perf_counter() - t,
                      torch.cuda.max_memory_allocated() / 1e9,
                      torch.cuda.max_memory_reserved() / 1e9)
        counts[mode] = {"launches": dict(fused_dw.launches),
                        "replayed": dict(fused_dw.replayed)}
        _release(torch)
    same = {}
    for name in sorted(os.listdir(runs["eager"][0])):
        if name.endswith(".pkl"):
            with open(os.path.join(runs["captured"][0], name), "rb") as f:
                a = f.read()
            with open(os.path.join(runs["eager"][0], name), "rb") as f:
                same[name] = a == f.read()
    rec = {"phase": "parallel", "step": "driver", "epochs": 2,
           "seconds": {m: r[1] for m, r in runs.items()},
           "peak_mem_GB": {m: r[2] for m, r in runs.items()},
           "peak_reserved_GB": {m: r[3] for m, r in runs.items()},
           "fused_dw_counts": counts, "pickles_bytes_identical": same}
    emit(rec)
    for mode in runs:
        shutil.rmtree(runs[mode][0])
    if not (len(same) == 2 * G and all(same.values())):
        failures.append(rec)
    if not (counts["captured"]["replayed"].get(1)
            and counts["captured"]["replayed"].get(2)):
        failures.append(f"the captured Pareto driver replayed no fused "
                        f"kernel of some stride: {counts}")
    # G = 4 on the card: does it fit? (one epoch of 2 batches, with arch
    # steps)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run = train_search_pareto.main([
        "--synthetic", "--target_lats", "4.5,5.0,5.5,6.0", "--epochs", "1",
        "--warmup_epochs", "0", "--steps_per_epoch", "2", "--batch_size",
        str(BATCH), "--print_freq", "2", "--lookup_path", lut_path,
        "--save", os.path.join(tmpdir, "pareto_g4")])
    emit({"phase": "parallel", "step": "driver_g4", "groups": 4,
          "seconds": time.perf_counter() - t,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
          "peak_reserved_GB": torch.cuda.max_memory_reserved() / 1e9,
          "pickles": sorted(os.listdir(run))})
    shutil.rmtree(run)
    _release(torch)

    # a 1-rank NCCL process group against group=None. The group is left
    # only after every graph holding its collectives is freed (the checks'
    # locals); a failure raises with them alive and the process exits.
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    world = dist.group.WORLD

    def nccl_checks():
        with open(os.path.join(here, "configs", "tfnas_a_tpu.config")) as f:
            enet = EvalNetwork.from_config(1000, json.load(f), 0.2, 0.2)
        g = torch.Generator(device=dev).manual_seed(11)
        st0 = train_dp.init_eval_train_state(enet, g)
        x, y = next(device_batches(EVAL_BATCH, 1, g, 1000, 224,
                                   torch.bfloat16))
        keep = enet.draw_keep(EVAL_BATCH, g)

        def fresh():
            return train_dp.EvalTrainState(*(
                _clone(torch, t) for t in st0[:3]), 0)

        dp, dp_graphs = {}, {}
        for name, group in (("none", None), ("nccl", world)):
            train, _ = train_dp.make_eval_steps(enet, num_classes=1000,
                                                group=group, capture=False)
            graphed = AutoGraphed(train, {0: 0}, f"dp_train_{name}",
                                  GraphFamily(dev))
            for mode, fn in (("eager", train), ("captured", graphed)):
                new, m = fn(fresh(), x, y, 0.1, keep)
                dp[(name, mode)] = _clone(torch, [new[:3], m])
            dp_graphs[name] = graphed
            del new, m
        dp_err = {m: _tree_err(torch, dp[("none", m)], dp[("nccl", m)])
                  for m in ("eager", "captured")}
        # the collectives' cost: replays of the two graphs in turns
        dp_ms = collections.defaultdict(list)
        for name in ("none", "nccl", "nccl", "none"):
            dp_ms[name].append(_events_ms(
                torch, dp_graphs[name].graphed.graph.replay, 3))
        del dp, dp_graphs, graphed, train, st0
        _release(torch)

        # one Pareto weight and arch step of one group
        mesh0 = make_mesh(1, 1, 0)
        meshn = ParetoMesh(1, (0,), world, 0, 1)
        base = group_inputs(SuperNetwork(100), (0,), None)
        par, fams = {}, {}
        for mode in ("eager", "captured"):
            for name, m_ in (("none", mesh0), ("nccl", meshn)):
                pfam = GraphFamily(dev) if mode == "captured" else None
                pnet = SuperNetwork(100, bn_group=m_.data_group)
                steps = pareto.make_pareto_search_steps(
                    pnet, m_, num_classes=100, targets=PARETO_TARGETS[:1],
                    family=pfam)
                st_in = _clone(torch, base)
                if pfam is not None:
                    st_in = pfam.adopt(st_in)
                    fams[name] = pfam
                st_in["state"], wm, _ = call(steps, "weight", st_in, 0)
                st_in["state"], am, _ = call(steps, "arch", st_in, 1)
                par[(name, mode)] = _clone(torch, [st_in["state"], wm, am])
                del steps, st_in, pfam
        par_err = {m: _tree_err(torch, par[("none", m)], par[("nccl", m)])
                   for m in ("eager", "captured")}
        par_ms = collections.defaultdict(list)
        for kind in ("weight_step", "arch_step"):
            for name in ("none", "nccl", "nccl", "none"):
                gr = next(g for g in fams[name].graphs if g.name == kind)
                par_ms[f"{kind}_{name}"].append(_events_ms(
                    torch, gr.graph.replay, 3))
        return dp_err, par_err, dp_ms, par_ms

    dp_err, par_err, dp_ms, par_ms = nccl_checks()
    _release(torch)
    dist.destroy_process_group()
    rec = {"phase": "parallel", "step": "nccl_one_rank",
           "dp_train_step_tfnas_a_err": dp_err,
           "pareto_weight_arch_err": par_err,
           "captured_ms_in_turns": {"dp_train_tfnas_a_bs256": dict(dp_ms),
                                    **par_ms},
           "bit_identical": max(list(dp_err.values())
                                + list(par_err.values())) == 0.0}
    emit(rec)
    if not rec["bit_identical"]:
        failures.append(rec)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    _release(torch)
    if failures:
        raise AssertionError(f"parallel phase: {failures}")
    return launches, nodes, counts["captured"]["replayed"]


# -- phase 11 -----------------------------------------------------------------

KINDS = ("warmup", "weight", "arch")


def _in_turns(torch, fns, turns=3, n=3):
    """ms per call of each fn, n calls each time (CUDA events), in turns:
    the order of the fns is reversed every second turn."""
    out = {k: [] for k in fns}
    names = list(fns)
    for t in range(turns):
        for k in (names if t % 2 == 0 else names[::-1]):
            fns[k]()
            out[k].append(_events_ms(torch, fns[k], n))
    return out


def _close_or_fail(failures, rec, errs, tol=1e-5):
    worst = max(errs.values())
    rec.update(max_abs_err=errs, bit_identical=worst == 0.0, tol=tol)
    emit(rec)
    if not worst <= tol:
        failures.append(rec)


def phase_lowerings(torch, fused_dw, tmpdir):
    """The JAX package's opt-in lowerings at full width (batch 32, 224^2,
    100 classes, bf16, latency_pkl/latency_h100.pkl), one set of params,
    masks, batches and draws for all, cuDNN deterministic: remat_blocks
    (captured = eager = no remat, nodes, peak memory, ms in turns), the
    soft path's four lowerings (captured = eager arch steps, log_alphas
    against einsum, ms in turns, nodes), cond_width_split (eager only:
    loss against the plain net, ms in turns, capture refused),
    apply_multi_sampled (f32 logits against apply_sampled_pair, captured
    fwd + bwd ms in turns), `train_search --profile_steps 2` (a trace with
    both kernel strides) and `python -m tfnas_tpu_torch.tools_profile`.
    Returns the fused kernel launches (or nodes) of each path by stride."""
    from tfnas_tpu_torch import train_search
    from tfnas_tpu_torch.cost.lut import lat_vectors_for_mc, load_lat_lookup
    from tfnas_tpu_torch.data.synthetic import device_batches
    from tfnas_tpu_torch.models import search_space as ss
    from tfnas_tpu_torch.models.supernet import SuperNetwork
    from tfnas_tpu_torch.search.bisample import (gumbel_uniform,
                                                 sample_gumbel_indices,
                                                 sample_random_excluding)
    from tfnas_tpu_torch.search.compiled import AutoGraphed, GraphFamily
    from tfnas_tpu_torch.search.parser import get_mc_num_dddict
    from tfnas_tpu_torch.search.train_step import (adam_init,
                                                   make_search_steps,
                                                   value_and_grad,
                                                   zeros_like_tree)
    from tfnas_tpu_torch.tools_ab_ksplit import VARIANTS
    from tfnas_tpu_torch.utils.metrics import cross_entropy

    here = os.path.dirname(os.path.abspath(__file__))
    lut_path = os.path.join(here, "latency_pkl", "latency_h100.pkl")
    _release(torch)  # the Pareto phase's graph pools
    t_phase = time.perf_counter()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    dev = torch.device("cuda")
    lut = load_lat_lookup(lut_path)
    gen = torch.Generator(device=dev).manual_seed(11)
    plain = SuperNetwork(100)
    params, arch = plain.init(gen)
    mc_mask = ss.build_mc_mask_dddict()
    start = {"params": params, "arch": arch, "mom": zeros_like_tree(params),
             "opt": adam_init(arch),
             "masks": plain.device_masks(mc_mask, dev),
             "umasks": plain.update_masks(params, mc_mask),
             "lat": torch.from_numpy(lat_vectors_for_mc(
                 lut, get_mc_num_dddict(mc_mask))).to(dev),
             "lr": torch.tensor(0.025, device=dev),
             "T": torch.tensor(5.0, device=dev),
             "base": torch.tensor(float(lut["base"]), device=dev)}
    del params
    data = device_batches(BATCH, 3, gen, 100, 224, torch.bfloat16)
    batches = [next(data) for _ in range(3)]
    ig = sample_gumbel_indices(arch["log_alphas"], gen)
    ir = sample_random_excluding(ig, ss.NUM_OPS, gen)
    u = gumbel_uniform(arch["log_alphas"].shape, gen)
    kw = dict(num_classes=100, lambda_lat=0.1, target_lat=5.0)
    failures, counts = [], {}
    fused_dw.reset_launches()  # every count at 0 before the paths

    def call(steps, kind, st, i):
        x, y = batches[i]
        if kind == "arch":
            a, o, m = steps.arch_step(st["params"], st["arch"], st["opt"],
                                      st["masks"], x, y, st["lat"],
                                      st["base"], st["T"], u)
            return {"arch": a, "opt": o}, m
        if kind == "warmup":
            p, mo, m = steps.warmup_step(st["params"], st["arch"], st["mom"],
                                         st["masks"], st["umasks"], x, y,
                                         st["lr"], ig)
        else:
            p, mo, m = steps.weight_step(st["params"], st["arch"], st["mom"],
                                         st["masks"], st["umasks"], x, y,
                                         st["lr"], ig, ir)
        return {"params": p, "mom": mo}, m

    def run_steps(steps, st, peaks=None):
        """A warmup, a weight and an arch step in turn, the state carried
        on; each result cloned; peaks: each eager step's peak memory above
        what was allocated before it, GB."""
        outs = []
        for i, kind in enumerate(KINDS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out, m = call(steps, kind, st, i)
            torch.cuda.synchronize()
            if peaks is not None:
                peaks[kind] = (torch.cuda.max_memory_allocated()
                               - before) / 1e9
            outs.append(_clone(torch, dict(out, metrics=m)))
            st.update(out)
        return outs

    # remat_blocks: eager (the reference and the memory), then captured
    nets = {"remat": SuperNetwork(100, remat_blocks=True), "plain": plain}
    peaks = {name: {} for name in nets}
    eager_remat = run_steps(make_search_steps(nets["remat"], **kw),
                            _clone(torch, start), peaks["remat"])
    eager_plain = run_steps(make_search_steps(plain, **kw),
                            _clone(torch, start), peaks["plain"])
    for i, kind in enumerate(KINDS):
        _close_or_fail(failures, {"phase": "lowerings", "step": "remat",
                                  "check": f"eager {kind}: remat vs plain"},
                       {"all": _tree_err(torch, eager_remat[i],
                                         eager_plain[i])})
    del eager_plain
    _release(torch)
    capt, cst, outs, reserved = {}, {}, {}, {}
    for name, net in nets.items():  # a family (one graph pool) each
        r0 = torch.cuda.memory_reserved()
        fam = GraphFamily(dev)
        capt[name] = make_search_steps(net, family=fam, **kw)
        cst[name] = fam.adopt(start)  # static copies of the state
        outs[name] = run_steps(capt[name], cst[name])
        reserved[name] = (torch.cuda.memory_reserved() - r0) / 1e9
        if name == "remat":
            for i, kind in enumerate(KINDS):
                _close_or_fail(failures, {
                    "phase": "lowerings", "step": "remat",
                    "check": f"{kind}: captured vs eager"},
                    {"all": _tree_err(torch, outs[name][i], eager_remat[i])})
            del eager_remat
    for i, kind in enumerate(KINDS):
        _close_or_fail(failures, {
            "phase": "lowerings", "step": "remat",
            "check": f"{kind}: captured remat vs captured plain"},
            {"all": _tree_err(torch, outs["remat"][i], outs["plain"][i])})
    del outs
    nodes = {name: {k: dict(getattr(capt[name], f"{k}_step").graphed.nodes[
        "fused_dw"]) for k in KINDS} for name in nets}
    counts.update({f"remat_{k}_step_nodes": nodes["remat"][k]
                   for k in KINDS})

    def stepper(name, kind, i):
        return lambda: call(capt[name], kind, cst[name], i)
    times = {kind: _in_turns(torch, {n: stepper(n, kind, i)
                                     for n in nets})
             for i, kind in ((1, "weight"), (2, "arch"))}
    emit({"phase": "lowerings", "step": "remat", "fused_nodes": nodes,
          "peak_mem_GB_eager_step": peaks,
          "reserved_GB_graphs_and_state_copy": reserved,
          "captured_ms_in_turns": times})
    for k in KINDS:
        if nodes["remat"][k] != {s: 2 * n
                                 for s, n in nodes["plain"][k].items()}:
            failures.append(f"remat {k} nodes {nodes['remat'][k]} against "
                            f"{nodes['plain'][k]} without remat")
    del capt, cst, fam
    _release(torch)

    # the soft path's lowerings: the real arch step of each
    fam = GraphFamily(dev)
    shared = fam.adopt(start)
    res = {}
    for name, flags in VARIANTS.items():
        net = SuperNetwork(100, **flags)
        eager = make_search_steps(net, **kw)
        want, wm = call(eager, "arch", dict(start, arch=_clone(torch, arch),
                                            opt=adam_init(arch)), 2)
        steps = make_search_steps(net, family=fam, **kw)
        st = dict(shared, arch=fam.adopt(_clone(torch, arch)),
                  opt=fam.adopt(adam_init(arch)))
        got, gm = call(steps, "arch", st, 2)
        _close_or_fail(failures, {"phase": "lowerings", "step": "soft",
                                  "variant": name,
                                  "check": "arch step: captured vs eager"},
                       {"all": _tree_err(torch, [got, gm], [want, wm])})
        res[name] = {"steps": steps, "st": st, "loss_a": float(wm["loss_a"]),
                     "log_alphas": want["arch"]["log_alphas"],
                     "nodes": dict(steps.arch_step.graphed.nodes["fused_dw"])}
    ref = res["einsum"]
    soft = {"phase": "lowerings", "step": "soft", "variants": {}}
    for name, r in res.items():
        d_la = (r["log_alphas"] - ref["log_alphas"]).abs().max().item()
        d_loss = abs(r["loss_a"] - ref["loss_a"]) / abs(ref["loss_a"])
        soft["variants"][name] = {"fused_nodes": r["nodes"],
                                  "loss_a": r["loss_a"],
                                  "max_abs_log_alphas_vs_einsum": d_la,
                                  "loss_a_rel_vs_einsum": d_loss}
        # one Adam step moves an entry by at most its lr: bf16 rounding can
        # flip the sign of a near-zero gradient, nothing more
        if not (d_la <= 2.5 * 0.01 and d_loss <= 2e-2):
            failures.append(f"{name}: log_alphas {d_la}, loss_a {d_loss} "
                            f"from einsum's")
    counts["dw_kernel_split_arch_step_nodes"] = res["ksplit+einsum"]["nodes"]
    soft["captured_arch_ms_in_turns"] = _in_turns(torch, {
        name: (lambda r=r: call(r["steps"], "arch", r["st"], 2))
        for name, r in res.items()})
    emit(soft)
    if any(res[n]["nodes"].get(s) for n in ("ksplit+einsum",
                                            "ksplit+grouped")
           for s in (1, 2)):
        failures.append("the ksplit soft blocks recorded fused nodes")
    del res, shared, fam, soft
    _release(torch)

    # cond_width_split: eager only
    cws = SuperNetwork(100, cond_width_split=True)
    try:
        make_search_steps(cws, family=GraphFamily(dev), **kw)
        failures.append("capture of a cond_width_split net was not refused")
        refused = False
    except ValueError:
        refused = True
    ests = {"cond_width_split": (make_search_steps(cws, **kw),
                                 _clone(torch, start)),
            "plain": (make_search_steps(plain, **kw), _clone(torch, start))}
    cw_launches, losses = {}, {}
    for name, (steps, st) in ests.items():
        into = {}
        out, m = _counted(fused_dw, into, call, steps, "weight", st, 1)
        cw_launches[name] = into
        losses[name] = float(m["loss"])
        st.update(out)
    counts["cond_width_split_forward"] = {
        s: n // 2 for s, n in cw_launches["cond_width_split"].items()}
    d_loss = abs(losses["cond_width_split"] - losses["plain"]) / abs(
        losses["plain"])

    def eager_weight(name):
        steps, st = ests[name]
        return lambda: st.update(call(steps, "weight", st, 1)[0])
    rec = {"phase": "lowerings", "step": "cond_width_split",
           "capture_refused": refused, "losses": losses,
           "loss_rel_vs_plain": d_loss,
           "e3_picks": int((ig % 2 == 0).sum() + (ir % 2 == 0).sum()),
           "weight_step_launches": cw_launches,
           "eager_weight_ms_in_turns": _in_turns(
               torch, {n: eager_weight(n) for n in ests})}
    emit(rec)
    if not d_loss <= 2e-2:
        failures.append(rec)
    del ests
    _release(torch)

    # apply_multi_sampled: f32 logits (TF32 off) against the pair, then
    # the captured bf16 fwd + bwd of both, in turns
    idx = torch.stack([ig, ir])
    x, y = batches[1]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multi_launches, pair_launches = {}, {}
    with torch.no_grad():
        lm = _counted(fused_dw, multi_launches, plain.apply_multi_sampled,
                      start["params"], arch, start["masks"], x.float(), idx)
        lp = torch.stack(_counted(fused_dw, pair_launches,
                                  plain.apply_sampled_pair, start["params"],
                                  arch, start["masks"], x.float(), ig, ir))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    err = (lm - lp).abs().max().item()
    tol = 1e-4 * lp.abs().max().item()
    counts["multi_forward"] = multi_launches

    def multi_loss(p, xx, yy):
        def loss(q):
            lg = plain.apply_multi_sampled(q, arch, start["masks"], xx, idx)
            return cross_entropy(lg[0], yy) + cross_entropy(lg[1], yy), None
        return value_and_grad(loss, p)

    def pair_loss(p, xx, yy):
        def loss(q):
            lg, lr = plain.apply_sampled_pair(q, arch, start["masks"], xx,
                                              ig, ir)
            return cross_entropy(lg, yy) + cross_entropy(lr, yy), None
        return value_and_grad(loss, p)
    fam = GraphFamily(dev)
    args = fam.adopt([start["params"], x, y])
    graphs = {"multi": AutoGraphed(multi_loss, {}, "multi_fwd_bwd", fam),
              "pair": AutoGraphed(pair_loss, {}, "pair_fwd_bwd", fam)}
    got = {n: _clone(torch, g(*args)) for n, g in graphs.items()}
    counts["multi_fwd_bwd_nodes"] = dict(
        graphs["multi"].graphed.nodes["fused_dw"])
    d_loss = abs(got["multi"][0][0].item() - got["pair"][0][0].item()) / abs(
        got["pair"][0][0].item())
    rec = {"phase": "lowerings", "step": "multi",
           "f32_logits_max_abs_err": err, "tol": tol,
           "forward_launches": {"multi": multi_launches,
                                "pair": pair_launches},
           "fused_nodes": {n: g.graphed.nodes["fused_dw"]
                           for n, g in graphs.items()},
           "bf16_loss_rel_vs_pair": d_loss,
           "bf16_grad_max_abs_err_vs_pair": _tree_err(
               torch, got["multi"][1], got["pair"][1]),
           "captured_fwd_bwd_ms_in_turns": _in_turns(torch, {
               n: (lambda g=g: g(*args)) for n, g in graphs.items()})}
    emit(rec)
    if not (err <= tol and d_loss <= 2e-2):
        failures.append(rec)
    del graphs, got, args, fam
    _release(torch)

    # the driver's profiler: one warmup epoch of 4 batches, 2 traced steps
    save = os.path.join(tmpdir, "lowerings_driver")
    run_dir = train_search.main([
        "--synthetic", "--epochs", "1", "--warmup_epochs", "1",
        "--steps_per_epoch", "4", "--batch_size", str(BATCH),
        "--image_size", "224", "--num_classes", "100", "--lookup_path",
        lut_path, "--target_lat", "5.0", "--profile_steps", "2",
        "--save", save])
    trace = os.path.join(run_dir, "profile", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    by_stride = collections.Counter(
        _fused_stride(e["name"]) for e in events
        if e.get("cat") == "kernel" and "fused_dw" in e.get("name", ""))
    rec = {"phase": "lowerings", "step": "driver_profile_steps",
           "trace_MB": os.path.getsize(trace) / 1e6,
           "kernel_events": sum(e.get("cat") == "kernel" for e in events),
           "fused_dw_events_by_stride": dict(by_stride)}
    emit(rec)
    if not (by_stride.get(1) and by_stride.get(2)):
        failures.append(rec)
    del events
    shutil.rmtree(save)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    _release(torch)

    # the profiling tool as a user runs it
    proc = subprocess.run(
        [sys.executable, "-m", "tfnas_tpu_torch.tools_profile", "--only",
         "sampled fwd"], cwd=here, capture_output=True, text=True,
        timeout=240)
    rec = {"phase": "lowerings", "step": "tools_profile", "rc":
           proc.returncode}
    try:
        rec["last_line"] = json.loads(proc.stdout.strip().splitlines()[-1])
        ok = proc.returncode == 0 and rec["last_line"]["ms"] and all(
            math.isfinite(v) for v in rec["last_line"]["ms"].values())
    except (IndexError, ValueError, KeyError):
        rec["stderr"], ok = proc.stderr[-2000:], False
    emit(rec)
    if not ok:
        failures.append(rec)

    emit({"phase": "lowerings", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"lowerings phase: {failures}")
    return counts


# -- phase 12 -----------------------------------------------------------------

LARGE_BATCHES = (128, 256)  # the search batches the occupancy tool sweeps
# The card's share each lane of phase 12's tools may reserve. Alone at the
# smoke's sizes (on an H100 80GB HBM3, 85.0 GB) the tools peak at
# 46.6 GB (occupancy), 35.3 (hybrid) and 1.9 (eval) in the first lane, and
# 17.4 (occupancy with remat), 23.4 (scan) and the loader's little in the
# second. The rest of the card is the smoke's own and each tool process's
# context (TOOL_CONTEXT_GB, outside the allocator's count).
LANE_FRACTIONS = (0.575, 0.30)
TOOL_CONTEXT_GB = 1.5


def _check_forward(torch, fused_dw, gen, n, h, c, stride, act, dtype):
    """The kernel's forward (y and the two sums) against the plain version
    at one shape, and its rerun bit for bit; no backward (cuDNN's), so
    that batch 256 at the largest sites fits beside the inputs."""
    bf = dtype == torch.bfloat16
    x, wk, scale, offset = _inputs(torch, gen, h, c, dtype, n)
    with torch.no_grad():
        got = fused_dw.fused_dw_cuda(x, wk, scale, offset, stride, act)
        want = fused_dw.fused_dw_plain(x, wk, scale, offset, stride, act)
        err_y, tol_y, err_s, err_q = _forward_errors(got, want, bf)
        del want
        again = fused_dw.fused_dw_cuda(x, wk, scale, offset, stride, act)
        same = all(torch.equal(a, b) for a, b in zip(again, got))
    ok = err_y <= tol_y and err_s <= 1.0 and err_q <= 1.0 and same
    return {"phase": "tools", "step": "kernel_large_batch", "n": n, "h": h,
            "c": c, "stride": stride, "act": act,
            "dtype": "bf16" if bf else "f32", "elements": x.numel(),
            "max_abs_err_y": err_y, "tol_y": tol_y,
            "sum_err_over_tol": err_s, "sumsq_err_over_tol": err_q,
            "bit_identical_rerun": same, "ok": ok}


# A tool as `python -m tfnas_tpu_torch.<tool>` runs it, under a cap on its
# share of the card's memory (the caching allocator raises past it, graph
# pools included), with its peak reserved memory as stderr's last line.
_CAPPED_TOOL = """import json, runpy, sys, torch
torch.cuda.set_per_process_memory_fraction(float(sys.argv.pop(1)))
tool = sys.argv.pop(1)
try:
    runpy.run_module(tool, run_name="__main__", alter_sys=True)
finally:
    print(json.dumps({"peak_reserved_GB":
                      torch.cuda.max_memory_reserved() / 1e9}),
          file=sys.stderr, flush=True)
"""


def _tool_lane(here, commands, fraction, timeout):
    """Run the tool commands one after another, each capped at `fraction`
    of the card's memory; yields (name, argv, proc, seconds)."""
    for name, argv in commands:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _CAPPED_TOOL, str(fraction),
             f"tfnas_tpu_torch.{argv[0]}", *argv[1:]],
            cwd=here, capture_output=True, text=True, timeout=timeout)
        yield name, argv, proc, time.perf_counter() - t


def _peak_reserved(stderr):
    """The capped tool's peak reserved GB (stderr's last line), or None
    when it did not get there."""
    try:
        return json.loads(stderr.strip().splitlines()[-1])["peak_reserved_GB"]
    except (IndexError, KeyError, TypeError, ValueError):
        return None


# per output pixel, the f32 operations of the augment (csrc/image_decode.cu),
# counted from its source: the bilinear sample (coordinates, clamps, two
# lerps and a scale per channel), each jitter op by id (contrast with its
# gray sum), the clip and the quantiser
AUG_OPS = {"sample": 40, 0: 3, 1: 15, 2: 14, 3: 30, "clip": 6,
           "quantize": 12}
# timed batches after one: each loader thread decodes a whole batch and
# they start together, so a short run counts their head start
LOADER_BATCHES = {32: 40, 256: 12}
PIL_BATCHES = 8                   # at BATCH
LIST_REPEATS = 18                 # the proxy list, repeated to fill them


def _augment_bound(card, images, size, boxes=None, orders=None):
    """Least time for the augment of this batch: the source pixels it must
    read (each train crop box, or the region the val crop samples) and the
    uint8 output, over the memory rate; AUG_OPS per output pixel over the
    f32 rate. Returns (ms, 'bytes' or 'operations')."""
    nbytes = len(images) * (size * size * 3 + card.IMAGE_ARGS.itemsize)
    ops = 0
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        if boxes is None:
            nw, nh, _, _ = card.val_geometry(w, h, size)
            nbytes += 3 * min(w, math.ceil(size * w / nw)) * min(
                h, math.ceil(size * h / nh))
            per = AUG_OPS["sample"] + AUG_OPS["quantize"]
        else:
            nbytes += 3 * boxes[i][2] * boxes[i][3]
            per = (AUG_OPS["sample"] + AUG_OPS["clip"] + AUG_OPS["quantize"]
                   + sum(AUG_OPS[op] for op in orders[i]))
        ops += per * size * size
    t_b, t_f = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


SPIN_S = 0.2  # the spin kernel that holds the stream while calls are queued


def _queued_ms(torch, fn, calls=5):
    """Device ms per call of fn's work on the current stream (for the
    augment: its one kernel launch per call of up to 256 images, whose
    arguments travel in the launch), from CUDA events around `calls` calls
    queued behind a SPIN_S spin kernel, so that they run back to back
    whatever the host's time per call. The torch.profiler recorded none of
    this library's kernels late in the smoke's process, though it did
    alone, so the smoke times them with events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_S * 1.98e9))  # cycles at the boost clock
    t = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    if host_s > 0.5 * SPIN_S:
        raise AssertionError(f"queueing {calls} calls took {host_s:.3f} s "
                             f"of the {SPIN_S} s spin")
    return start.elapsed_time(end) / calls


def _host_ms(torch, fn, calls=20):
    """Host ms per call of fn: the clock around `calls` calls, enqueue
    only (the queue is empty when they start)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * dt / calls


def _augment_check(torch, card, images, size, draws):
    """The augment kernel against its plain version on `images` (train with
    `draws` = boxes, flips, orders, factors; and val): uint8 max error and
    unequal share, a rerun bit for bit, the kernel launches of one call,
    ms, device ms, host ms per call, plain ms and the bound. Returns
    {"train": ..., "val": ...}."""
    boxes, flips, orders, factors = draws
    rec = {}
    for mode in ("train", "val"):
        if mode == "train":
            def kernel():
                return card.augment_train(images, boxes, size, flips,
                                          orders, factors)

            def plain():
                return torch.stack([card.quantize_plain(
                    card.augment_train_plain(img, boxes[i], size, flips[i],
                                             orders[i], factors[i]))
                    for i, img in enumerate(images)])
            bound = _augment_bound(card, images, size, boxes, orders)
        else:
            def kernel():
                return card.augment_val(images, size)

            def plain():
                return torch.stack([card.quantize_plain(
                    card.augment_val_plain(img, size)) for img in images])
            bound = _augment_bound(card, images, size)
        got, want = kernel(), plain()
        d = (got.int() - want.int()).abs()
        err, share = int(d.max()), float((d > 0).float().mean())
        before = card.launches["augment_kernels"]
        same = torch.equal(kernel(), got)
        rec[mode] = {"max_abs_err": err, "unequal_share": share,
                     "bit_identical_rerun": same,
                     "kernel_launches_per_call":
                         card.launches["augment_kernels"] - before,
                     "ms": _timed(torch, kernel),
                     "device_ms": _queued_ms(torch, kernel),
                     "host_ms": _host_ms(torch, kernel),
                     "plain_ms": _timed(torch, plain, reps=2),
                     "bound_ms": bound[0], "bound_by": bound[1]}
    return rec


def phase_decode(torch, card, proxy, tmpdir, n=BATCH):
    """The card pipeline on the proxy set (256-352 px JPEGs): nvJPEG's
    decode of a batch of `n` against PIL's (mean and max |diff| per
    image, and each entry's backend); the augment kernel against its plain
    version on that batch and on EVAL_BATCH images (the batch's images and
    draws repeated), train (the driver's draws) and val at 224^2 (uint8
    within one level, the unequal share, one kernel launch a call), with
    its ms, device ms, host ms, plain ms and bound (device ms from CUDA
    events, `_queued_ms`); then the loader's images/s on the card pipeline
    at batch 32 and 256 (the list repeated LIST_REPEATS times, from the
    page cache) beside PIL's at 32 (4 threads each). Returns the kernel's
    record for the summary line."""
    import io
    import numpy as np
    from PIL import Image
    from tfnas_tpu_torch.data import ImageList
    from tfnas_tpu_torch.data.transforms import sample_jitter, sample_rrc_box
    from tfnas_tpu_torch.tools_loader_throughput import measure

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    lst = os.path.join(proxy, "proxy_train.txt")
    with open(lst) as f:
        entries = [l.split()[0] for l in f if l.strip()]
    datas = []
    for rel in entries[:n]:
        with open(os.path.join(proxy, rel), "rb") as f:
            datas.append(f.read())
    images, backends = card.decode_batch(datas, dev)
    gaps = []
    for data, img in zip(datas, images):
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        d = np.abs(img.cpu().numpy().astype(np.int16) - ref)
        gaps.append((float(d.mean()), int(d.max())))
    emit({"phase": "decode", "step": "nvjpeg_vs_pil", "images": len(gaps),
          "backends": dict(collections.Counter(backends)),
          "mean_abs_per_image": [g[0] for g in gaps],
          "max_abs_per_image": [g[1] for g in gaps],
          "mean_abs": sum(g[0] for g in gaps) / len(gaps),
          "max_abs": max(g[1] for g in gaps)})
    failures = []
    if "refused" in backends:
        failures.append("nvJPEG refused a proxy JPEG")

    rng = np.random.default_rng(0)
    boxes, flips, orders, factors = [], [], [], []
    for img in images:
        h, w = img.shape[:2]
        boxes.append(sample_rrc_box(w, h, rng))
        flips.append(rng.random() < 0.5)
        order, facs = sample_jitter(rng)
        orders.append(order)
        factors.append(facs)
    size = 224
    rec = {"phase": "decode", "step": "augment_kernel", "n": len(images),
           "size": size}
    rec.update(_augment_check(torch, card, images, size,
                              (boxes, flips, orders, factors)))
    # the retrain's batch: the proxy batch's images and draws repeated
    k = -(-EVAL_BATCH // len(images))
    rec[f"n{EVAL_BATCH}"] = _augment_check(
        torch, card, (images * k)[:EVAL_BATCH], size,
        [(v * k)[:EVAL_BATCH] for v in (boxes, flips, orders, factors)])
    for r in (rec["train"], rec["val"], rec[f"n{EVAL_BATCH}"]["train"],
              rec[f"n{EVAL_BATCH}"]["val"]):
        if (r["max_abs_err"] > 1 or r["unequal_share"] > 1e-3
                or not r["bit_identical_rerun"]
                or r["kernel_launches_per_call"] != 1):
            failures.append(rec)
            break
    emit(rec)

    rates = {}
    rep = os.path.join(tmpdir, "proxy_train_repeated.txt")
    with open(lst) as f, open(rep, "w") as g:
        g.write(f.read() * LIST_REPEATS)
    for name, path, use_native, bs, n in (
            ("card_32", rep, "auto", BATCH, LOADER_BATCHES[BATCH]),
            ("card_256", rep, "auto", EVAL_BATCH, LOADER_BATCHES[EVAL_BATCH]),
            ("pil_32", rep, False, BATCH, PIL_BATCHES)):
        ds = ImageList(proxy, path, training=True, image_size=size,
                       use_native=use_native, device=dev)
        rates[name] = {"images_per_sec": measure(ds, bs, 4, n, dev),
                       "decoded": dict(ds.decoded), "batches": n}
    emit({"phase": "decode", "step": "loader", "rates": rates,
          "seconds": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"decode phase: {failures}")
    return rec


def phase_tools(torch, fused_dw, card, tss, tmpdir):
    """Data and tools: the kernel against its plain version at the
    occupancy sweep's batches (128, 256) at the largest site of each
    stride, f32 (TF32 off) and bf16; a small proxy set of real JPEGs
    (dataset/make_proxy_dataset.py) searched from CUDA graphs through the
    image list (PIL decode where the C++ pipeline cannot be built), with
    its decoder line in the log and both strides among its replays; then
    the port's tools as subprocesses, in two lanes at once, each cut to
    fit and each lane capped at its share of the card's memory:
    tools_occupancy_ab, tools_hybrid_bench and tools_eval_throughput;
    tools_occupancy_ab --remat_blocks, tools_scan_ab and
    tools_loader_throughput on the proxy set. Every tool must exit 0 with
    a JSON last line, and the search tools must launch both strides.
    Returns the tools' kernel executions (eager launches + replayed
    nodes) by stride."""
    import concurrent.futures as cf
    from tfnas_tpu_torch import train_search
    from tfnas_tpu_torch.data import image_decoder

    here = os.path.dirname(os.path.abspath(__file__))
    _release(torch)  # the lowerings phase's graph pools
    t_phase = time.perf_counter()
    proxy = os.path.join(tmpdir, "proxy")
    gen_proxy = subprocess.Popen(
        [sys.executable, os.path.join(here, "dataset",
                                      "make_proxy_dataset.py"),
         "--out_root", proxy, "--num_classes", "8", "--train_per_class",
         "24", "--val_per_class", "8"], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    failures = []
    try:
        torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(12)
        sites = main_path_sites(tss)
        for stride in (1, 2):
            h, c, _, act, _ = max((s for s in sites if s[2] == stride),
                                  key=lambda s: s[0] * s[0] * s[1])
            for n in LARGE_BATCHES:
                for dtype in (torch.float32, torch.bfloat16):
                    rec = _check_forward(torch, fused_dw, gen, n, h, c,
                                         stride, act, dtype)
                    emit(rec)
                    if not rec["ok"]:
                        failures.append(rec)
                    _release(torch)
        torch.backends.cudnn.allow_tf32 = True
        _, err = gen_proxy.communicate(timeout=120)
    finally:
        if gen_proxy.poll() is None:
            gen_proxy.kill()
            gen_proxy.wait()
    if gen_proxy.returncode != 0:
        raise AssertionError(f"make_proxy_dataset failed: {err[-2000:]}")
    augment = phase_decode(torch, card, proxy, tmpdir)

    # the real-JPEG search, replayed from graphs, decoded on the card
    lut = os.path.join(here, "latency_pkl", "latency_h100.pkl")
    fused_dw.reset_launches()
    card.reset_launches()
    t = time.perf_counter()
    run = train_search.main([
        "--img_root", proxy, "--train_list",
        os.path.join(proxy, "proxy_train.txt"), "--val_list",
        os.path.join(proxy, "proxy_val.txt"), "--epochs", "2",
        "--warmup_epochs", "1", "--steps_per_epoch", "4", "--batch_size",
        str(BATCH), "--num_classes", "8", "--lookup_path", lut,
        "--target_lat", "5.0", "--save_freq", "100", "--save",
        os.path.join(tmpdir, "jpeg_search")])
    augment["launches"] = card.launches["augment"]
    decoder = image_decoder("cuda")
    with open(os.path.join(run, "log.txt")) as f:
        lines = [l for l in f if "image decode:" in l]
    rec = {"phase": "tools", "step": "jpeg_search", "seconds":
           time.perf_counter() - t, "decoder": decoder,
           "decode_lines": [l[l.index("image decode:"):].strip()
                            for l in lines],
           "replayed": dict(fused_dw.replayed),
           "launches": dict(fused_dw.launches),
           "augment_launches": augment["launches"]}
    emit(rec)
    if not (len(lines) == 1 and decoder.startswith("nvjpeg (")
            and lines[0].rstrip().endswith(f"image decode: {decoder}")
            and all(rec["replayed"].values()) and augment["launches"]):
        failures.append(rec)
    shutil.rmtree(run)
    _release(torch)

    lanes = [
        [("tools_occupancy_ab", ["tools_occupancy_ab", "--batches", "32,64",
                                 "--n_timed", "4", "--warm", "2"]),
         ("tools_hybrid_bench", ["tools_hybrid_bench", "--iters", "3"]),
         ("tools_eval_throughput", ["tools_eval_throughput", "--batches",
                                    str(EVAL_BATCH)])],
        [("tools_occupancy_ab --remat_blocks",
          ["tools_occupancy_ab", "--batches", "32,64", "--n_timed", "4",
           "--warm", "2", "--remat_blocks"]),
         ("tools_scan_ab", ["tools_scan_ab", "--units", "1,2",
                            "--timed_units", "2", "--rounds", "1"]),
         ("tools_loader_throughput", [
             "tools_loader_throughput", "--img_root", proxy, "--list",
             os.path.join(proxy, "proxy_train.txt"), "--batches", "4",
             "--chip_steps_per_sec", "5.65"])]]
    # the two lanes' caps and the smoke's own share add up to the card, so
    # no pair of tools that happens to overlap can run it out of memory
    stop, peak = threading.Event(), [0]

    def sample():  # the card's memory in use, by every process on it
        while not stop.wait(0.25):
            free, total = torch.cuda.mem_get_info()
            peak[0] = max(peak[0], total - free)

    base_free, card = torch.cuda.mem_get_info()
    need = sum(LANE_FRACTIONS) * card + len(lanes) * TOOL_CONTEXT_GB * 1e9
    if base_free < need:
        raise AssertionError(
            f"tools phase: {base_free / 1e9:.2f} GB free on the card, the "
            f"lanes' caps and contexts need {need / 1e9:.2f}")
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        with cf.ThreadPoolExecutor(len(lanes)) as pool:
            results = [r for lane in pool.map(
                lambda lane: list(_tool_lane(here, lane[0], lane[1], 300)),
                zip(lanes, LANE_FRACTIONS)) for r in lane]
    finally:
        stop.set()
        sampler.join()
    emit({"phase": "tools", "step": "lanes_memory",
          "card_GB": card / 1e9, "in_use_before_GB": (card - base_free) / 1e9,
          "peak_in_use_GB": peak[0] / 1e9,
          "lane_caps_GB": [f * card / 1e9 for f in LANE_FRACTIONS]})
    counts = {}
    for name, argv, proc, seconds in results:
        rec = {"phase": "tools", "step": name, "argv": argv[1:],
               "rc": proc.returncode, "seconds": seconds,
               "peak_reserved_GB": _peak_reserved(proc.stderr)}
        try:
            rec["last_line"] = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            rec["stderr"] = proc.stderr[-3000:]
        emit(rec)
        if proc.returncode != 0 or "last_line" not in rec:
            failures.append(rec)
            continue
        if argv[0] in ("tools_occupancy_ab", "tools_scan_ab",
                       "tools_hybrid_bench"):  # the search tools
            fused = rec["last_line"]["fused_dw"]
            counts[name] = {s: fused["launches"][str(s)]
                            + fused["replayed_nodes"][str(s)]
                            for s in (1, 2)}
            if not all(counts[name].values()):
                failures.append(rec)
    emit({"phase": "tools", "step": "done", "launches_tools": counts,
          "seconds": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"tools phase: {failures}")
    return counts, augment


def _profile_summary(step, path):
    """What the card did inside the profiled step's window (the host range
    'step', which ends after a synchronize): busy share, the fused kernel's
    time and share, the top kernels, and the fused kernel's neighbours."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == "step"]
    if not span:
        raise AssertionError("the profiler trace has no 'step' range")
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    dev = sorted((e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e),
        key=lambda e: e["ts"])
    kernels = [e for e in dev if e["cat"] == "kernel"]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel on the card")
    busy, reach = 0.0, t0
    for e in dev:  # union of the device intervals inside the window
        a, b = max(e["ts"], reach), min(e["ts"] + e["dur"], t1)
        if b > a:
            busy += b - a
        reach = max(reach, e["ts"] + e["dur"])
    total, count = collections.Counter(), collections.Counter()
    for e in kernels:
        total[e["name"]] += e["dur"]
        count[e["name"]] += 1
    fused = [i for i, e in enumerate(kernels) if "fused_dw" in e["name"]]
    fused_us = sum(kernels[i]["dur"] for i in fused)
    by_stride = collections.Counter()
    for i in fused:
        by_stride[_fused_stride(kernels[i]["name"])] += kernels[i]["dur"]
    # the kernels launched just before and after each fused launch, with
    # their mean time beside the fused kernel's (a copy of x would take a
    # good part of it; a copy of the [5, 5, C] taps a few us)
    near = collections.defaultdict(list)
    for i in fused:
        for k in (i - 1, i + 1):
            if 0 <= k < len(kernels) and "fused_dw" not in kernels[k]["name"]:
                near[kernels[k]["name"][:120]].append(kernels[k]["dur"])
    neighbours = {n: {"calls": len(d), "mean_us": sum(d) / len(d)}
                  for n, d in sorted(near.items(), key=lambda e: -len(e[1]))}
    moves = {n: v for n, v in neighbours.items()
             if any(w in n.lower() for w in ("copy", "transpose", "permute"))}
    return {"phase": "profile", "step": step,
            "window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (t1 - t0),
            "kernels": len(kernels), "fused_dw_launches": len(fused),
            "fused_dw_ms_by_stride": {k: v / 1e3
                                      for k, v in by_stride.items()},
            "fused_dw_ms": fused_us / 1e3,
            "fused_dw_share": fused_us / (t1 - t0),
            "top_kernels": [{"name": n[:160], "ms": t / 1e3,
                             "calls": count[n]}
                            for n, t in total.most_common(10)],
            "fused_dw_mean_us": fused_us / max(1, len(fused)),
            "fused_dw_neighbours": neighbours,
            "copy_or_transpose_next_to_fused": moves}


def main():
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from tfnas_tpu_torch.kernels import bias_act, fused_dw
    from tfnas_tpu_torch.models import search_space as tss
    from tfnas_tpu_torch.runtime import card

    t_start = time.perf_counter()
    phase_env(torch, fused_dw, card, bias_act)
    per_stride, times = phase_kernel(torch, fused_dw, tss)
    epilogue = phase_epilogue(torch, bias_act)
    with tempfile.TemporaryDirectory() as tmpdir:
        launches, searched = phase_search(torch, fused_dw, tmpdir)
        nodes, cprof, ctimes = phase_capture(torch, fused_dw, tmpdir)
        replayed = phase_driver(torch, tmpdir)
        phase_lut(torch, tmpdir)
        fused_dw.reset_launches()  # the eval path's own count
        served = phase_eval(torch, tmpdir, searched)
        eval_launches = sum(fused_dw.launches.values())
        emit({"phase": "eval", "step": "fused_dw_launches",
              "launches": eval_launches})
        if eval_launches:
            raise AssertionError("the eval path launched the fused kernel")
        hyb_launches, hyb_nodes, hyb_replayed = phase_hybrid(
            torch, fused_dw, tmpdir)
        par_launches, par_nodes, par_replayed = phase_parallel(
            torch, fused_dw, tmpdir)
        low = phase_lowerings(torch, fused_dw, tmpdir)
        tools, augment = phase_tools(torch, fused_dw, card, tss, tmpdir)
    for stride, n in launches.items():
        if n == 0:
            raise AssertionError(f"stride-{stride} kernel never launched on "
                                 f"the main path")
    for stride in (1, 2):
        if not (hyb_launches.get(stride) and hyb_replayed.get(stride)):
            raise AssertionError(f"stride-{stride} kernel never launched on "
                                 f"the hybrid path")
        if not (par_launches.get(stride) and par_replayed.get(stride)):
            raise AssertionError(f"stride-{stride} kernel never launched on "
                                 f"the Pareto path")
        for path in ("remat_weight_step_nodes", "multi_forward",
                     "multi_fwd_bwd_nodes"):
            if not low[path].get(stride):
                raise AssertionError(f"stride-{stride} kernel never launched "
                                     f"on the {path} path")

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
            "device_ms": row["device_ms"], "cold_ms": row["cold_ms"],
            "host_us": row["host_us"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            # the captured steps: kernel nodes per replayed step (counted at
            # capture), the driver run's replayed launches, and the kernel's
            # device time inside one profiled captured step
            "launches_per_replayed_step": {
                k: nodes[f"{k}_step"][stride]
                for k in ("warmup", "weight", "arch")},
            "replayed_launches_driver": replayed[stride],
            # the hybrid space's captured steps and its driver run
            "launches_per_replayed_hybrid_step": {
                k: hyb_nodes[f"{k}_step"][stride]
                for k in ("warmup", "weight", "arch")},
            "hybrid_eager_launches": hyb_launches[stride],
            "replayed_launches_hybrid_driver": hyb_replayed[stride],
            # the Pareto search (G = 2): nodes per replayed step of both
            # groups, its eager steps' launches and its driver's replays
            "launches_per_replayed_pareto_step": {
                k: par_nodes[k][stride] for k in ("weight", "arch")},
            "pareto_eager_launches": par_launches[stride],
            "replayed_launches_pareto_driver": par_replayed[stride],
            "captured_step_device_ms": {
                k: cprof[k]["fused_dw_ms_by_stride"].get(stride, 0.0)
                for k in ("weight", "arch")},
            # the opt-in lowerings (phase 11): nodes per replayed step
            # under remat, launches per forward of cond_width_split and
            # apply_multi_sampled, nodes of their captured paths
            "launches_lowerings": {path: by.get(stride, 0)
                                   for path, by in low.items()},
            # the tools of phase 12, each run as a subprocess: its eager
            # launches and replayed nodes
            "launches_tools": {name: by[stride]
                               for name, by in tools.items()}})
    head = max(epilogue, key=lambda r: math.prod(r["shape"]))
    kernels.append({
        "name": "bias_act (fused epilogue)", "route": "cuda",
        "source": "tfnas_tpu_torch/csrc/bias_act.cu",
        "replaces": "none: XLA fuses a bias, activation, SE gate and "
                    "residual into the convolution; PyTorch ran them as "
                    "3-5 passes",
        "launches": served["launches"],
        "max_ulps": max(max(r["max_ulps_f32_bias"], r["max_ulps_bf16_bias"])
                        for r in epilogue),
        "shape": head["shape"], "ms": head["ms"],
        "device_ms": head["device_ms"], "cold_ms": head["cold_ms"],
        "host_us": head["host_us"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        # the folded TF-NAS-A-class net's forward replayed from a graph
        # (phase 8): kernel nodes per forward, its epilogue sites, and the
        # sites left to PyTorch's ops
        "graph_nodes_per_forward": served["graph_nodes"],
        "epilogue_sites": served["sites"], "unfused": served["unfused"],
        "sites": {r["site"]: {k: r[k] for k in ("device_ms", "bound_ms",
                                                "host_us", "plain_ms")}
                  for r in epilogue}})
    if not augment["launches"]:
        raise AssertionError("the augment kernel never launched on the "
                             "real-JPEG search")
    train, val = augment["train"], augment["val"]
    kernels.append({
        "name": "augment (train crop box, flip, jitter, quantise)",
        "route": "cuda", "source": "tfnas_tpu_torch/csrc/image_decode.cu",
        "replaces": "tfnas_tpu/runtime/src/image_pipeline.cpp:112-210, "
                    ":399-405 (host C++; no TPU kernel)",
        "launches": augment["launches"],
        "max_abs_err": max(train["max_abs_err"], val["max_abs_err"]),
        "unequal_share": train["unequal_share"],
        "shape": [augment["n"], augment["size"], augment["size"], 3],
        "kernel_launches_per_call": train["kernel_launches_per_call"],
        "ms": train["ms"], "device_ms": train["device_ms"],
        "host_ms": train["host_ms"],
        "plain_ms": train["plain_ms"], "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"], "library_ms": None,
        # the val transform (short side 256, centre crop), the same kernel
        "val": val,
        # both at the retrain's batch (the proxy batch repeated)
        f"n{EVAL_BATCH}": augment[f"n{EVAL_BATCH}"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
