"""The set-up the port's tools share: the search supernet, its state and
one batch as the repository's bench.py builds them, its schedule (a
bi-sampling weight step every iteration, a soft arch step every second
one), and the schedule's rate.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .cost.lut import (build_space_analytic_lut, lat_vectors_for_mc,
                       load_lat_lookup)
from .models import hybrid_space as hs
from .models import search_space as ss
from .models.supernet import SuperNetwork
from .models.supernet_hybrid import HybridSuperNetwork
from .search.bisample import (gumbel_uniform, sample_gumbel_indices,
                              sample_random_excluding)
from .search.compiled import adopt
from .search.parser import get_mc_num_dddict
from .search.train_step import adam_init, make_search_steps, zeros_like_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def search_setup(device, space=None, batch=32, size=224, ncls=100,
                 lut_path=None, hybrid=False, **net_kw):
    """The supernet, its state on `device` and one batch, as the
    repository's bench.py builds them: the MBConv supernet over `space`
    (the full space when None) or, with `hybrid`, the hybrid conv/ViT one.
    lut_path: the latency table (latency_pkl/latency_tpu.pkl, or its
    hybrid counterpart, by default). net_kw: SuperNetwork's lowering
    flags."""
    if hybrid:
        sp, net = hs, HybridSuperNetwork(ncls, **net_kw)
    else:
        sp, net = space or ss, SuperNetwork(ncls, space=space, **net_kw)
    if lut_path is None:
        lut_path = os.path.join(ROOT, "latency_pkl", "latency_tpu_hybrid.pkl"
                                if hybrid else "latency_tpu.pkl")
    gen = torch.Generator(device=device).manual_seed(0)
    params, arch = net.init(gen)
    mc_mask = sp.build_mc_mask_dddict()
    if space is None:
        lut = load_lat_lookup(lut_path)
    else:
        lut = build_space_analytic_lut(space)
    lat = lat_vectors_for_mc(lut, get_mc_num_dddict(mc_mask),
                             sp.build_lat_lookup_key_dddict(), sp.NUM_OPS)
    target = float(lat.max(1).sum() + lut["base"]) * 0.6
    rng = np.random.default_rng(0)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = {
        "params": params, "arch": arch, "mom": zeros_like_tree(params),
        "opt": adam_init(arch), "masks": net.device_masks(mc_mask, device),
        "umasks": net.update_masks(params, mc_mask),
        "lat": torch.from_numpy(lat).to(device),
        "base": torch.tensor(float(lut["base"]), device=device),
        "lr": torch.tensor(0.025, device=device),
        "T": torch.tensor(5.0, device=device),
        "x": torch.from_numpy(rng.standard_normal(
            (batch, size, size, 3), np.float32)).to(device, dtype),
        "y": torch.from_numpy(rng.integers(0, ncls, batch)).to(device)}
    return net, state, target, gen


def weight_iter(steps, st, gen, valid=None):
    """One bi-sampling weight step on the state dict `st` (updated in
    place), its two draws from `gen` over the `valid` candidates; returns
    its metrics."""
    la = st["arch"]["log_alphas"]
    ig = sample_gumbel_indices(la, gen, valid)
    ir = sample_random_excluding(ig, la.shape[-1], gen, valid)
    st["params"], st["mom"], m = steps.weight_step(
        st["params"], st["arch"], st["mom"], st["masks"], st["umasks"],
        st["x"], st["y"], st["lr"], ig, ir)
    return m


def arch_iter(steps, st, gen):
    """One soft arch step on `st` (updated in place); returns its
    metrics."""
    st["arch"], st["opt"], m = steps.arch_step(
        st["params"], st["arch"], st["opt"], st["masks"], st["x"], st["y"],
        st["lat"], st["base"], st["T"],
        gumbel_uniform(st["arch"]["log_alphas"].shape, gen))
    return m


def search_iter(steps, st, gen, i):
    """Iteration i of bench.py's schedule: a weight step, then an arch
    step when i is even; returns the weight step's metrics."""
    m = weight_iter(steps, st, gen)
    if i % 2 == 0:
        arch_iter(steps, st, gen)
    return m


def search_rate(net, state, target, gen, family, n_timed, warm):
    """Weight steps per second over n_timed iterations of search_iter after
    `warm` (the graphs' captures with a GraphFamily, eager steps with
    None)."""
    steps = make_search_steps(net, num_classes=net.num_classes,
                              target_lat=target, family=family)
    st = adopt(family, dict(state))
    for i in range(warm):
        search_iter(steps, st, gen, i)
    if st["x"].is_cuda:
        torch.cuda.synchronize(st["x"].device)
    t = time.perf_counter()
    for i in range(n_timed):
        m = search_iter(steps, st, gen, i)
    float(m["loss"])  # waits for the last step
    return n_timed / (time.perf_counter() - t)
