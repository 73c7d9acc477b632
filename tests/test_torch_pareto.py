"""The port's Pareto search on the CPU, tiny space, f32: one weight step
and one arch step of G = 2 groups (per-group targets, widths and T)
against the JAX package's make_pareto_search_steps on a (pareto 2, data 4)
mesh of virtual CPU devices, with the JAX draws recomputed from its keys
and injected; the port's G = 2 on one process, on 2 gloo ranks (a group
each) and on 4 (a group on 2 ranks, cross-replica BN); and the driver:
per-group checkpoints and --resume, --resume from the JAX-written
pareto-tiny run, --space hybrid refusing a table without ViT keys, and a
2-rank launch against one process.

Tolerances: 1e-4 against the JAX mesh and across layouts (BN over 4
shards against one batch; sums in another order); G = 2 on 2 ranks
equals G = 2 on one process exactly, and so do the driver's pickles (one
torch thread everywhere); masked channels stay exactly frozen. Sizes: 32x32
inputs, batch 8 per group, 10 classes.
"""

import glob
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.supernet import SuperNetwork as JNet
from tfnas_tpu.parallel import make_mesh as jmesh
from tfnas_tpu.parallel.pareto import ParetoSearchState as JState
from tfnas_tpu.parallel.pareto import make_pareto_search_steps as jsteps
from tfnas_tpu.parallel.pareto import stack_group_trees as jstack
from tfnas_tpu.search.bisample import (sample_gumbel_indices,
                                       sample_random_excluding)
from tfnas_tpu.search.train_step import adam_init, zeros_like_momentum
from tfnas_tpu.utils import checkpoint as jckpt
from tfnas_tpu_torch import parsing_model as tparse
from tfnas_tpu_torch import train_search_pareto as tpareto
from tfnas_tpu_torch.convert import (params_to_jax, stack_group_trees,
                                     unstack_group_tree)
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork as TNet
from tfnas_tpu_torch.parallel.mesh import make_mesh

ACROSS = dict(rtol=1e-4, atol=1e-4)
G, B, RES, CLASSES = 2, 8, 32, 10
TARGETS = [0.02, 0.03]
PARETO = glob.glob(os.path.join(_torch_dist.REPO, "checkpoints_e2e",
                                "pareto-tiny", "*"))[0]
DRIVER = ["--synthetic", "--space", "tiny", "--target_lats", "0.04,0.08",
          "--warmup_epochs", "1", "--steps_per_epoch", "2", "--image_size",
          "32", "--batch_size", "8", "--num_classes", "10", "--print_freq",
          "1", "--note", "p", "--no_bf16", "--device", "cpu"]


def _close(got, want, tol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                **tol), got, want)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    sp = jss.tiny_space(RES)
    jnet = JNet(CLASSES, space=sp)
    tnet = TNet(CLASSES, space=tss.tiny_space(RES))
    params = [params_to_jax(tnet.init(torch.Generator().manual_seed(g))[0])
              for g in range(G)]
    nblk = len(jnet.sites)
    mc = []
    for _ in range(G):  # each group its own switched-off channels
        m = sp.build_mc_mask_dddict()
        for stage in m:
            for block in m[stage]:
                for v in m[stage][block].values():
                    v[rng.choice(np.nonzero(v)[0], 3, replace=False)] = 0.0
        mc.append(m)
    arch = [{"log_alphas": (rng.standard_normal((nblk, 8)) * 0.5).astype(
                np.float32),
             "betas": {s: rng.standard_normal(d).astype(np.float32)
                       for s, d in sp.STAGE_DEPTHS.items()}}
            for _ in range(G)]
    wkeys = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    akeys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    draws = []
    for g in range(G):  # the draws of the JAX steps, from their keys
        kg, kr = jax.random.split(wkeys[g])
        idx_g = sample_gumbel_indices(kg, arch[g]["log_alphas"])
        draws.append((np.asarray(idx_g), np.asarray(
            sample_random_excluding(kr, idx_g, 8))))
    return {
        "res": RES, "classes": CLASSES, "targets": TARGETS,
        "lambda_lat": 0.5, "lr": 0.025, "base_lat": 0.004,
        "T": np.asarray([5.0, 4.0], np.float32),
        "params": params, "arch": arch, "mc": mc,
        "x": rng.standard_normal((G, B, RES, RES, 3)).astype(np.float32),
        "y": rng.integers(0, CLASSES, (G, B)).astype(np.int32),
        "lat": rng.uniform(0.0, 0.01, (G, nblk, 8)).astype(np.float32),
        "idx_g": [d[0] for d in draws], "idx_r": [d[1] for d in draws],
        "u": [np.asarray(jax.random.uniform(
            k, (nblk, 8), jnp.float32, minval=1e-10, maxval=1.0))
            for k in akeys],
        "wkeys": np.stack(wkeys), "akeys": np.stack(akeys), "jnet": jnet}


@pytest.fixture(scope="module")
def jax_steps(inputs):
    d, jnet = inputs, inputs["jnet"]
    # cross-replica BN over each group's 4 data devices, as the JAX
    # driver sets it
    weight, arch = jsteps(JNet(CLASSES, space=jss.tiny_space(RES),
                               bn_axis_name="data"),
                          jmesh(8, pareto_groups=G),
                          num_classes=CLASSES, targets=TARGETS,
                          lambda_lat=d["lambda_lat"])
    params = jax.tree_util.tree_map(jnp.asarray, jstack(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in d["params"]]))
    a = jstack([jax.tree_util.tree_map(jnp.asarray, t) for t in d["arch"]])
    st = JState(params, a, zeros_like_momentum(params),
                jax.vmap(adam_init)(a))
    masks = jstack([jnet.device_masks(m) for m in d["mc"]])
    p0 = jax.tree_util.tree_map(lambda v: v[0], params)
    umasks = jstack([jnet.update_masks(p0, m) for m in d["mc"]])
    x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    s1, wm = weight(st, masks, umasks, x, y,
                    jnp.full((G,), d["lr"], jnp.float32),
                    jnp.asarray(d["wkeys"]))
    s2, am = arch(s1, masks, x, y, jnp.asarray(d["lat"]),
                  jnp.float32(d["base_lat"]), jnp.asarray(d["T"]),
                  jnp.asarray(d["akeys"]))
    s2 = jax.tree_util.tree_map(np.asarray, s2)
    return s2, wm, am


@pytest.fixture(scope="module")
def layouts(inputs, tmp_path_factory):
    """{layout: {g: results}}: G = 2 in this process (one torch thread),
    on 2 ranks and on 4."""
    sent = {k: v for k, v in inputs.items()
            if k not in ("jnet", "wkeys", "akeys")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {1: _torch_dist.pareto_run(sent, make_mesh(1, G, 0))}
    finally:
        torch.set_num_threads(threads)
    for w in (2, 4):
        res = _torch_dist.run_cases({"cases": ["pareto"], "pareto": sent}, w,
                                    tmp_path_factory.mktemp(f"p{w}"))
        out[w] = {g: v for r in res for g, v in r["pareto"].items()}
    return out


@pytest.mark.parametrize("layout", [1, 4])
def test_pareto_steps_match_jax(inputs, jax_steps, layouts, layout):
    s2, wm, am = jax_steps
    for g, r in layouts[layout].items():
        def at(tree):
            return jax.tree_util.tree_map(lambda v: v[g], tree)
        _close(r["params"], at(s2.params), ACROSS)
        _close(r["momentum"], at(s2.momentum), ACROSS)
        _close(r["arch"], at(s2.arch_params), ACROSS)
        _close(r["mu"], at(s2.opt_a.mu), ACROSS)
        _close(r["nu"], at(s2.opt_a.nu), ACROSS)
        np.testing.assert_allclose(r["weight"]["loss"], wm["loss"][g],
                                   **ACROSS)
        np.testing.assert_allclose(r["weight"]["top1"], wm["top1"][g],
                                   **ACROSS)
        for k in ("loss_a", "loss_l", "lat"):
            np.testing.assert_allclose(r["arch_metrics"][k], am[k][g],
                                       **ACROSS)
    # each group against its own target
    assert layouts[layout][0]["arch_metrics"]["loss_l"] != \
        layouts[layout][1]["arch_metrics"]["loss_l"]


def test_two_ranks_equal_one_process(layouts):
    def same(a, b):
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(b)
        jax.tree_util.tree_map(
            lambda u, v: np.testing.assert_array_equal(u, v), a, b)
    assert sorted(layouts[2]) == sorted(layouts[1]) == [0, 1]
    for g in (0, 1):
        same(layouts[2][g], layouts[1][g])


@pytest.mark.parametrize("layout", [1, 4])
def test_masked_channels_stay_frozen(inputs, layouts, layout):
    """Entries that a group's update masks zero keep their value exactly:
    the widths differ per group."""
    from tfnas_tpu_torch.convert import params_from_jax
    from tfnas_tpu_torch.models import search_space as tss
    from tfnas_tpu_torch.models.supernet import SuperNetwork

    net = SuperNetwork(CLASSES, space=tss.tiny_space(RES))
    for g, r in layouts[layout].items():
        old = params_from_jax(inputs["params"][g])
        new = params_from_jax(r["params"])
        um = net.update_masks(old, inputs["mc"][g])
        for site in net.sites:
            for name in ("expand", "depth", "project"):
                o = old[site.stage][site.block][name]["kernel"]
                n = new[site.stage][site.block][name]["kernel"]
                m = um[site.stage][site.block][name]["kernel"].expand_as(
                    o) == 0
                assert m.any() and torch.equal(o[m], n[m])
                assert not torch.equal(o[~m], n[~m])


def test_group_trees_stack_as_jax():
    trees = [{"a": {"k": np.full((2, 3), g, np.float32)},
              "b": torch.full((4,), float(g))} for g in range(3)]
    st = stack_group_trees(trees)
    assert st["a"]["k"].shape == (3, 2, 3) and st["b"].shape == (3, 4)
    back = unstack_group_tree(st)
    for g in range(3):
        np.testing.assert_array_equal(back[g]["a"]["k"], trees[g]["a"]["k"])
        np.testing.assert_array_equal(back[g]["b"], trees[g]["b"].numpy())


# -- the driver ----------------------------------------------------------------

def test_driver_resumes_per_group_and_parses(tmp_path):
    save = str(tmp_path / "pareto")
    run = tpareto.main(DRIVER + ["--epochs", "2", "--save", save])
    for g in (0, 1):
        for e in (1, 2):
            assert os.path.exists(f"{run}/searched_model_g{g}_{e:02d}.pkl")
    run2 = tpareto.main(DRIVER + [
        "--epochs", "3", "--save", str(tmp_path / "resumed"),
        "--resume", f"{run}/searched_model_g{{g}}_02.pkl"])
    assert "Epoch: 0 " not in open(f"{run2}/log.txt").read()
    for g in (0, 1):
        ck = pickle.load(open(f"{run2}/searched_model_g{g}_03.pkl", "rb"))
        assert sorted(ck) == ["T", "arch_params", "epoch",
                              "mc_mask_dddict", "params", "target_lat"]
        assert ck["epoch"] == 3 and ck["target_lat"] == [0.04, 0.08][g]
        cfg = tmp_path / f"model_g{g}.config"
        tparse.main(["--model_path", f"{run2}/searched_model_g{g}_03.pkl",
                     "--save_path", str(cfg), "--space", "tiny",
                     "--image_size", "32", "--num_classes", "10",
                     "--device", "cpu"])
        assert cfg.exists()


def test_driver_resumes_from_jax_pareto_tiny(tmp_path):
    """One more epoch from the JAX run's epoch-4 pickles (same flags as
    that run): the port's pickles have the JAX driver's keys, types and
    shapes, read back with the JAX loader and stack into its state."""
    # 4 batches an epoch, as the JAX run took
    flags = ["4" if prev == "--steps_per_epoch" else a
             for prev, a in zip([None] + DRIVER, DRIVER)]
    run = tpareto.main(flags + [
        "--epochs", "5", "--save", str(tmp_path),
        "--resume", f"{PARETO}/searched_model_g{{g}}_04.pkl"])
    cks = []
    for g in (0, 1):
        want = jckpt.load_checkpoint(f"{PARETO}/searched_model_g{g}_04.pkl")
        got = jckpt.load_checkpoint(f"{run}/searched_model_g{g}_05.pkl")
        assert list(got) == list(want)
        assert got["epoch"] == 5 and got["target_lat"] == want["target_lat"]
        assert isinstance(got["T"], float)
        assert got["T"] == float(np.float32(want["T"]) * np.float32(0.96))
        shapes = jax.tree_util.tree_map(np.shape, want)
        assert jax.tree_util.tree_map(np.shape, got) == shapes
        cks.append(got)
    stacked = jstack([c["params"] for c in cks])  # the JAX Pareto layout
    assert jax.tree_util.tree_leaves(stacked)[0].shape[0] == 2


def test_hybrid_refuses_a_table_without_vit_keys(tmp_path):
    with pytest.raises(SystemExit, match="ViT"):
        tpareto.main(["--space", "hybrid", "--synthetic", "--lookup_path",
                      os.path.join(_torch_dist.REPO, "latency_pkl",
                                   "latency_h100.pkl"),
                      "--target_lats", "4.5,6.0", "--save",
                      str(tmp_path / "h"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "h")


def test_hybrid_driver_runs_both_groups(tmp_path):
    """--space hybrid with the H100 hybrid table (full width, 64^2, batch 2,
    one epoch past warmup): both groups take a weight and an arch step
    through the validity mask; their arch parameters keep the slots a
    block does not offer at the projection's sentinel, and each group's
    pickle holds its ViT mask entries."""
    from tfnas_tpu_torch.models import hybrid_space as ths
    run = tpareto.main([
        "--space", "hybrid", "--synthetic", "--image_size", "64",
        "--batch_size", "2", "--steps_per_epoch", "1", "--epochs", "1",
        "--warmup_epochs", "0", "--target_lats", "4.5,6.0", "--lookup_path",
        os.path.join(_torch_dist.REPO, "latency_pkl",
                     "latency_h100_hybrid.pkl"), "--num_classes", "10",
        "--no_bf16", "--device", "cpu", "--save", str(tmp_path)])
    valid = ths.valid_op_mask() > 0
    for g in (0, 1):
        ck = pickle.load(open(f"{run}/searched_model_g{g}_01.pkl", "rb"))
        la = ck["arch_params"]["log_alphas"]
        assert la.shape == valid.shape
        assert np.all(la[~valid] == -30.0) and np.all(la[valid] > -30.0)
        assert ths.VIT_OP_IDX in ck["mc_mask_dddict"]["stage5"]["block1"]


def test_driver_on_two_ranks_equals_one_process(tmp_path):
    """G = 2 on 2 gloo ranks (a group each, the second rank writing its
    group's pickles into rank 0's run directory) and on one process: the
    same bytes."""
    argv = [sys.executable, "-m", "tfnas_tpu_torch.train_search_pareto"] + \
        DRIVER + ["--epochs", "2", "--save"]
    outs = _torch_dist.launch(argv + [str(tmp_path / "two")], 2, 240)
    _torch_dist.launch(argv + [str(tmp_path / "one")], None, 240)
    (two,) = glob.glob(str(tmp_path / "two" / "*"))
    (one,) = glob.glob(str(tmp_path / "one" / "*"))
    names = sorted(f for f in os.listdir(one) if f.endswith(".pkl"))
    assert names == sorted(f for f in os.listdir(two) if f.endswith(".pkl"))
    assert len(names) == 4
    for f in names:
        assert open(f"{one}/{f}", "rb").read() == open(f"{two}/{f}",
                                                       "rb").read()
    assert "[rank 1]" in outs[1] and "groups (1,)" in outs[1]


def test_driver_one_group_on_two_ranks_matches_one_process(tmp_path):
    """One group data-parallel over 2 gloo ranks (cross-replica BN, the
    gradient all-reduce; each rank takes its half of the group's synthetic
    batches) against the same search in one process: the same widths, and
    every float within 1e-4 (BN over two shards against one batch)."""
    argv = [sys.executable, "-m", "tfnas_tpu_torch.train_search_pareto"] + \
        DRIVER + ["--target_lats", "0.04", "--epochs", "2", "--save"]
    _torch_dist.launch(argv + [str(tmp_path / "two")], 2, 240)
    _torch_dist.launch(argv + [str(tmp_path / "one")], None, 240)
    (two,) = glob.glob(str(tmp_path / "two" / "*"))
    (one,) = glob.glob(str(tmp_path / "one" / "*"))
    for epoch in (1, 2):
        name = f"searched_model_g0_{epoch:02d}.pkl"
        got = jckpt.load_checkpoint(f"{two}/{name}")
        want = jckpt.load_checkpoint(f"{one}/{name}")
        assert got["epoch"] == want["epoch"] and got["T"] == want["T"]
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               got["mc_mask_dddict"], want["mc_mask_dddict"])
        _close([got["params"], got["arch_params"]],
               [want["params"], want["arch_params"]], ACROSS)


def test_real_batches_decode_only_the_ranks_groups(tmp_path):
    """From an image list: a rank that holds one of G = 2 groups gets that
    group's rows g::2 of the loader's batches (the labels of the
    one-process layout's group g), decoding only those."""
    from PIL import Image
    rng = np.random.default_rng(0)
    lines = []
    for i in range(12):
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
            tmp_path / f"i{i}.jpg")
        lines.append(f"i{i}.jpg {i}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    args = tpareto.parser.parse_args([
        "--img_root", str(tmp_path), "--train_list",
        str(tmp_path / "list.txt"), "--batch_size", "3", "--image_size",
        "32", "--workers", "1"])
    x1, y1 = zip(*tpareto.make_batches(args, make_mesh(1, 2, 0))(1))
    assert len(y1) == 2 and x1[0].shape == (2, 3, 32, 32, 3)
    for r in (0, 1):
        xr, yr = zip(*tpareto.make_batches(args, make_mesh(2, 2, r))(1))
        assert xr[0].shape == (1, 3, 32, 32, 3) and xr[0].dtype == np.uint8
        np.testing.assert_array_equal(np.stack(yr)[:, 0],
                                      np.stack(y1)[:, r])
