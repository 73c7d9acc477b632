"""The port's Pareto search driver (train_search_pareto) on the CPU, tiny
space, f32: per-group checkpoints and --resume, --resume from the
JAX-written pareto-tiny run, G = 2 on 2 gloo ranks against one process
(the same bytes: one torch thread everywhere), one group on 2 ranks
against one process (1e-4: BN over two shards against one batch), and the
rows a rank decodes from an image list. The steps' parity with the JAX
package is in test_torch_pareto.py, the driver's hybrid space in
test_torch_pareto_hybrid.py.
"""

import glob
import os
import pickle
import sys

import jax
import numpy as np

import _torch_dist
from tfnas_tpu.parallel.pareto import stack_group_trees as jstack
from tfnas_tpu.utils import checkpoint as jckpt
from tfnas_tpu_torch import parsing_model as tparse
from tfnas_tpu_torch import train_search_pareto as tpareto
from tfnas_tpu_torch.parallel.mesh import make_mesh

ACROSS = dict(rtol=1e-4, atol=1e-4)
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
