"""The port's Pareto search driver (train_search_pareto) in the hybrid
conv/ViT space on the CPU: --space hybrid refusing a latency table without
the ViT keys, and both groups stepping at full width through the validity
mask (64^2, batch 2). The other driver tests are in
test_torch_pareto_driver.py.
"""

import os
import pickle

import numpy as np
import pytest

import _torch_dist
from tfnas_tpu_torch import train_search_pareto as tpareto


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
