"""Cells of the benchmark at sizes a CPU test holds: the tiny search space
at 32^2 (its betas have no gradient: no group of them is compared) and
the tfnas_a_class net at 64^2, float32, with limits for a float32
program on the CPU (where it matches the reference to round-off)."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def search():
    cfg = json.loads((HERE / "data" / "tiny_search.json").read_text())
    tr = {"driver": "search", "epoch": 10, "train_batches": 3,
          "val_batches": 2, "print_freq": 100, "trace_steps": 2,
          "limits": {"pick_mismatch": 0, "grad_diff.weights": 1e-4,
                     "update_diff.weights": 1e-4,
                     "grad_diff.log_alphas": 1e-4,
                     "update_gap.log_alphas": 1e-4}}
    return {"name": "tiny.search", "chips": 1}, cfg, tr


def _a_class(size=64):
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "tfnas_a_class.json").read_text())
    cfg["image_size"], cfg["dtype"] = size, "float32"
    return cfg


def retrain(input_="synth"):
    tr = {"driver": "retrain", "input": input_, "batch_size": 4,
          "workers": 2, "epoch": 0, "synth_batches": 3, "trace_steps": 2,
          "jpegs": {"seed": 0, "classes": 3, "per_class": 4,
                    "min_size": 80, "max_size": 100, "quality": 87,
                    "list_repeats": 4, "workers": 2},
          "limits": {"grad_gap.weights": 1e-4, "update_gap.weights": 1e-4,
                     "grad_diff.weights": 1e-4, "update_diff.weights": 1e-4,
                     "bn_diff": 1e-4}}
    if input_ == "jpeg":
        tr["limits"]["pixel_gap"] = 0.5
    return {"name": "tiny.retrain", "chips": 1}, _a_class(), tr


def serve():
    tr = {"driver": "serve", "batch_size": 4, "pool": 2,
          "warmup_requests": 1, "check_every": 3, "trace_requests": 2,
          "limits": {"logit_gap": 1e-3}}
    return {"name": "tiny.serve", "chips": 1}, _a_class(), tr

