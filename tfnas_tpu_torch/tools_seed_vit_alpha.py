"""Raise the ViT candidate's alpha in a hybrid search checkpoint
(counterpart of the repository's tools_seed_vit_alpha.py), so that parsing
elects a ViTBlock at those blocks: a short `--space hybrid` search, this
edit, then parsing_model -> model.config with a ViTBlock entry ->
train_eval -> test closes the hybrid round trip.

    python -m tfnas_tpu_torch.tools_seed_vit_alpha --ckpt IN.pkl \\
        --out OUT.pkl [--blocks 12 15] [--boost 3.0]

The edit is made on the pickled checkpoint on the host (no device work):
the ViT logit (op 8) of each block gets --boost added, and the block's
row is renormalised by log_softmax over its valid ops, as the projection
after an arch step does; invalid ops keep their sentinel. The rest of the
checkpoint is written back unchanged.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from .models import hybrid_space as hs


def log_softmax(v):
    v = v - v.max()
    return v - np.log(np.exp(v).sum())


parser = argparse.ArgumentParser("seed the ViT alpha")
parser.add_argument("--ckpt", required=True)
parser.add_argument("--out", required=True)
parser.add_argument("--blocks", type=int, nargs="+", default=None,
                    help="block indices to boost (default: every block "
                         "with a ViT candidate)")
parser.add_argument("--boost", type=float, default=3.0,
                    help="added to the ViT logit before renormalising")


def main(argv=None):
    args = parser.parse_args(argv)
    with open(args.ckpt, "rb") as f:
        ckpt = pickle.load(f)
    la = np.array(ckpt["arch_params"]["log_alphas"], np.float32)
    if la.shape[1] != hs.NUM_OPS:
        raise SystemExit(f"not a hybrid checkpoint: log_alphas {la.shape}")
    valid = np.asarray(hs.valid_op_mask(), bool)  # [18, 9]
    vit_blocks = [i for i in range(la.shape[0]) if valid[i, hs.VIT_OP_IDX]]
    blocks = args.blocks if args.blocks is not None else vit_blocks
    for b in blocks:
        if b not in vit_blocks:
            raise SystemExit(f"block {b} has no ViT candidate "
                             f"(valid: {vit_blocks})")
        row = la[b].copy()
        row[hs.VIT_OP_IDX] += args.boost
        row[valid[b]] = log_softmax(row[valid[b]])
        la[b] = row
        print(f"block {b}: exp(alpha)[vit] = "
              f"{np.exp(la[b, hs.VIT_OP_IDX]):.4f}")
    ckpt["arch_params"]["log_alphas"] = la
    with open(args.out, "wb") as f:
        pickle.dump(ckpt, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
