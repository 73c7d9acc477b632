"""Checkpoints as pickled numpy trees (counterpart of
tfnas_tpu/utils/checkpoint.py).

The files are the JAX package's: a search checkpoint is {'params',
'arch_params', 'mc_mask_dddict', 'epoch', 'T'} with parameters in the JAX
layout (convert.params_to_jax), and arrays are numpy. `to_numpy_tree` orders
dict keys as jax.tree_util does (sorted), so a tree pickles to the same
bytes as the JAX package's to_numpy_tree output.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def to_numpy_tree(tree):
    """Tensors -> host numpy arrays; dicts rebuilt with sorted keys, as
    jax.tree_util flattens and unflattens them."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        return np.asarray(tree)
    return tree


def save_checkpoint_file(obj, path):
    """Pickle `obj` (already numpy) to `path` atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path):
    with open(path, "rb") as f:
        return pickle.load(f)
