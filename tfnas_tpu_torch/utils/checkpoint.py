"""Checkpoints as pickled numpy trees (counterpart of
tfnas_tpu/utils/checkpoint.py).

The files are the JAX package's: a search checkpoint is {'params',
'arch_params', 'mc_mask_dddict', 'epoch', 'T'}, an eval checkpoint
{'epoch', 'params', 'bn_state', 'momentum', 'best_acc_top1',
'best_acc_top5', 'model_config'}, with parameters in the JAX layout
(convert.params_to_jax), and arrays are numpy. `to_numpy_tree` orders
dict keys as jax.tree_util does (sorted), so a tree pickles to the same
bytes as the JAX package's to_numpy_tree output.
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np
import torch


def to_numpy_tree(tree):
    """Tensors -> host numpy arrays; dicts (also inside lists) rebuilt with
    sorted keys, as jax.tree_util flattens and unflattens them."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
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


def save_checkpoint(state, is_best, save_dir, name="checkpoint.pkl",
                    best_name="model_best.pkl"):
    """Save `state` (converted with to_numpy_tree) as save_dir/name, and
    copy it to best_name when is_best."""
    filename = os.path.join(save_dir, name)
    save_checkpoint_file(to_numpy_tree(state), filename)
    if is_best:
        shutil.copyfile(filename, os.path.join(save_dir, best_name))
    return filename
