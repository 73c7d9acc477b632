"""The port's package boundary and search driver on the CPU: it imports no
JAX, refuses CUDA without a card, and a tiny synthetic search writes only
under --save, in the JAX package's checkpoint format."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tfnas_tpu.models import search_space as jss
from tfnas_tpu.search import parser as jpa
from tfnas_tpu_torch.convert import params_from_jax
from tfnas_tpu_torch.device import resolve_device
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork
from tfnas_tpu_torch.search import parser as tpa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax():
    code = (
        "import pkgutil, sys, tfnas_tpu_torch\n"
        "for m in pkgutil.walk_packages(tfnas_tpu_torch.__path__, "
        "'tfnas_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import tfnas_tpu_torch.train_search, tfnas_tpu_torch.train_eval\n"
        "import tfnas_tpu_torch.parsing_model, tfnas_tpu_torch.test\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tfnas_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('kernels.fused_dw', 'runtime.native', 'models.eval_net',\n"
        "          'models.folding', 'parallel.train_dp', 'cost.flops',\n"
        "          'data.imagelist', 'data.transforms', 'cost.measure',\n"
        "          'search.compiled', 'make_lat_lut', 'bench'):\n"
        "    assert 'tfnas_tpu_torch.' + m in sys.modules, m\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_refuse_cuda_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    from tfnas_tpu_torch import parsing_model, test, train_eval, train_search
    ckpt = tmp_path / "model.pkl"
    ckpt.write_bytes(b"")
    save = ["--save", str(tmp_path)]
    for main, argv in (
            (train_search.main, ["--synthetic", "--space", "tiny"] + save),
            (train_eval.main, ["--synthetic", "--config_path", os.path.join(
                ROOT, "configs", "tfnas_a_tpu.config")] + save),
            (parsing_model.main, ["--model_path", str(ckpt),
                                  "--save_path", str(tmp_path / "m.config")]),
            (test.main, ["--weights", str(ckpt), "--synthetic"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert [p.name for p in tmp_path.iterdir()] == ["model.pkl"]


def test_driver_refuses_unported_paths(tmp_path):
    """--space hybrid is ported: it refuses a latency table without the ViT
    keys, as the JAX driver does; a missing image list stops the driver.
    Neither writes anything."""
    from tfnas_tpu_torch.train_search import main
    with pytest.raises(SystemExit, match="needs ViT entries in the LUT"):
        main(["--synthetic", "--space", "hybrid", "--device", "cpu",
              "--save", str(tmp_path), "--lookup_path",
              os.path.join(ROOT, "latency_pkl", "latency_tpu.pkl")])
    with pytest.raises(FileNotFoundError, match="missing.txt"):
        main(["--space", "tiny", "--device", "cpu", "--save", str(tmp_path),
              "--train_list", str(tmp_path / "missing.txt")])
    assert not list(tmp_path.iterdir())


def _repo_files():
    out = set()
    for d, dirs, files in os.walk(ROOT):
        dirs[:] = [x for x in dirs if x not in (".git", "__pycache__")]
        out.update(os.path.join(d, f) for f in files)
    return out


def test_tiny_search_writes_only_under_save(tmp_path):
    before = _repo_files()
    save = tmp_path / "runs"
    subprocess.run(
        [sys.executable, "-m", "tfnas_tpu_torch.train_search", "--synthetic",
         "--space", "tiny", "--device", "cpu", "--epochs", "3",
         "--warmup_epochs", "1", "--steps_per_epoch", "3", "--image_size",
         "32", "--batch_size", "4", "--num_classes", "10", "--target_lat",
         "0.05", "--save", str(save), "--save_freq", "2"],
        cwd=ROOT, check=True, timeout=300, capture_output=True)
    assert _repo_files() == before
    (run,) = save.iterdir()
    names = sorted(os.listdir(run))
    assert names == ["arch_params_00.pkl", "arch_params_01.pkl",
                     "arch_params_02.pkl", "arch_params_03.pkl", "log.txt",
                     "searched_model_00.pkl", "searched_model_02.pkl",
                     "searched_model_03.pkl"]

    # the JAX package parses the port's arch params
    path = str(run / "arch_params_03.pkl")
    ow, dw = jpa.get_op_and_depth_weights(path)
    assert jpa.parse_architecture(ow, dw, space=jss.tiny_space(32)) == \
        tpa.parse_architecture(*tpa.get_op_and_depth_weights(path),
                               space=tss.tiny_space(32))
    # the full checkpoint holds the JAX layout and converts back
    ckpt = pickle.load(open(run / "searched_model_03.pkl", "rb"))
    assert sorted(ckpt) == ["T", "arch_params", "epoch", "mc_mask_dddict",
                            "params"]
    assert ckpt["epoch"] == 3
    k = ckpt["params"]["stage1"]["block1"]["depth"]["kernel"]
    assert isinstance(k, np.ndarray) and k.shape == (8, 5, 5, 1, 64)
    tp = params_from_jax(ckpt["params"])
    ref, _ = SuperNetwork(10, space=tss.tiny_space(32)).init(
        torch.Generator().manual_seed(0))
    assert tp["stage1"]["block1"]["depth"]["kernel"].shape == \
        ref["stage1"]["block1"]["depth"]["kernel"].shape
