"""Data parallelism of the port on the CPU: cross-replica BN, the
supernet's depthwise middle (whose two pairs of sums, the fused kernel's
output sums included, are summed over the ranks) and the eval network on 2
and 4 gloo ranks against the JAX package's shard_map over the same number
of virtual CPU devices; the data-parallel eval train and validation steps
on 2 and 4 ranks against the port's one-process step on the global batch
and against JAX's make_eval_steps on a 4-device mesh; a plain in-place
all-reduce, which drops the cross-rank terms of the BN input gradient; and
train_eval and test launched on 2 ranks against one process.

The ranks run as subprocesses (tests/_torch_dist.py), one torch thread
each, under a timeout. Tolerances, f32: 1e-5 against the same layout (the
JAX mesh of as many devices as ranks, or the port on the same data), 1e-4
across layouts (N ranks against one global batch; sums in another order).
Sizes: batch 8, the tiny space's 8x8x12 depthwise site, the one-block-per-
stage eval net at 32x32 with 8 classes.
"""

import functools
import glob
import os
import pickle
import re
import sys
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_dist
from tfnas_tpu.kernels import fused_dw as jfused
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.eval_net import EvalNetwork as JEval
from tfnas_tpu.models.supernet import SuperNetwork as JNet
from tfnas_tpu.ops.batchnorm import batch_norm as jbn
from tfnas_tpu.parallel import make_eval_steps as jmake
from tfnas_tpu.parallel import make_mesh as jmesh
from tfnas_tpu.parallel.train_dp import EvalTrainState as JState
from tfnas_tpu.search.parser import get_mc_num_dddict
from tfnas_tpu.search.train_step import zeros_like_momentum
from tfnas_tpu_torch.convert import params_from_jax, params_to_jax
from tfnas_tpu_torch.models.eval_net import EvalNetwork as TEval
from tfnas_tpu_torch.parallel import train_dp as tdp

SAME = dict(rtol=1e-5, atol=1e-5)
ACROSS = dict(rtol=1e-4, atol=1e-4)
N, CLASSES, LR = 8, 8, 0.05
WORLDS = (2, 4)


def _close(got, want, tol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                **tol), got, want)


def _cat(results, *path):
    out = []
    for r in results:
        for k in path:
            r = r[k]
        out.append(r)
    return np.concatenate(out)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    c = 12
    mask = np.ones(c, np.float32)
    mask[[1, 5, 9]] = 0.0
    jnet = JEval.from_parsed_arch(
        CLASSES, OrderedDict((s, OrderedDict([("block1", 1)]))
                             for s in jss.STAGE_NAMES),
        get_mc_num_dddict(jss.build_mc_mask_dddict()))
    params, bn_state = map(params_to_jax, TEval.from_config(
        CLASSES, jnet.config).init(torch.Generator().manual_seed(0)))
    return {
        "cases": ["bn", "dw", "evalnet"],
        "bn": {"x": rng.standard_normal((N, 5, 5, 6)).astype(np.float32),
               "g": rng.standard_normal((N, 5, 5, 6)).astype(np.float32),
               "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
               "bias": rng.standard_normal(6).astype(np.float32),
               "mean": rng.standard_normal(6).astype(np.float32) * 0.1,
               "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)},
        "dw": {"h": rng.standard_normal((N, 8, 8, c)).astype(np.float32),
               "dwk": (rng.standard_normal((5, 5, c)) * 0.2).astype(
                   np.float32),
               "mask": mask,
               "g1": rng.standard_normal((N, 8, 8, c)).astype(np.float32),
               "g2": rng.standard_normal((N, 4, 4, c)).astype(np.float32)},
        "evalnet": {"classes": CLASSES, "config": jnet.config,
                    "params": params, "bn_state": bn_state,
                    "x": rng.standard_normal((N, 32, 32, 3)).astype(
                        np.float32),
                    "y": rng.integers(0, CLASSES, N).astype(np.int32),
                    "wmask": (np.arange(N) % 4 != 3).astype(np.float32),
                    "lr": LR},
        "jnet": jnet}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every case on 2 and on 4 gloo ranks, one launch each."""
    sent = {k: v for k, v in inputs.items() if k != "jnet"}
    return {w: _torch_dist.run_cases(sent, w,
                                     tmp_path_factory.mktemp(f"w{w}"))
            for w in WORLDS}


def _shard(fn, w, in_specs, out_specs):
    return shard_map(fn, mesh=jmesh(w), in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def _value_and_grads(f, g, *args):
    """f(*args) and the gradients of sum(y * g) w.r.t. args, y = f's
    output or its first, in one jitted call."""
    def run(*a):
        out, pull = jax.vjp(f, *a)
        if isinstance(out, tuple):
            return out, pull((g,) + tuple(jnp.zeros_like(o)
                                          for o in out[1:]))
        return out, pull(g)
    return jax.jit(run)(*args)


@pytest.mark.parametrize("world", WORLDS)
def test_batch_norm_matches_jax_shard_map(inputs, ranks, world):
    d = inputs["bn"]
    res = [r["bn"]["diff"] for r in ranks[world]]
    state = {"mean": d["mean"], "var": d["var"]}

    def fwd(x, scale, bias, axis):
        y, st = jbn(x, {"scale": scale, "bias": bias}, state, affine=True,
                    training=True, axis_name=axis)
        return y, st["mean"], st["var"]

    sm = _shard(lambda x, s, b: fwd(x, s, b, "data"), world,
                (P("data"), P(), P()), (P("data"), P(), P()))
    (y, mean, var), (dx, _, _) = _value_and_grads(
        sm, d["g"], d["x"], d["scale"], d["bias"])
    np.testing.assert_allclose(_cat(res, "y"), y, **SAME)
    np.testing.assert_allclose(_cat(res, "dx"), dx, **SAME)
    for r in res:  # every rank holds the global running statistics
        np.testing.assert_allclose(r["mean"], mean, **SAME)
        np.testing.assert_allclose(r["var"], var, **SAME)
    # the global batch in one process: the parameters' gradients are the
    # sums of the ranks'
    _, (gx, gs, gb) = _value_and_grads(
        lambda x, s, b: fwd(x, s, b, None), d["g"], d["x"], d["scale"],
        d["bias"])
    np.testing.assert_allclose(_cat(res, "dx"), gx, **ACROSS)
    np.testing.assert_allclose(sum(r["dscale"] for r in res), gs, **ACROSS)
    np.testing.assert_allclose(sum(r["dbias"] for r in res), gb, **ACROSS)


@pytest.mark.parametrize("world", WORLDS)
def test_plain_all_reduce_drops_cross_rank_gradient(inputs, ranks, world):
    """With a plain in-place all-reduce the forward is the same, but each
    rank's input gradient misses the other ranks' terms: the DP step would
    then silently differ from the global-batch step."""
    diff = [r["bn"]["diff"] for r in ranks[world]]
    plain = [r["bn"]["plain"] for r in ranks[world]]
    np.testing.assert_allclose(_cat(plain, "y"), _cat(diff, "y"), **SAME)
    gap = np.abs(_cat(plain, "dx") - _cat(diff, "dx")).max()
    assert gap > 1e-2, gap


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stride", [1, 2])
def test_dw_middle_matches_jax_shard_map(inputs, ranks, world, stride,
                                         monkeypatch):
    # the JAX kernel runs in Pallas interpret mode on the CPU, as in
    # tests/test_kernels.py
    monkeypatch.setattr(jfused.pl, "pallas_call", functools.partial(
        jfused.pl.pallas_call, interpret=True))
    d = inputs["dw"]
    act = "swish" if stride == 1 else "relu"
    res = [r["dw"][stride] for r in ranks[world]]
    g = d[f"g{stride}"]

    def fwd(net):
        return lambda h, k: net._dw_middle(h, k, jnp.asarray(d["mask"]),
                                           act, stride)

    jn = JNet(10, space=jss.tiny_space(32), bn_axis_name="data",
              use_pallas=True)
    sm = _shard(fwd(jn), world, (P("data"), P()), P("data"))
    y, (dh, _) = _value_and_grads(sm, g, d["h"], d["dwk"])
    np.testing.assert_allclose(_cat(res, "y"), y, **SAME)
    np.testing.assert_allclose(_cat(res, "dh"), dh, **SAME)
    one = JNet(10, space=jss.tiny_space(32), use_pallas=True)
    _, (gh, gk) = _value_and_grads(fwd(one), g, d["h"], d["dwk"])
    np.testing.assert_allclose(_cat(res, "dh"), gh, **ACROSS)
    np.testing.assert_allclose(sum(r["dwk"] for r in res), gk, **ACROSS)


@pytest.mark.parametrize("world", WORLDS)
def test_eval_net_forward_matches_jax_shard_map(inputs, ranks, world):
    d, jnet = inputs["evalnet"], inputs["jnet"]
    res = [r["evalnet"] for r in ranks[world]]
    sm = _shard(lambda p, b, x: jnet.apply(
        p, b, x, training=True, rng=jax.random.PRNGKey(1),
        bn_axis_name="data"), world, (P(), P(), P("data")),
        (P("data"), P()))
    logits, bn = jax.jit(sm)(d["params"], d["bn_state"], d["x"])
    np.testing.assert_allclose(_cat(res, "logits"), logits, **SAME)
    for r in res:
        _close(r["bn"], bn, SAME)


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's steps in this process on the global batch."""
    d = inputs["evalnet"]
    net = TEval.from_config(CLASSES, d["config"])
    train, val = tdp.make_eval_steps(net, num_classes=CLASSES,
                                     compute_dtype=torch.float32)
    params = params_from_jax(d["params"])
    state = tdp.EvalTrainState(params, params_from_jax(d["bn_state"]),
                               tdp.zeros_like_tree(params), 0)
    x = torch.from_numpy(d["x"])
    y = torch.from_numpy(d["y"]).long()
    s1, m = train(state, x, y, LR)
    vm = val(s1, x, y, torch.from_numpy(d["wmask"]))
    return s1, m, vm


@pytest.fixture(scope="module")
def jax_dp_step(inputs):
    """JAX's data-parallel train and validation steps on a 4-device
    mesh."""
    d, jnet = inputs["evalnet"], inputs["jnet"]
    train, val = jmake(jnet, jmesh(4), num_classes=CLASSES,
                       compute_dtype=jnp.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, d["params"])
    js = JState(jp, jax.tree_util.tree_map(jnp.asarray, d["bn_state"]),
                zeros_like_momentum(jp), jnp.zeros((), jnp.int32))
    js1, jm = train(js, jnp.asarray(d["x"]), jnp.asarray(d["y"]),
                    jnp.float32(LR), jax.random.PRNGKey(9))
    jv = val(js1, jnp.asarray(d["x"]), jnp.asarray(d["y"]),
             jnp.asarray(d["wmask"]))
    return js1, jm, jv


@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_matches_one_process_and_jax(inputs, ranks, one_process,
                                             jax_dp_step, world):
    d = inputs["evalnet"]
    res = [r["evalnet"] for r in ranks[world]]
    s1, m, vm = one_process
    for r in res:  # every rank ends with the same state and metrics
        _close(r["params"], params_to_jax(s1.params), SAME)
        _close(r["momentum"], params_to_jax(s1.momentum), SAME)
        _close(r["step_bn"], params_to_jax(s1.bn_state), SAME)
        for k in ("loss", "top1", "top5"):
            np.testing.assert_allclose(r["metrics"][k], float(m[k]), **SAME)
            np.testing.assert_allclose(r["val"][k], float(vm[k]), **SAME)
        assert r["val"]["count"] == float(d["wmask"].sum())

    js1, jm, jv = jax_dp_step
    r = res[0]
    _close(r["params"], js1.params, ACROSS)
    _close(r["momentum"], js1.momentum, ACROSS)
    _close(r["step_bn"], js1.bn_state, ACROSS)
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(r["metrics"][k], float(jm[k]), **ACROSS)
        np.testing.assert_allclose(r["val"][k], float(jv[k]), **ACROSS)


# -- the drivers under a 2-rank launch ----------------------------------------

def _jpeg_list(tmp_path, n):
    from PIL import Image
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        arr = rng.integers(0, 255, (int(rng.integers(36, 60)), 48, 3),
                           np.uint8)
        Image.fromarray(arr).save(tmp_path / f"{i}.jpg")
        lines.append(f"{i}.jpg {i % 10}")
    (tmp_path / "val.txt").write_text("\n".join(lines) + "\n")
    return tmp_path / "val.txt"


def _metrics(out):
    return {k: float(re.search(rf"Val_(?:acc_)?{k}: ([0-9.]+)", out).group(1))
            for k in ("loss", "top1", "top5")}


def test_train_eval_and_test_on_two_ranks_match_one_process(tmp_path):
    """train_eval on 2 gloo ranks (global batch 8, each rank 4 rows of it)
    and on one process: the same checkpoint (1e-5) and validation; then
    test.py over a 21-image JPEG list on 2 ranks (host shards, the second
    padded by wrapping, and padded last batches) and on one process: the
    same exact metrics."""
    cfg = os.path.join(_torch_dist.REPO, "checkpoints_e2e", "pareto-tiny",
                       "pareto-search-20260819-205815-pareto-tiny",
                       "model_g0.config")
    common = [sys.executable, "-m", "tfnas_tpu_torch.train_eval",
              "--synthetic", "--epochs", "1", "--steps_per_epoch", "2",
              "--image_size", "32", "--batch_size", "8", "--num_classes",
              "10", "--print_freq", "1", "--note", "t", "--workers", "1",
              "--config_path", cfg, "--no_bf16", "--dropout_rate", "0",
              "--drop_connect_rate", "0", "--device", "cpu", "--save"]
    outs = {}
    for world in (2, None):
        save = tmp_path / f"eval{world}"
        outs[world] = _torch_dist.launch(common + [str(save)], world, 240)
        (run,) = glob.glob(str(save / "eval-*"))
        assert os.listdir(save) == [os.path.basename(run)]
    ck = {w: pickle.load(open(glob.glob(str(tmp_path / f"eval{w}" / "*" /
                                            "checkpoint.pkl"))[0], "rb"))
          for w in (2, None)}
    _close(ck[2]["params"], ck[None]["params"], SAME)
    _close(ck[2]["bn_state"], ck[None]["bn_state"], SAME)
    for k in ("best_acc_top1", "best_acc_top5"):
        np.testing.assert_allclose(ck[2][k], ck[None][k], **SAME)
    assert "Val_acc_top1" in outs[2][0] and "[rank 1]" in outs[2][1]

    weights = glob.glob(str(tmp_path / "evalNone" / "*" /
                            "checkpoint.pkl"))[0]
    val = _jpeg_list(tmp_path, 21)
    test = [sys.executable, "-m", "tfnas_tpu_torch.test", "--weights",
            weights, "--batch_size", "8", "--num_classes", "10",
            "--image_size", "32", "--workers", "1", "--val_root",
            str(tmp_path), "--val_list", str(val), "--device", "cpu"]
    two = _torch_dist.launch(test, 2, 240)
    one = _torch_dist.launch(test, None, 240)
    assert "Val_acc_top1" not in two[1]  # only rank 0 prints
    got, want = _metrics(two[0]), _metrics(one[0])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
    # exact over the 21 images: a multiple of 1/21
    assert abs(got["top1"] * 21 / 100 - round(got["top1"] * 21 / 100)) < 1e-4


def test_multicard_step_check_on_two_ranks(tmp_path, monkeypatch):
    """tools_torch_multicard.py's float64 step check (one data-parallel
    train step of TF-NAS-A at full width) on 2 gloo ranks against one
    process, at 64^2 and a global batch of 8: within the tool's float64
    bound (1e-6 of each leaf's magnitude, at least 1e-6)."""
    tool = os.path.join(_torch_dist.REPO, "tools_torch_multicard.py")
    sys.path.insert(0, _torch_dist.REPO)
    import tools_torch_multicard as mc
    monkeypatch.setenv(mc.CHILD, mc.DP_STEP)
    argv = [sys.executable, tool, "--device", "cpu", "--image_size", "64",
            "--batch_size", "8", "--save"]
    _torch_dist.launch(argv + [str(tmp_path / "two")], 2, 240)
    _torch_dist.launch(argv + [str(tmp_path / "one")], None, 240)
    got = mc.compare(str(tmp_path / "two" / "run"),
                     str(tmp_path / "one" / "run"), exact=False,
                     tol=mc.F64_TOL)
    assert list(got) == ["step.pkl"] and got["step.pkl"]["ok"], got
