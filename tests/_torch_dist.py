"""Multi-process runs of the PyTorch port on the CPU for the parallel tests.

`launch` starts N processes as torchrun would (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR=localhost, MASTER_PORT a free port), one torch
thread each, and waits for them under a timeout that kills every child,
so that no test can hang. `run_cases` runs this file as each child:

    python tests/_torch_dist.py <inputs.pkl> <out_dir>

joins the gloo process group, runs the cases that the inputs name on this
rank's share of their numpy inputs, and pickles the results to
out_dir/rank<R>.pkl. The child imports torch and the port, never JAX.
"""

import os
import pickle
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, world, timeout, cwd=REPO):
    """Run `argv` as `world` ranks (world None: one process without the
    launch environment). Returns each process's output; raises with the
    output of a process that failed or outlived `timeout` seconds."""
    port = free_port()
    procs = []
    for rank in range(world or 1):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            env.pop(k, None)
        if world:
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(argv, cwd=cwd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    return outs


def run_cases(inputs, world, tmp_path, timeout=240):
    """The cases of `inputs` ({"cases": [...], ...}) on `world` gloo ranks;
    returns each rank's result dict."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    launch([sys.executable, os.path.abspath(__file__), str(path),
            str(tmp_path)], world, timeout)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the child ---------------------------------------------------------------

def _rows(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _np(t):
    return t.detach().cpu().numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def case_bn(inp, rank, world, group):
    """Cross-replica BN forward and input/parameter gradients, through the
    differentiable all-reduce and through a plain in-place one."""
    import torch
    import torch.distributed as dist
    from tfnas_tpu_torch.ops import batchnorm

    def plain(x, group):
        out = x.clone()
        with torch.no_grad():
            dist.all_reduce(out, group=group)
        return out

    x = torch.from_numpy(_rows(inp["x"], rank, world)).permute(0, 3, 1, 2)
    g = torch.from_numpy(_rows(inp["g"], rank, world)).permute(0, 3, 1, 2)
    out = {}
    for name, reduce in (("diff", batchnorm.all_reduce_sum),
                         ("plain", plain)):
        saved, batchnorm.all_reduce_sum = batchnorm.all_reduce_sum, reduce
        try:
            xl = x.detach().requires_grad_()
            p = {k: torch.from_numpy(inp[k]).requires_grad_()
                 for k in ("scale", "bias")}
            y, st = batchnorm.batch_norm(
                xl, p, {k: torch.from_numpy(inp[k]) for k in ("mean", "var")},
                affine=True, training=True, group=group)
            dx, ds, db = torch.autograd.grad((y * g).sum(),
                                             [xl, p["scale"], p["bias"]])
        finally:
            batchnorm.all_reduce_sum = saved
        out[name] = {"y": _np(y.permute(0, 2, 3, 1)),
                     "dx": _np(dx.permute(0, 2, 3, 1)), "dscale": _np(ds),
                     "dbias": _np(db), "mean": _np(st["mean"]),
                     "var": _np(st["var"])}
    return out


def case_dw(inp, rank, world, group):
    """The supernet's depthwise middle (the fused kernel's plain version
    here) with its two pairs of sums over the group: output and the
    gradients of the input and the taps, at both strides."""
    import torch
    from tfnas_tpu_torch.models import search_space as tss
    from tfnas_tpu_torch.models.supernet import SuperNetwork

    net = SuperNetwork(10, space=tss.tiny_space(32), bn_group=group)
    out = {}
    for stride, act in ((1, "swish"), (2, "relu")):
        h = torch.from_numpy(_rows(inp["h"], rank, world)).requires_grad_()
        dwk = torch.from_numpy(inp["dwk"]).requires_grad_()
        y = net._dw_middle(h.permute(0, 3, 1, 2),
                           dwk.permute(2, 0, 1)[:, None],
                           torch.from_numpy(inp["mask"]), act, stride)
        g = torch.from_numpy(_rows(inp[f"g{stride}"], rank, world))
        dh, dk = torch.autograd.grad((y * g.permute(0, 3, 1, 2)).sum(),
                                     [h, dwk])
        out[stride] = {"y": _np(y.permute(0, 2, 3, 1)), "dh": _np(dh),
                       "dwk": _np(dk)}
    return out


def _eval_net(inp):
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    return EvalNetwork.from_config(inp["classes"], inp["config"])


def case_evalnet(inp, rank, world, group):
    """A training forward of the eval network with cross-replica BN, then
    one data-parallel train step and one validation step."""
    import torch
    from tfnas_tpu_torch.convert import params_from_jax, params_to_jax
    from tfnas_tpu_torch.parallel import train_dp
    from tfnas_tpu_torch.search.train_step import zeros_like_tree

    net = _eval_net(inp)
    params = params_from_jax(inp["params"])
    bn = params_from_jax(inp["bn_state"])
    x = torch.from_numpy(_rows(inp["x"], rank, world))
    y = torch.from_numpy(_rows(inp["y"], rank, world)).long()
    with torch.no_grad():
        logits, new_bn = net.apply(params, bn, x, training=True,
                                   bn_group=group)
    train, val = train_dp.make_eval_steps(
        net, num_classes=inp["classes"], compute_dtype=torch.float32,
        group=group)
    state = train_dp.EvalTrainState(params, bn, zeros_like_tree(params), 0)
    s1, m = train(state, x, y, inp["lr"])
    vm = val(s1, x, y, torch.from_numpy(_rows(inp["wmask"], rank, world)))
    return {"logits": _np(logits), "bn": _tree_np(new_bn),
            "params": params_to_jax(s1.params),
            "momentum": params_to_jax(s1.momentum),
            "step_bn": _tree_np(s1.bn_state),
            "metrics": {k: float(v) for k, v in m.items()},
            "val": {k: float(v) for k, v in vm.items()}}


def pareto_run(inp, mesh):
    """One Pareto weight step and one arch step of this rank's groups from
    the inputs' group states and draws; returns {g: results} for the
    groups whose first data rank this is."""
    import numpy as np
    import torch
    from tfnas_tpu_torch.convert import (arch_from_jax, params_from_jax,
                                         params_to_jax)
    from tfnas_tpu_torch.models import search_space as tss
    from tfnas_tpu_torch.models.supernet import SuperNetwork
    from tfnas_tpu_torch.parallel import pareto
    from tfnas_tpu_torch.search.train_step import adam_init, zeros_like_tree

    sp = tss.tiny_space(inp["res"])
    net = SuperNetwork(inp["classes"], space=sp, bn_group=mesh.data_group)
    local = list(mesh.local_groups)
    params = [params_from_jax(inp["params"][g]) for g in local]
    arch = [arch_from_jax(inp["arch"][g]) for g in local]
    state = pareto.ParetoSearchState(params, arch,
                                     [zeros_like_tree(p) for p in params],
                                     [adam_init(a) for a in arch])
    masks = [net.device_masks(inp["mc"][g], "cpu") for g in local]
    umasks = [net.update_masks(state.params[i], inp["mc"][g])
              for i, g in enumerate(local)]

    def share(a):
        return torch.from_numpy(_rows(a, mesh.data_rank, mesh.data_size))

    xs = [share(inp["x"][g]) for g in local]
    ys = [share(inp["y"][g]).long() for g in local]
    wstep, astep = pareto.make_pareto_search_steps(
        net, mesh, num_classes=inp["classes"], targets=inp["targets"],
        lambda_lat=inp["lambda_lat"])
    def t(a):
        return torch.from_numpy(np.array(a))
    s1, wm = wstep(state, masks, umasks, xs, ys, inp["lr"],
                   [(t(inp["idx_g"][g]).long(), t(inp["idx_r"][g]).long())
                    for g in local])
    s2, am = astep(s1, masks, xs, ys, [t(inp["lat"][g]) for g in local],
                   inp["base_lat"], [float(inp["T"][g]) for g in local],
                   [t(inp["u"][g]) for g in local])
    if mesh.data_rank:
        return {}
    return {g: {"params": params_to_jax(s2.params[i]),
                "momentum": params_to_jax(s2.momentum[i]),
                "arch": _tree_np(s2.arch_params[i]),
                "mu": _tree_np(s2.opt_a[i].mu), "nu": _tree_np(s2.opt_a[i].nu),
                "weight": {k: float(v[i]) for k, v in wm.items()},
                "arch_metrics": {k: float(v[i]) for k, v in am.items()}}
            for i, g in enumerate(local)}


def case_pareto(inp, rank, world, group):
    from tfnas_tpu_torch.parallel.mesh import make_mesh
    return pareto_run(inp, make_mesh(world, len(inp["targets"]), rank))


CASES = {"bn": case_bn, "dw": case_dw, "evalnet": case_evalnet,
         "pareto": case_pareto}


def main(inputs_path, out_dir):
    import torch
    import torch.distributed as dist
    from tfnas_tpu_torch.parallel.mesh import maybe_distributed_init

    torch.set_num_threads(1)
    rank, world = maybe_distributed_init(torch.device("cpu"))
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    out = {name: CASES[name](inputs[name], rank, world, dist.group.WORLD)
           for name in inputs["cases"]}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1], sys.argv[2])
