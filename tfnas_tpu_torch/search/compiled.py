"""CUDA graphs of the search steps: the port's counterpart of `jax.jit` over
the step functions (tfnas_tpu/search/train_step.py, make_search_steps).

A `GraphedFn` keeps the functional signature of the step it wraps. Its
first call on CUDA tensors gives every tensor argument a static buffer (a
copy, or the argument itself when it already is a static buffer of the same
`GraphFamily`), runs the step eagerly on the family's side stream to warm it
up (cuDNN and cuBLAS choices, the kernel build, first-use caches), and
captures it into a `torch.cuda.CUDAGraph`. Every call copies its arguments
into the static buffers, unless they are those buffers, and replays the
graph. Outputs that are new values of arguments (params, momentum, arch
params, Adam state) are copied back into those arguments' buffers inside the
graph, so passing a step's result to the next step copies nothing. Other
outputs (metrics) are copied into buffers allocated outside the graph's
memory pool: the graphs of a family share one pool, and an output left in it
could be overwritten by another graph's replay.

The trees a captured step returns are its static buffers, which the next
replay overwrites: read or clone them before. Random draws are arguments,
made outside the graph. Nothing on the step path reads a device value on the
host; a capture that fails raises.

Spans (utils/trace.py, each with the graph's name as its id): each call
is `tfnas.graph.call` around `tfnas.graph.args` (the arguments' flatten,
checks and copies into the static buffers) and `tfnas.graph.replay`; the
first call also holds `tfnas.graph.capture`, whose time is the graph's
`build_s` and is added to `captures`, the process's total of every
capture.
"""

from __future__ import annotations

import torch

from ..kernels import bias_act, fused_dw
from ..utils import trace

# every capture of the process: how many, and their seconds (warm-up,
# capture and instantiation)
captures = {"count": 0, "seconds": 0.0}


def _flatten(obj, leaves):
    """Structure of `obj` (dicts, tuples, named tuples, lists, None) with
    its leaves appended to `leaves` in order."""
    if isinstance(obj, dict):
        return ("dict", tuple(obj), tuple(_flatten(v, leaves)
                                          for v in obj.values()))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return ("named", type(obj), tuple(_flatten(v, leaves) for v in obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj), None, tuple(_flatten(v, leaves) for v in obj))
    if obj is None:
        return ("none",)
    leaves.append(obj)
    return ("leaf",)


def _unflatten(spec, it):
    kind = spec[0]
    if kind == "dict":
        return {k: _unflatten(s, it) for k, s in zip(spec[1], spec[2])}
    if kind == "named":
        return spec[1](*(_unflatten(s, it) for s in spec[2]))
    if kind in (tuple, list):
        return kind(_unflatten(s, it) for s in spec[2])
    if kind == "none":
        return None
    return next(it)


def leaves_of(obj):
    out = []
    _flatten(obj, out)
    return out


def leaves_like(target, tree):
    """The leaves of `tree` in the order of `target`'s structure, dict
    entries matched by key (two trees may order their keys differently)."""
    if isinstance(target, dict):
        return [l for k, v in target.items() for l in leaves_like(v, tree[k])]
    if isinstance(target, (tuple, list)):
        return [l for a, b in zip(target, tree) for l in leaves_like(a, b)]
    return [] if target is None else [tree]


def copy_tree_(dst, src):
    """Copy every tensor leaf of `src` into the matching leaf of `dst`, in
    place (numbers fill 0-dim tensors)."""
    d, s = leaves_of(dst), leaves_like(dst, src)
    pairs = [(a, b) for a, b in zip(d, s) if a is not b]
    tensors = [(a, b) for a, b in pairs if isinstance(b, torch.Tensor)]
    for a, b in tensors:
        if a.shape != b.shape:
            raise ValueError(f"shape {tuple(b.shape)} does not fit the "
                             f"buffer's {tuple(a.shape)}")
    if tensors:
        torch._foreach_copy_([a for a, _ in tensors], [b for _, b in tensors])
    for a, b in pairs:
        if not isinstance(b, torch.Tensor):
            a.fill_(b)


class GraphFamily:
    """Graphs on one device that share a memory pool, a side stream and
    their static buffers."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self._static = {}   # id -> the static tensor (kept alive here)
        self.graphs = []    # GraphedFn objects in the order of capture

    def is_static(self, t):
        return self._static.get(id(t)) is t

    def _buffer(self, leaf):
        if isinstance(leaf, torch.Tensor):
            if self.is_static(leaf):
                return leaf
            t = leaf.detach().to(self.device, copy=True)
        elif isinstance(leaf, bool):
            raise TypeError("a step argument cannot be a bool")
        elif isinstance(leaf, int):
            t = torch.tensor(leaf, dtype=torch.int64, device=self.device)
        elif isinstance(leaf, float):
            t = torch.tensor(leaf, dtype=torch.float32, device=self.device)
        else:
            raise TypeError(f"cannot hold a {type(leaf).__name__} in a "
                            f"static buffer")
        self._static[id(t)] = t
        return t

    def adopt(self, tree):
        """A copy of `tree` in static buffers of this family: graphs that
        are given these tensors read them in place, and the caller updates
        them with copy_tree_ between replays."""
        leaves = []
        spec = _flatten(tree, leaves)
        return _unflatten(spec, iter([self._buffer(l) for l in leaves]))


class GraphedFn:
    """`fn(*args)` replayed from one CUDA graph over static buffers.

    writes: {output index: argument index} of outputs that are new values
    of arguments, written back into those arguments' buffers."""

    def __init__(self, family, fn, writes, name, warmup=1):
        self.family, self.fn, self.writes = family, fn, dict(writes)
        self.name, self.warmup = name, warmup
        self.graph = None
        self.nodes = {}        # fused kernel nodes by stride
        self.epilogue_nodes = 0  # bias_act kernel nodes
        self.build_s = None    # warm-up + capture + instantiation, seconds
        self.replays = 0

    def _capture(self, spec, leaves):
        with trace.clock("tfnas.graph.capture", graph=self.name) as c:
            self._build(spec, leaves)
        self.build_s = c.ms / 1e3
        captures["count"] += 1
        captures["seconds"] += self.build_s
        self.family.graphs.append(self)

    def _build(self, spec, leaves):
        fam = self.family
        static = [fam._buffer(l) for l in leaves]
        args = _unflatten(spec, iter(static))
        # the warm-up runs the out-of-place step and drops its result, so
        # the state is as it was
        fam.stream.wait_stream(torch.cuda.current_stream(fam.device))
        with torch.cuda.stream(fam.stream):
            for _ in range(self.warmup):
                out = self.fn(*args)
        torch.cuda.current_stream(fam.device).wait_stream(fam.stream)
        torch.cuda.synchronize(fam.device)
        homes = {i: _unflatten(_flatten(o, []), iter(
                     [torch.empty_like(t) for t in leaves_of(o)]))
                 for i, o in enumerate(out) if i not in self.writes}
        del out

        graph = torch.cuda.CUDAGraph()
        before = dict(fused_dw.captured)
        epilogues = bias_act.captured
        with torch.cuda.graph(graph, pool=fam.pool, stream=fam.stream,
                              capture_error_mode="thread_local"):
            out = self.fn(*args)
            dst, src = [], []
            for i, o in enumerate(out):
                target = args[self.writes[i]] if i in self.writes else homes[i]
                dst += leaves_of(target)
                src += leaves_like(target, o)
            torch._foreach_copy_(dst, src)
            del out, src
        self.nodes = {s: fused_dw.captured[s] - before[s] for s in before}
        self.epilogue_nodes = bias_act.captured - epilogues
        self.graph, self.spec, self.static = graph, spec, static
        n_out = len(self.writes) + len(homes)
        self.outputs = tuple(args[self.writes[i]] if i in self.writes
                             else homes[i] for i in range(n_out))
        torch.cuda.synchronize(fam.device)

    def __call__(self, *args):
        with trace.span("tfnas.graph.call", graph=self.name):
            if self.graph is None:
                leaves = []
                self._capture(_flatten(args, leaves), leaves)
            with trace.span("tfnas.graph.args", graph=self.name):
                leaves = []
                if _flatten(args, leaves) != self.spec:
                    raise ValueError(f"{self.name}: the arguments' "
                                     f"structure changed since capture")
                self._load(leaves)
            with trace.span("tfnas.graph.replay", graph=self.name):
                self.graph.replay()
            self.replays += 1
            for s, n in self.nodes.items():
                fused_dw.replayed[s] += n
            bias_act.replayed += self.epilogue_nodes
            return self.outputs

    def _load(self, leaves):
        """Copy the arguments' leaves into the static buffers."""
        for st, a in zip(self.static, leaves):
            if st is a:
                continue
            if isinstance(a, torch.Tensor):
                if a.shape != st.shape:
                    raise ValueError(
                        f"{self.name}: shape {tuple(a.shape)} does not fit "
                        f"the static buffer's {tuple(st.shape)}")
                st.copy_(a)
            else:
                st.fill_(a)


def on_card(tree):
    """True when the first tensor leaf of `tree` lies on a CUDA device."""
    for l in leaves_of(tree):
        if isinstance(l, torch.Tensor):
            return l.is_cuda
    return False


class SharedFamily:
    """The GraphFamily of a set of steps, made at the first capture unless
    one is given."""

    def __init__(self, family=None):
        self.family = family

    def get(self, args):
        if self.family is None:
            self.family = GraphFamily(next(
                l.device for l in leaves_of(args)
                if isinstance(l, torch.Tensor)))
        return self.family


class AutoGraphed:
    """`fn` replayed from a CUDA graph when its arguments lie on the card;
    called eagerly otherwise (the CPU)."""

    def __init__(self, fn, writes, name, shared):
        self.fn, self.writes, self.name = fn, writes, name
        self.shared = shared
        self.graphed = None

    def __call__(self, *args):
        if self.graphed is None:
            if not on_card(args):
                return self.fn(*args)
            self.graphed = GraphedFn(self.shared.get(args), self.fn,
                                     self.writes, self.name)
        return self.graphed(*args)
