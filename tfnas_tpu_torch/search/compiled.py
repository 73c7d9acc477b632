"""CUDA graphs of the port's steps: its counterpart of `jax.jit` over the
step functions (tfnas_tpu/search/train_step.py, make_search_steps).

`AutoGraphed(fn, writes, name, family)` keeps the functional signature of
the step it wraps and decides at every call between its CUDA graph and
the eager step. With a `GraphFamily`, its first call on CUDA tensors
gives every tensor argument a static buffer (a copy, or the argument
itself when it already is a static buffer of the same family), runs the
step eagerly on the family's side stream to warm it up (cuDNN and cuBLAS
choices, the kernel build, first-use caches), and captures it into a
`torch.cuda.CUDAGraph`. A call whose arguments have the capture's
structure and whose tensors its shapes, dtypes and device copies them
into the static buffers, unless they are those buffers, and replays the
graph; any other call, and every call without a family or off the card,
runs `fn` eagerly. Outputs that are new values of arguments (params,
momentum, arch params, Adam state) are copied back into those arguments'
buffers inside the graph, so passing a step's result to the next step
copies nothing. Other outputs (metrics) are copied into buffers allocated
outside the graph's memory pool: the graphs of a family share one pool,
and an output left in it could be overwritten by another graph's replay.

The trees a replay returns are its static buffers, which the next replay
overwrites: read or clone them before. Random draws are arguments, made
outside the graph. Nothing on the step path reads a device value on the
host; a capture that fails raises. A graph records the kernel nodes of
every launch counter (utils/trace.py `launch_counters`) at its capture,
and each replay adds them to the counters' replayed counts.

A family and its graphs hold no reference to the steps, so no reference
cycle keeps a graph alive: a dropped graph is freed at once, never by a
collection that could run inside a later capture and invalidate it.

Spans (utils/trace.py, each with the graph's name as its id): each call
from the capture on is `tfnas.graph.call` around `tfnas.graph.args` (the
arguments' flatten, checks and copies into the static buffers) and, where
they fit, `tfnas.graph.replay`; the first also holds
`tfnas.graph.capture`, whose time is the graph's `build_s` and is added
to `captures`, the process's total of every capture.
"""

from __future__ import annotations

import torch

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
    their static buffers. Without a device, it takes the device of the
    first tree it adopts or the first arguments it captures.
    `graphs` holds the captured graphs in their order of capture."""

    def __init__(self, device=None):
        self.device = None
        self._static = {}   # id -> the static tensor (kept alive here)
        self.graphs = []
        if device is not None:
            self._bind(device)

    def _bind(self, device):
        if self.device is None:
            device = torch.device(device)
            if device.type != "cuda":
                raise ValueError("CUDA graphs need a CUDA device")
            self.device = device
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)

    def _buffer(self, leaf):
        if isinstance(leaf, torch.Tensor):
            if self._static.get(id(leaf)) is leaf:
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
        if self.device is None:
            self._bind(_first_tensor(leaves).device)
        return _unflatten(spec, iter([self._buffer(l) for l in leaves]))


# benchmark/drivers/serve.py imports this name
SharedFamily = GraphFamily


def adopt(family, tree):
    """`tree` in static buffers of `family` (GraphFamily.adopt); `tree`
    itself when `family` is None."""
    return tree if family is None else family.adopt(tree)


def hold(family, old, new):
    """Where a tree that captured steps read lives from call to call: the
    first time (`old` is None) `new` adopted, after that `new` copied into
    `old`'s buffers, which are returned."""
    if old is None:
        return adopt(family, new)
    copy_tree_(old, new)
    return old


def _first_tensor(leaves):
    return next(l for l in leaves if isinstance(l, torch.Tensor))


def on_card(tree):
    """True when the first tensor leaf of `tree` lies on a CUDA device."""
    for l in leaves_of(tree):
        if isinstance(l, torch.Tensor):
            return l.is_cuda
    return False


class _Graph:
    """One captured CUDA graph: its arguments' structure `spec` and static
    buffers `static`, the buffers it writes its outputs to, and its kernel
    nodes by launch counter, {kernel name: {key: nodes}}."""

    def __init__(self, name):
        self.name = name
        self.nodes = {}
        self.build_s = None    # warm-up + capture + instantiation, seconds
        self.replays = 0


def capture(fam, fn, writes, name, spec, leaves):
    """The `_Graph` of `fn` over arguments of structure `spec` with leaves
    `leaves`, captured in `fam` and added to its `graphs`."""
    g = _Graph(name)
    clock = trace.clock("tfnas.graph.capture", graph=name)
    with clock:
        fam._bind(_first_tensor(leaves).device)
        g.spec, g.static = spec, [fam._buffer(l) for l in leaves]
        args = _unflatten(spec, iter(g.static))
        # the warm-up runs the out-of-place step and drops its result, so
        # the state is as it was
        fam.stream.wait_stream(torch.cuda.current_stream(fam.device))
        with torch.cuda.stream(fam.stream):
            out = fn(*args)
        torch.cuda.current_stream(fam.device).wait_stream(fam.stream)
        torch.cuda.synchronize(fam.device)
        homes = {i: _unflatten(_flatten(o, []), iter(
                     [torch.empty_like(t) for t in leaves_of(o)]))
                 for i, o in enumerate(out) if i not in writes}
        del out

        g.graph = torch.cuda.CUDAGraph()
        counters = trace.launch_counters
        before = {k: dict(c.captured) for k, c in counters.items()}
        with torch.cuda.graph(g.graph, pool=fam.pool, stream=fam.stream,
                              capture_error_mode="thread_local"):
            out = fn(*args)
            dst, src = [], []
            for i, o in enumerate(out):
                target = args[writes[i]] if i in writes else homes[i]
                dst += leaves_of(target)
                src += leaves_like(target, o)
            torch._foreach_copy_(dst, src)
            del out, src
        g.nodes = {k: {key: n - before[k][key]
                       for key, n in c.captured.items()}
                   for k, c in counters.items()}
        g.outputs = tuple(args[writes[i]] if i in writes else homes[i]
                          for i in range(len(writes) + len(homes)))
        torch.cuda.synchronize(fam.device)
    g.build_s = clock.ms / 1e3
    captures["count"] += 1
    captures["seconds"] += g.build_s
    fam.graphs.append(g)
    return g


class AutoGraphed:
    """`fn(*args)` replayed from one CUDA graph of `family` (a GraphFamily)
    where its arguments fit the graph's capture, made at the first call on
    the card; called eagerly otherwise, and always where `family` is None.

    writes: {output index: argument index} of outputs that are new values
    of arguments, written back into those arguments' buffers. `graphed`
    is the captured graph (None before); `replays` and `eager_calls` count
    the calls of each kind."""

    def __init__(self, fn, writes, name, family):
        self.fn, self.writes, self.name = fn, dict(writes), name
        self.family = family
        self.graphed = None
        self.eager_calls = 0

    @property
    def replays(self):
        return 0 if self.graphed is None else self.graphed.replays

    def __call__(self, *args):
        g = self.graphed
        if g is not None or (self.family is not None and on_card(args)):
            with trace.span("tfnas.graph.call", graph=self.name):
                if g is None:
                    leaves = []
                    spec = _flatten(args, leaves)
                    g = self.graphed = capture(self.family, self.fn,
                                               self.writes, self.name, spec,
                                               leaves)
                with trace.span("tfnas.graph.args", graph=self.name):
                    fits = _load(g, args)
                if fits:
                    with trace.span("tfnas.graph.replay", graph=self.name):
                        g.graph.replay()
                    g.replays += 1
                    for k, nodes in g.nodes.items():
                        replayed = trace.launch_counters[k].replayed
                        for key, n in nodes.items():
                            replayed[key] += n
                    return g.outputs
        self.eager_calls += 1
        return self.fn(*args)


def _keyed(spec):
    """`spec` with each dict's entries in the order of their keys."""
    kind = spec[0]
    if kind == "dict":
        order = sorted(range(len(spec[1])), key=lambda i: repr(spec[1][i]))
        return (kind, tuple(spec[1][i] for i in order),
                tuple(_keyed(spec[2][i]) for i in order))
    if kind in ("named", tuple, list):
        return (kind, spec[1], tuple(_keyed(s) for s in spec[2]))
    return spec


def _load(g, args):
    """Copy the leaves of `args` into the static buffers of graph `g` and
    return True; copy nothing and return False where they do not fit: a
    structure other than the capture's, or a tensor of another shape,
    dtype or device than its buffer. Dicts may hold their keys in another
    order than at the capture (an eager step's result may): their leaves
    are then matched by key."""
    leaves = []
    spec = _flatten(args, leaves)
    if spec != g.spec:
        if _keyed(spec) != _keyed(g.spec):
            return False
        leaves = leaves_like(_unflatten(g.spec, iter(g.static)), args)
    pairs = [(st, a) for st, a in zip(g.static, leaves) if st is not a]
    for st, a in pairs:
        if isinstance(a, torch.Tensor) and (
                a.shape != st.shape or a.dtype != st.dtype
                or a.device != st.device):
            return False
    for st, a in pairs:
        if isinstance(a, torch.Tensor):
            st.copy_(a)
        else:
            st.fill_(a)
    return True
