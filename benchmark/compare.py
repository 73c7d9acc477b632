"""The numbers that decide `correct` for a training cell.

A step's state is compared leaf by leaf, within groups of leaves that are
scaled alike (a cell's weights; the search's betas; its log_alphas, a
group of one leaf), each leaf against the reference's norm of that leaf
or of its group's median leaf, whichever is larger (some gradients are
all but zero). Two measures: the gap of the two norms (`*_gap`), and the
norm of the difference (`*_diff`), which is first order in a rounding
error that a gap of norms sees only at second order. The number of a
group is its median live leaf's; the widest leaves are kept for the
detail view (`top_leaves`). Leaves whose reference gradient is under a
thousandth of their group's median leaf's move by round-off alone (as a
bias before an affine-free BN) and are left out.
"""

from __future__ import annotations

import torch


def leaves(tree):
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in leaves(v)]
    return [] if tree is None else [tree]


def paths(tree, prefix=""):
    """'a/b/c' names of the leaves, in leaves() order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in paths(v, f"{prefix}{i}/")]
    return [] if tree is None else [prefix.rstrip("/")]


def aligned(tree, like):
    """The leaves of `tree` in the order of `like`'s, matched by path."""
    by_path = dict(zip(paths(tree), leaves(tree)))
    return [by_path[p] for p in paths(like)]


def norms(ls):
    """float64 [leaves] of the f32 norms of a list of leaves, on the host."""
    return torch.stack([torch.linalg.vector_norm(l.float())
                        for l in ls]).double().cpu()


def live(ref_grad_norms, groups):
    """Leaves whose reference gradient is above 0 and at least a
    thousandth of the median leaf's of their group."""
    keep = torch.zeros(ref_grad_norms.shape, dtype=torch.bool)
    for g in groups:
        r = ref_grad_norms[g]
        keep[g] = (r > 0) & (r >= 1e-3 * r.median())
    return keep


def leaf_gaps(num, ref, groups):
    """Per leaf num / max(ref, the median ref of its group)."""
    out = torch.empty_like(ref)
    for g in groups:
        out[g] = num[g] / torch.clamp(ref[g], min=float(ref[g].median()))
    return out


def gap_of_norms(prog, ref, groups):
    p, r = norms(prog), norms(ref)
    return leaf_gaps((p - r).abs(), r, groups)


def norm_of_diff(prog, ref, groups):
    num = norms([a.float() - b.float() for a, b in zip(prog, ref)])
    return leaf_gaps(num, norms(ref), groups)


def loss_gap(prog_losses, ref_losses):
    """max over the checked steps of |prog - ref| / |ref|."""
    return max(abs(float(p) - float(r)) / max(abs(float(r)), 1e-12)
               for p, r in zip(prog_losses, ref_losses))


def training_readings(prog, ref, groups):
    """The numbers of a training cell's check from the three checked
    steps of a program side and of the reference: "losses" (per step),
    "grads" (the first gradient's leaves, as the optimiser got it) and
    "moved" (each leaf's change after the steps). groups: {name: slice of
    the leaves}. Per group with a live leaf, `<number>.<group>` at its
    median live leaf: grad_gap and update_gap (gaps of norms), grad_diff
    and update_diff (norms of the difference); and loss_gap."""
    gs = list(groups.values())
    keep = live(norms(ref["grads"]), gs)
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"])}
    for name, measure, key in (("grad_gap", gap_of_norms, "grads"),
                               ("update_gap", gap_of_norms, "moved"),
                               ("grad_diff", norm_of_diff, "grads"),
                               ("update_diff", norm_of_diff, "moved")):
        gaps = measure(prog[key], ref[key], gs)
        for gname, sl in groups.items():
            if keep[sl].any():
                out[f"{name}.{gname}"] = float(gaps[sl][keep[sl]].median())
    return out


def top_leaves(prog, ref, names, n=6):
    """The leaves with the widest difference gaps of the first gradient
    (each against the median leaf of all), for looking into a reading:
    [name, gap, |prog|, |ref|]."""
    gaps = norm_of_diff(prog["grads"], ref["grads"], [slice(None)])
    p, r = norms(prog["grads"]), norms(ref["grads"])
    top = torch.argsort(gaps, descending=True)[:n].tolist()
    return [[names[i], float(gaps[i]), float(p[i]), float(r[i])]
            for i in top]
