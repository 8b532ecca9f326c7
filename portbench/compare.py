"""The comparison that decides ``correct`` for a training cell.

Both sides report the same readings of the first steps, each a map from a
leaf key (a parameter path, and its layer for a stacked leaf) to the (n,)
per-node norms of that leaf:

``loss``     each set-up step's mean loss (a list, one per step);
``grad``     the oracle's sample after step 1 (g⁻: every node's clipped
             R-micro-batch gradient at the mixed x¹);
``tracker``  h after step 1 (the tracker after its gossip window);
``change``   x after the set-up steps minus x⁰;
``res``      the error-feedback residuals after step 1 (compressing only),
             keyed by stream and whole leaf.

A number compares the program's norm with the reference's leaf by leaf, as
the gap of the two norms over the larger of the reference's norm of that leaf
and the median leaf's, and takes the worst leaf and node (``*_gap``): the gap
between norms, not the norm of the difference.  ``*_median_gap`` takes the
median entry instead, for a number whose worst leaf is a small one that one
quantization step rounded the other way moves (the tracker and the residuals
of a compressed window: a cell's limits file names the numbers it compares).
Leaves whose reference gradient is under a thousandth of the median leaf's
(a key bias under the softmax, whose gradient is nought but for rounding)
are left out of every norm number, by that rule and not by name.  ``loss_gap`` is the worst step's relative gap.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("loss_gap", "grad_gap", "tracker_gap", "change_gap", "res_gap",
           "tracker_median_gap", "res_median_gap")
ZERO_GRAD = 1e-3        # a leaf below this share of the median is left out


def _kept(ref_grad: dict) -> dict:
    """{leaf key: (n,) bool} of the entries that count."""
    allv = torch.cat([v for v in ref_grad.values()])
    floor = ZERO_GRAD * float(allv.median())
    return {k: v >= floor for k, v in ref_grad.items()}


def _whole_leaf_kept(ref_grad: dict) -> dict:
    """The rule on whole leaves: {path: (n,) bool} from the layers' norms."""
    sq: dict = {}
    for (path, _), v in ref_grad.items():
        sq[path] = sq.get(path, 0) + v * v
    whole = {p: v.sqrt() for p, v in sq.items()}
    allv = torch.cat(list(whole.values()))
    floor = ZERO_GRAD * float(allv.median())
    return {p: v >= floor for p, v in whole.items()}


def _entry_gaps(prog: dict, ref: dict, keep) -> list:
    """[(gap, key, node)] of every entry that counts, as :func:`_worst`
    measures them."""
    refs = torch.cat([ref[k][keep(k)] for k in ref])
    if not refs.numel():
        return []
    med = float(refs.median())
    out = []
    for k, r in ref.items():
        m = keep(k)
        gap = (prog[k] - r).abs() / torch.clamp(r, min=med)
        out += [(float(gap[i]), k, i) for i in range(len(r)) if m[i]]
    return out


def _keeps(ref: dict) -> dict:
    """The rule on the reference's gradient, for each norm reading."""
    kept = _kept(ref["grad"])
    whole = _whole_leaf_kept(ref["grad"])
    return {"grad": kept.__getitem__, "tracker": kept.__getitem__,
            "change": kept.__getitem__, "res": lambda k: whole[k[1]]}


def describe(prog: dict, ref: dict) -> list:
    """Lines on each norm reading: its worst entry and its median entry,
    for reading where a number's gap comes from."""
    lines = []
    for name, keep in _keeps(ref).items():
        g = sorted(_entry_gaps(prog[name], ref[name], keep)) \
            if name in ref else []
        if g:
            lines.append(f"{name}: worst {g[-1][0]!r} at {g[-1][1]} node "
                         f"{g[-1][2]}, median {g[len(g) // 2][0]!r}, "
                         f"{len(g)} entries")
    return lines


def gaps(prog: dict, ref: dict) -> dict:
    """{number: value} of the program's readings against the reference's."""
    lp, lr = prog["loss"], ref["loss"]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr))}
    for name, keep in _keeps(ref).items():
        if not ref.get(name):
            continue
        g = sorted(x[0] for x in _entry_gaps(prog[name], ref[name], keep))
        out[f"{name}_gap"] = g[-1] if g else math.nan
        if name in ("tracker", "res"):
            out[f"{name}_median_gap"] = g[len(g) // 2] if g else math.nan
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, checks): each compared number beside its limit; a number
    that is not finite, or above its limit, fails."""
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in NUMBERS if name in values and name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return bool(ok and checks), checks
