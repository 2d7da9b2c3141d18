"""What the correctness check reads from a training run, and how two runs'
readings are compared.

A run's readings: the loss of each of the first steps, the norm of each
leaf of the first step's gradient as the optimizer got it, and the norm of
each leaf's change over the first steps. A stacked leaf (one slice a
layer) counts as one leaf a layer. Both norms are compared by the worst
leaf: the gap between the two runs' norms over the reference's norm of
that leaf or its median leaf's, whichever is larger. The change is read
only on leaves whose reference gradient is at least a thousandth of the
median leaf's: a leaf with no gradient moves by weight decay and round-off
alone. Besides the worst leaf's gap, the median leaf's gap of each norm
is read: the steadier number where the worst leaf is a small leaf's
noise. A cell compares the numbers its check names a limit for."""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "grad_gap", "grad_median_gap", "delta_gap",
           "delta_median_gap")
EXCLUDE_BELOW = 1e-3


def leaf_norms(path: tuple, t: torch.Tensor, stacked: bool) -> dict:
    """{leaf name: norm} of one tensor, one entry a layer if stacked."""
    name = "/".join(path)
    t = t.float()
    if not stacked:
        return {name: float(torch.linalg.vector_norm(t))}
    norms = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1)
    return {f"{name}#{i}": float(v) for i, v in enumerate(norms.tolist())}


def _worst(values) -> float:
    """The largest value; a value that is not a number (a NaN from a run
    that diverged) reads as infinite."""
    values = list(values)
    return math.inf if any(math.isnan(v) for v in values) else max(values)


def _gaps(run: dict, ref: dict, keys) -> list:
    """Each leaf's gap over the larger of its reference norm and the
    median leaf's."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return [abs(run[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def _median(values) -> float:
    values = list(values)
    return math.inf if any(math.isnan(v) for v in values) else \
        statistics.median(values)


def compare(run: dict, ref: dict) -> dict:
    """{number: value} of `run`'s readings against the reference's."""
    if run["grad"].keys() != ref["grad"].keys():
        raise ValueError("the runs read different leaves")
    losses = [abs(a - b) / abs(b) for a, b in zip(run["loss"], ref["loss"])]
    med = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= EXCLUDE_BELOW * med]
    grad = _gaps(run["grad"], ref["grad"], ref["grad"])
    delta = _gaps(run["delta"], ref["delta"], moved)
    return {"loss_gap": _worst(losses), "grad_gap": _worst(grad),
            "grad_median_gap": _median(grad), "delta_gap": _worst(delta),
            "delta_median_gap": _median(delta)}


def worst_leaves(run: dict, ref: dict, n: int = 3) -> dict:
    """The n leaves with the largest gradient and change gaps, with their
    gaps and the two runs' norms (to see what a number is made of)."""
    out = {}
    med_g = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= EXCLUDE_BELOW * med_g]
    for key, keys in (("grad", list(ref["grad"])), ("delta", moved)):
        med = statistics.median(ref[key][k] for k in keys)
        gaps = sorted(((abs(run[key][k] - ref[key][k])
                        / max(ref[key][k], med, 1e-30), k) for k in keys),
                      reverse=True)[:n]
        out[key] = [[k, g, run[key][k], ref[key][k]] for g, k in gaps]
    return out
