"""Dense MLPs (gated SwiGLU/GeGLU and plain 2-matrix)."""

from __future__ import annotations

import torch

from repro_torch.core import collectives as cl
from repro_torch.core import planner as pl
from repro_torch.models import common


def mlp_defs(d_model: int, d_ff: int, dtype, *, gated: bool = True) -> dict:
    d = {
        "w1": pl.ParamDef((d_model, d_ff), pl.K_PROJ_IN, dtype),
        "w2": pl.ParamDef((d_ff, d_model), pl.K_PROJ_OUT, dtype),
    }
    if gated:
        d["w3"] = pl.ParamDef((d_model, d_ff), pl.K_PROJ_IN, dtype)
    return d


def mlp_apply(p: dict, x: torch.Tensor, *, act: str = "silu",
              gated: bool = True, tp_axis=None) -> torch.Tensor:
    """tp_axis (a process group): feature-sharded tensor parallelism -- w1/w3
    column-sharded and w2 row-sharded over the group; x enters through the f
    operator and w2's partial sum leaves through g (collectives.tp_replicate
    / tp_psum)."""
    if tp_axis is not None:
        x = cl.tp_replicate(x, tp_axis)
    f = common.act_fn(act)
    h = f(x @ p["w1"])
    if gated:
        h = h * (x @ p["w3"])
    y = h @ p["w2"]
    if tp_axis is not None:
        y = cl.tp_psum(y, tp_axis)
    return y
