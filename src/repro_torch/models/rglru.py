"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

Ports `repro/models/rglru.py`. The recurrence h_t = a_t * h_{t-1} +
sqrt(1 - a_t^2) * (i_t * x_t), with the input-gated decay a_t = exp(-c *
softplus(Lambda) * sigmoid(r_t)), is a first-order linear recurrence. Over a
full sequence the reference computes it with `jax.lax.associative_scan`
(log-depth); the port with `linear_scan`, a log-depth scan in plain PyTorch
(log2(S) out-of-place steps, which autograd runs through), not a loop over
positions. Decode is the O(1) step. Around it: a width-4 causal conv and a
GELU gate branch (the tanh form, `jax.nn.gelu`'s default), as in the
Griffin recurrent block. The gates and the recurrence are f32 throughout.

`rglru_prefill` returns (y, cache) in one pass, where the reference's
`rglru_apply` and `rglru_prefill_cache` run it twice; `rglru_decode`
writes the new state and conv tail into the cache's tensors in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.core import collectives as cl
from repro_torch.core import planner as pl
from repro_torch.models import common
from repro_torch.models.ssm import _causal_conv, _conv_step


def rglru_defs(d_model: int, r: RGLRUConfig, dtype) -> dict:
    w = r.lru_width
    return {
        "w_in": pl.ParamDef((d_model, w), pl.K_PROJ_IN, dtype),
        "w_gate": pl.ParamDef((d_model, w), pl.K_PROJ_IN, dtype),
        "conv": pl.ParamDef((w, r.conv_width), pl.K_CONV_MODEL, dtype,
                            init="scaled", init_scale=0.5),
        # per-channel recurrence parameters (sharded with the channel dim)
        "w_a": pl.ParamDef((w, w), pl.K_REPLICATED, dtype,
                           init="scaled", init_scale=0.02),
        "b_a": pl.ParamDef((w,), pl.K_VEC_MODEL, torch.float32, init="zeros"),
        "w_i": pl.ParamDef((w, w), pl.K_REPLICATED, dtype,
                           init="scaled", init_scale=0.02),
        "b_i": pl.ParamDef((w,), pl.K_VEC_MODEL, torch.float32, init="zeros"),
        "lam": pl.ParamDef((w,), pl.K_VEC_MODEL, torch.float32, init="ones"),
        "w_out": pl.ParamDef((w, d_model), pl.K_PROJ_OUT, dtype),
    }


def _gates(p: dict, x: torch.Tensor, r: RGLRUConfig, tp_axis=None):
    """x (..., w) post-conv branch input -> (a, gated input b) in f32.

    Under model parallelism (`tp_axis`) x is this rank's channels: the
    whole x is gathered over the group and multiplied by this rank's
    columns of the replicated (w, w) gate matrices. Both the gathered x
    and the matrices feed only this rank's channels, so they enter through
    the f operator, which sums their partial gradients over the group. The
    gated input reads this rank's channels of the gathered x, taken after
    the two products so that x's three cotangents add up in the order they
    do without a layout (bitwise at one rank)."""
    xa = x.to(torch.float32)
    w_a, w_i, xl = p["w_a"], p["w_i"], xa
    if tp_axis is not None:
        n = x.shape[-1]
        c0 = dist.get_rank(tp_axis) * n
        xa = cl.tp_replicate(cl.tp_all_gather(xa, tp_axis), tp_axis)
        w_a, w_i = (cl.tp_replicate(w, tp_axis)[:, c0:c0 + n]
                    for w in (w_a, w_i))
    rt = torch.sigmoid(xa @ w_a.to(torch.float32) + p["b_a"])
    it = torch.sigmoid(xa @ w_i.to(torch.float32) + p["b_i"])
    if tp_axis is not None:
        # sliced after the products, as the dense path reads x last: the
        # backward then adds x's three cotangents in the dense order
        xl = xa[..., c0:c0 + n]
    log_a = -r.c_constant * F.softplus(p["lam"]) * rt
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (it * xl)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, for every t:
    the reference's `associative_scan` of (a1 a2, a2 b1 + b2). Log-depth
    (Hillis-Steele): step k combines each position with the one 2^k
    before it, so after ceil(log2(S)) out-of-place steps every position
    holds the combination of all positions up to it."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _gate_out(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GELU gate branch on the block input x times the recurrence's h,
    back in x's dtype, through the output projection."""
    gate = common.act_fn("gelu")((x @ p["w_gate"]).to(torch.float32))
    return (h * gate).to(x.dtype) @ p["w_out"]


def rglru_prefill(p: dict, x: torch.Tensor, r: RGLRUConfig, *,
                  tp_axis=None):
    """The block over a full sequence x (B, S, d_model): returns (y, the
    cache after it: the last state h (B, w) f32 and the last W-1 pre-conv
    inputs). Under model parallelism (`tp_axis`) p holds this rank's
    channels of w_in, w_gate, conv, b_a, b_i and lam and rows of w_out
    (the gate matrices whole): x enters through the f operator, the
    out-projection's partial sum leaves through g, and the cache holds
    this rank's channels."""
    xr = x if tp_axis is None else cl.tp_replicate(x, tp_axis)
    pre = xr @ p["w_in"]
    a, b = _gates(p, _causal_conv(pre, p["conv"]), r, tp_axis)
    h = linear_scan(a, b)
    y = _gate_out(p, xr, h)
    if tp_axis is not None:
        y = cl.tp_psum(y, tp_axis)
    return y, {"h": h[:, -1, :], "conv": pre[:, -(r.conv_width - 1):, :]}


def rglru_apply(p: dict, x: torch.Tensor, r: RGLRUConfig, *,
                tp_axis=None) -> torch.Tensor:
    """Full-sequence forward. x (B, S, d_model); `tp_axis`: model
    parallelism over that group (`rglru_prefill`)."""
    return rglru_prefill(p, x, r, tp_axis=tp_axis)[0]


def rglru_init_cache(batch: int, r: RGLRUConfig, dtype, device=None) -> dict:
    return {
        "h": torch.zeros((batch, r.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, r.conv_width - 1, r.lru_width),
                            dtype=dtype, device=device),
    }


def rglru_decode(p: dict, x1: torch.Tensor, cache: dict, r: RGLRUConfig, *,
                 tp_axis=None):
    """One step. x1 (B, 1, d_model). Writes the new h and conv tail into
    `cache` in place; returns (y1 (B, 1, d_model), cache). Under model
    parallelism (`tp_axis`) p and the cache hold this rank's channels, as
    in `rglru_prefill`."""
    x = x1[:, 0, :]
    if tp_axis is not None:
        x = cl.tp_replicate(x, tp_axis)
    u, conv = _conv_step(x @ p["w_in"], cache["conv"], p["conv"])
    a, b = _gates(p, u, r, tp_axis)
    h = a * cache["h"] + b
    y = _gate_out(p, x, h)
    if tp_axis is not None:
        y = cl.tp_psum(y, tp_axis)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv)
    return y[:, None, :], cache
