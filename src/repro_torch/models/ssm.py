"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

Ports `repro/models/ssm.py`. Training and prefill use the chunked SSD
algorithm: quadratic attention-like computation inside chunks plus a linear
recurrence over the chunk states. Decode is the O(1)-state recurrent step.
The reference computes all of it outside any Pallas kernel, and so does
the port: plain PyTorch, on the card and on the CPU alike.

Each three-operand `einsum` of the reference is written as pairwise
products, so the largest intermediate is fixed: (B, nc, H, Q, Q) for the
in-chunk decay and scores, never (B, nc, Q, H, N, P). The B and C
projections are shared by the heads of a group (G groups), as the
reference's `jnp.repeat` over heads makes them: the products here read each
group's B and C for its heads instead of a repeated copy. The in-chunk
decay is masked before its exponential (the reference masks after it): the
same values, but the hidden upper triangle, whose exponent grows with the
chunk, never overflows, so its gradient is 0 rather than NaN.

`ssm_prefill` returns (y, cache) in one pass: the reference's
`ssm_apply` and `ssm_prefill_cache` run the projections and the scan
twice. `ssm_decode` writes the new state and conv tails into the cache's
tensors in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.core import collectives as cl
from repro_torch.core import planner as pl
from repro_torch.models import common


def ssm_defs(d_model: int, s: SSMConfig, dtype) -> dict:
    d_inner = s.expand * d_model
    H = d_inner // s.head_dim
    GN = s.n_groups * s.d_state
    return {
        "w_z": pl.ParamDef((d_model, d_inner), pl.K_PROJ_IN, dtype),
        "w_x": pl.ParamDef((d_model, d_inner), pl.K_PROJ_IN, dtype),
        "w_B": pl.ParamDef((d_model, GN), pl.K_REPLICATED, dtype),
        "w_C": pl.ParamDef((d_model, GN), pl.K_REPLICATED, dtype),
        "w_dt": pl.ParamDef((d_model, H), pl.K_PROJ_IN, dtype),
        "conv_x": pl.ParamDef((d_inner, s.conv_width), pl.K_CONV_MODEL, dtype,
                              init="scaled", init_scale=0.5),
        "conv_B": pl.ParamDef((GN, s.conv_width), pl.K_REPLICATED, dtype,
                              init="scaled", init_scale=0.5),
        "conv_C": pl.ParamDef((GN, s.conv_width), pl.K_REPLICATED, dtype,
                              init="scaled", init_scale=0.5),
        "A_log": pl.ParamDef((H,), pl.K_VEC_MODEL, torch.float32,
                             init="zeros"),
        "D": pl.ParamDef((H,), pl.K_VEC_MODEL, torch.float32, init="ones"),
        "dt_bias": pl.ParamDef((H,), pl.K_VEC_MODEL, torch.float32,
                               init="zeros"),
        "norm": pl.ParamDef((d_inner,), pl.K_VEC_MODEL, dtype, init="ones"),
        "w_out": pl.ParamDef((d_inner, d_model), pl.K_PROJ_OUT, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (C, W); the reference's sum
    of W shifted products, in its order."""
    W, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[:, 0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[:, i]
    return out


def _conv_step(x1: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor):
    """x1 (B, C); conv_state (B, W-1, C) holding the previous inputs.
    Returns (y (B, C), the new state (B, W-1, C))."""
    full = torch.cat([conv_state, x1[:, None, :]], dim=1)     # (B, W, C)
    y = torch.einsum("bwc,cw->bc", full, w)
    return y, full[:, 1:, :]


def _ssd_chunked(xdt, a, Bm, Cm, s: SSMConfig, init_state=None):
    """Chunked SSD.

    xdt (B,S,H,P) -- inputs already scaled by dt
    a   (B,S,H)   -- log decay per step (dt * A, negative)
    Bm, Cm (B,S,G,N)
    Returns y (B,S,H,P) in xdt's dtype, final_state (B,H,N,P) f32.
    """
    Bsz, S, H, Pd = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(s.chunk, S)
    S_orig = S
    if S % Q:
        # pad to a whole number of chunks: zero inputs with zero log-decay
        # (exp(0) = 1) leave the final state and the kept outputs unchanged
        padn = Q - S % Q

        def pad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, padn))

        xdt, a, Bm, Cm = pad(xdt), pad(a), pad(Bm), pad(Cm)
        S = S + padn
    nc = S // Q
    rep = H // G
    f32 = torch.float32
    # chunked, heads first: x (B,nc,H,Q,P); the per-head log decay
    # (B,nc,H,Q) and its running sum in the chunk; B and C (B,nc,G,Q,N)
    x_ = xdt.to(f32).reshape(Bsz, nc, Q, H, Pd).permute(0, 1, 3, 2, 4)
    acum = torch.cumsum(a.to(f32).reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2),
                        dim=-1)
    B_ = Bm.to(f32).reshape(Bsz, nc, Q, G, N).permute(0, 1, 3, 2, 4)
    C_ = Cm.to(f32).reshape(Bsz, nc, Q, G, N).permute(0, 1, 3, 2, 4)

    def by_group(t):          # (B,nc,H,...) -> (B,nc,G,rep,...)
        return t.reshape(Bsz, nc, G, rep, *t.shape[3:])

    # --- intra-chunk (quadratic, attention-like) ---
    # L[i, j] = exp(acum_i - acum_j) for j <= i, else 0
    diff = acum[..., :, None] - acum[..., None, :]            # (B,nc,H,Q,Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    L = torch.exp(diff.masked_fill(~mask, float("-inf")))
    scores = C_ @ B_.transpose(-1, -2)                        # (B,nc,G,Q,Q)
    M = by_group(L) * scores[:, :, :, None]                   # (B,nc,G,rep,Q,Q)
    y_diag = M.reshape(Bsz, nc, H, Q, Q) @ x_                 # (B,nc,H,Q,P)

    # --- chunk states ---
    decay_to_end = torch.exp(acum[..., -1:] - acum)           # (B,nc,H,Q)
    xd = by_group(x_ * decay_to_end[..., None])               # (B,nc,G,rep,Q,P)
    # B^T (N, Q) @ (Q, rep P) per group
    states = (B_.transpose(-1, -2)
              @ xd.permute(0, 1, 2, 4, 3, 5).reshape(Bsz, nc, G, Q,
                                                     rep * Pd))
    states = states.reshape(Bsz, nc, G, N, rep, Pd).permute(
        0, 1, 2, 4, 3, 5).reshape(Bsz, nc, H, N, Pd)          # (B,nc,H,N,P)
    chunk_decay = torch.exp(acum[..., -1])                    # (B,nc,H)

    # --- inter-chunk recurrence over nc (linear scan) ---
    if init_state is None:
        prev = torch.zeros((Bsz, H, N, Pd), dtype=f32, device=xdt.device)
    else:
        prev = init_state.to(f32)
    entering = []                          # the state entering each chunk
    for c in range(nc):
        entering.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)                # (B,nc,H,N,P)

    # --- inter-chunk contribution ---
    # C (Q, N) @ state (N, P) per head, scaled by exp(acum) per row
    y_off = C_[:, :, :, None] @ by_group(prev_states)         # (B,nc,G,rep,Q,P)
    y_off = y_off.reshape(Bsz, nc, H, Q, Pd) * torch.exp(acum)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, Pd)
    return y[:, :S_orig].to(xdt.dtype), prev


def _project(p: dict, u: torch.Tensor) -> tuple:
    """The pre-conv projections x, B, C (B, S, *) and the f32 step sizes
    dt (B, S, H)."""
    dt = F.softplus((u @ p["w_dt"]).to(torch.float32) + p["dt_bias"])
    return u @ p["w_x"], u @ p["w_B"], u @ p["w_C"], dt


def _local_groups(t: torch.Tensor, H: int, s: SSMConfig, group):
    """The B or C groups (B, S, G, N) that this rank's H of the n_heads
    heads read: head h reads group h // (n_heads / G)."""
    G = t.shape[2]
    per = H * dist.get_world_size(group) // G     # heads a group
    h0 = dist.get_rank(group) * H
    if H % per == 0:
        return t[:, :, h0 // per:(h0 + H) // per]
    if per % H == 0:
        return t[:, :, h0 // per:h0 // per + 1]
    raise ValueError(f"{H} heads a rank straddle the SSM's groups of {per} "
                     f"heads")


def _mix(p: dict, u: torch.Tensor, s: SSMConfig, tp_axis=None):
    """The mixer over a full sequence: (its output (B, S, d_model), the
    final state (B, H, N, P) f32, and the pre-conv projections x, B, C).

    Under model parallelism (`tp_axis`) p holds this rank's heads of w_z,
    w_x, w_dt, conv_x, A_log, D, dt_bias and norm, and rows of w_out; w_B,
    w_C, conv_B and conv_C are whole. Every rank computes the shared B and
    C whole and its heads read them, so the replicated weights behind them
    enter through the f operator, as u does (once, for all five
    projections: autograd adds u's cotangents in the order it adds them
    without a layout); the gated norm averages its mean square over the
    group, and the out-projection's partial sum leaves through g."""
    B_, S, _ = u.shape
    G, N = s.n_groups, s.d_state
    if tp_axis is not None:
        u = cl.tp_replicate(u, tp_axis)
        p = {**p, **{n: cl.tp_replicate(p[n], tp_axis)
                     for n in ("w_B", "w_C", "conv_B", "conv_C")}}
    z = u @ p["w_z"]
    xr, Br, Cr, dt = _project(p, u)
    H = dt.shape[-1]                        # this rank's heads
    d_inner = H * s.head_dim
    x = F.silu(_causal_conv(xr, p["conv_x"]))
    Bm = F.silu(_causal_conv(Br, p["conv_B"])).reshape(B_, S, G, N)
    Cm = F.silu(_causal_conv(Cr, p["conv_C"])).reshape(B_, S, G, N)
    if tp_axis is not None:
        Bm, Cm = (_local_groups(t, H, s, tp_axis) for t in (Bm, Cm))
    A = -torch.exp(p["A_log"])                                # (H,)
    xh = x.reshape(B_, S, H, s.head_dim)
    xdt = xh * dt[..., None].to(xh.dtype)
    y, final = _ssd_chunked(xdt, dt * A, Bm, Cm, s)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B_, S, d_inner)
    y = common.rmsnorm(y * F.silu(z), p["norm"], group=tp_axis)
    out = y @ p["w_out"]
    if tp_axis is not None:
        out = cl.tp_psum(out, tp_axis)
    return out, final, (xr, Br, Cr)


def ssm_apply(p: dict, u: torch.Tensor, s: SSMConfig, *,
              tp_axis=None) -> torch.Tensor:
    """Full-sequence forward. u (B, S, d_model) -> (B, S, d_model);
    `tp_axis`: model parallelism over that group (`_mix`)."""
    return _mix(p, u, s, tp_axis)[0]


def ssm_init_cache(batch: int, d_model: int, s: SSMConfig, dtype,
                   device=None) -> dict:
    d_inner = s.expand * d_model
    H = d_inner // s.head_dim
    GN = s.n_groups * s.d_state
    W = s.conv_width
    return {
        "state": torch.zeros((batch, H, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, W - 1, d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, W - 1, GN), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, W - 1, GN), dtype=dtype, device=device),
    }


def ssm_prefill(p: dict, u: torch.Tensor, s: SSMConfig, *, tp_axis=None,
                split: dict | None = None):
    """`ssm_apply` over the prompt and the cache after it: the final state
    and the last W-1 pre-conv inputs of each conv. Returns (y, cache).
    Under model parallelism (`tp_axis`) the state and `conv_x` are this
    rank's heads and channels, as `_mix` computes them; `conv_B` and
    `conv_C`, computed whole, keep this rank's channels where the cache
    layout splits them (`split`: the model-split dimension of each cache
    leaf, or None)."""
    y, final, (xr, Br, Cr) = _mix(p, u, s, tp_axis)
    W = s.conv_width
    cache = {"state": final, "conv_x": xr[:, -(W - 1):, :],
             "conv_B": Br[:, -(W - 1):, :], "conv_C": Cr[:, -(W - 1):, :]}
    for name in ("conv_B", "conv_C"):
        if split and split[name] is not None:
            cache[name] = common.own_part(cache[name], -1, tp_axis)
    return y, cache


def ssm_decode(p: dict, u1: torch.Tensor, cache: dict, s: SSMConfig, *,
               tp_axis=None, split: dict | None = None):
    """One recurrent step. u1 (B, 1, d_model). Writes the new state and
    conv tails into `cache` in place; returns (y1 (B, 1, d_model),
    cache).

    Under model parallelism (`tp_axis`) p and the cache's state and
    `conv_x` hold this rank's heads and channels. The B and C
    projections are whole on every rank (their weights replicated); where
    the cache layout splits their conv tails (`split`), the whole tail is
    gathered (B x (W-1) x G*N, small) for the step and this rank's
    channels of the new tail kept."""
    B_ = u1.shape[0]
    G, N = s.n_groups, s.d_state
    u = u1[:, 0, :]
    if tp_axis is not None:
        u = cl.tp_replicate(u, tp_axis)
    z = u @ p["w_z"]
    xr, Br, Cr, dt = _project(p, u)                         # dt (B, H)
    H = dt.shape[-1]
    d_inner = H * s.head_dim
    x, conv_x = _conv_step(xr, cache["conv_x"], p["conv_x"])
    tails = {}
    for name, t in (("conv_B", Br), ("conv_C", Cr)):
        tail = cache[name]
        cut = split is not None and split[name] is not None
        if cut:
            tail = cl.tp_all_gather(tail, tp_axis)
        y_, new = _conv_step(t, tail, p[name])
        tails[name] = (y_, common.own_part(new, -1, tp_axis) if cut else new)
    x, Bm, Cm = (F.silu(x), F.silu(tails["conv_B"][0]),
                 F.silu(tails["conv_C"][0]))
    if tp_axis is not None:
        Bm, Cm = (_local_groups(t.reshape(B_, 1, G, N), H, s, tp_axis)
                  [:, 0] for t in (Bm, Cm))
    else:
        Bm, Cm = Bm.reshape(B_, G, N), Cm.reshape(B_, G, N)
    g = Bm.shape[1]                       # the groups this rank's heads read
    A = -torch.exp(p["A_log"])                                # (H,)
    xh = x.reshape(B_, H, s.head_dim).to(torch.float32)
    Bh = Bm.reshape(B_, g, 1, N).expand(B_, g, H // g, N).reshape(B_, H, N)
    Ch = Cm.reshape(B_, g, 1, N).expand(B_, g, H // g, N).reshape(B_, H, N)
    decay = torch.exp(dt * A)                                  # (B, H)
    state = (cache["state"] * decay[:, :, None, None]
             + Bh.to(torch.float32)[..., None]
             * (dt[..., None] * xh)[:, :, None, :])            # (B,H,N,P)
    y = (Ch.to(torch.float32)[:, :, None, :] @ state)[:, :, 0]  # (B,H,P)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B_, d_inner).to(u.dtype)
    y = common.rmsnorm(y * F.silu(z), p["norm"], group=tp_axis)
    cache["state"].copy_(state)
    cache["conv_x"].copy_(conv_x)
    cache["conv_B"].copy_(tails["conv_B"][1])
    cache["conv_C"].copy_(tails["conv_C"][1])
    out = y @ p["w_out"]
    if tp_axis is not None:
        out = cl.tp_psum(out, tp_axis)
    return out[:, None, :], cache
