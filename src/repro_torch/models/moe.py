"""Mixture-of-Experts layers: top-k token-choice routing.

Ports `repro/models/moe.py`. Two dispatch implementations, both
capacity-based (GShard semantics: overflow tokens are dropped from the
expert path and kept by the residual):

  * `moe_apply` -- sort-based dispatch with static shapes: a stable sort
    of the token choices by expert, a scatter into an (E, C, d) buffer,
    batched expert matmuls, an `index_add_` back. The expert FFN and the
    dispatch are plain PyTorch, as they are plain jnp in the reference.

  * `moe_apply_ep` -- explicit expert parallelism over process groups:
    each rank of the model group routes its 1/ep slice of the local tokens,
    exchanges token slots with the expert owners through
    `all_to_all_single`, runs its local experts and reverses the exchange
    (the reference's hand-scheduled shard_map path). Expert weights may
    arrive sharded on d over the FSDP groups and are gathered just in time
    (`collectives.fsdp_gather`), on the int8 wire with
    `wgather_wire="int8"` (`_Int8WeightGather`). The train step reaches it
    through the moe block with `CommConfig(moe_impl="ep")`.

Routing follows the reference to the tie: the router runs in f32, and the
top k come from a stable descending sort, so equal probabilities take the
lowest expert index first, as `jax.lax.top_k` does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import collectives as cl
from repro_torch.core import planner as pl
from repro_torch.kernels import ops as kops
from repro_torch.models import common, mlp

WGATHER_BLOCK = 512      # quantization block of the int8 weight gather


def moe_defs(d_model: int, m: MoEConfig, dtype) -> dict:
    d = {
        "router": pl.ParamDef((d_model, m.n_experts), pl.K_REPLICATED,
                              torch.float32),
        "w1": pl.ParamDef((m.n_experts, d_model, m.d_ff), pl.K_EXPERT_IN,
                          dtype),
        "w2": pl.ParamDef((m.n_experts, m.d_ff, d_model), pl.K_EXPERT_OUT,
                          dtype),
        "w3": pl.ParamDef((m.n_experts, d_model, m.d_ff), pl.K_EXPERT_IN,
                          dtype),
    }
    if m.dense_residual_ff:
        d["dense"] = mlp.mlp_defs(d_model, m.dense_residual_ff, dtype)
    return d


def capacity(n_tokens: int, m: MoEConfig) -> int:
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, ((c + 7) // 8) * 8)     # sublane-aligned


def _router(xf: torch.Tensor, router_w: torch.Tensor, m: MoEConfig):
    """xf (T, d) -> (probs (T, E) f32, weights (T, k) f32, ids (T, k)
    int64)."""
    logits = xf.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[:, :m.top_k], ids[:, :m.top_k]
    weights = weights / torch.clamp_min(
        torch.sum(weights, dim=-1, keepdim=True), 1e-9)
    return probs, weights, ids


def _load_balance(probs: torch.Tensor, top1: torch.Tensor, n_tokens: int,
                  m: MoEConfig) -> torch.Tensor:
    """The load-balance auxiliary loss (Switch/GShard), E * sum_e f_e * p_e:
    p the mean of `probs`, f the share of `n_tokens` whose first choice is
    e (`top1`, f32 counts per expert)."""
    me = torch.mean(probs, dim=0)
    ce = top1 / torch.tensor(n_tokens, dtype=torch.float32,
                             device=probs.device)
    return m.n_experts * torch.sum(me * ce)


def route(xf: torch.Tensor, router_w: torch.Tensor, m: MoEConfig):
    """xf (T, d) -> (weights (T, k) f32, ids (T, k) int64, aux_loss f32
    scalar)."""
    probs, weights, ids = _router(xf, router_w, m)
    one_hot = F.one_hot(ids[:, 0], m.n_experts).to(torch.float32)
    return weights, ids, _load_balance(probs, torch.sum(one_hot, dim=0),
                                       xf.shape[0], m)


def most_kept(kept: torch.Tensor, cap: int, n_rank_tokens: int) -> int:
    """The most choices of one expert this rank keeps, read on the host.
    The dry-run, whose tensors hold no values, puts a shape rule in its
    place (`launch/dryrun.py:expert_slots_bound`)."""
    return int(kept.max())


def _global_routing(probs: torch.Tensor, ids: torch.Tensor, m: MoEConfig,
                    batch_groups: Sequence):
    """The routing of the whole batch when the data ranks hold its rows in
    rank order (row-major over `batch_groups`), as the reference's gspmd
    step routes the global batch in one piece. From every rank's count of
    choices per expert: (this rank's offset in each expert's queue (E,),
    the capacity of the whole batch, the slots a rank's expert buffer needs
    (its most choices of one expert inside the capacity, rounded up to 8),
    the load-balance term: the whole batch's top-1 shares against this
    rank's mean probabilities, so that its mean over the ranks is the
    whole batch's)."""
    E = m.n_experts

    def count(e):
        return torch.zeros(E, dtype=torch.int64, device=e.device).scatter_add_(
            0, e, torch.ones_like(e))
    counts = torch.stack([count(ids.reshape(-1)), count(ids[:, 0])])
    table, rank = counts[None], 0
    for g in reversed(batch_groups):     # innermost axis first
        table = cl._all_gather(table, g)
    for g in batch_groups:
        rank = rank * dist.get_world_size(g) + dist.get_rank(g)
    n_tokens = table.shape[0] * ids.shape[0]
    cap = capacity(n_tokens, m)
    offset = torch.sum(table[:rank, 0], dim=0)
    kept = torch.clamp(torch.minimum(counts[0], cap - offset), min=0)
    slots = max(8, (most_kept(kept, cap, ids.shape[0]) + 7) // 8 * 8)
    aux = _load_balance(probs, torch.sum(table[:, 1], dim=0).to(
        torch.float32), n_tokens, m)
    return offset, cap, slots, aux


def _expert_ffn(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                xe: torch.Tensor, act: str) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d) with a per-expert gated FFN."""
    f = common.act_fn(act)
    h = f(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(h, w2)


def _dispatch_indices(ids: torch.Tensor, m: MoEConfig, cap: int, *,
                      offset: torch.Tensor | None = None,
                      slots: int | None = None):
    """Sort-based capacity dispatch with static shapes.

    Returns (slot_token (E*C,) token index feeding each expert slot,
             slot_valid (E*C,) bool,
             slot_wsrc (E*C,) index into the flat (T*k,) weight vector).
    Every token choice past its expert's capacity writes the sentinel slot
    E*C, which is sliced off. With `offset` (E,) the tokens are a rank's
    rows of a larger batch, preceded in each expert's queue by `offset`
    choices: a choice is kept while its place in the whole queue is under
    `cap`, and its slot is its place among this rank's choices, C = `slots`
    of them an expert."""
    dev = ids.device
    slots = cap if slots is None else slots
    n_slots = m.n_experts * slots
    flat_e = ids.reshape(-1)                          # (T*k,) expert of choice
    order = torch.argsort(flat_e, stable=True)        # group by expert
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(m.n_experts, device=dev, dtype=sorted_e.dtype),
        side="left")
    pos_in_group = torch.arange(flat_e.shape[0], device=dev) \
        - group_start[sorted_e]
    place = pos_in_group if offset is None else pos_in_group + offset[sorted_e]
    dest = torch.where(place < cap, sorted_e * slots + pos_in_group, n_slots)
    slot_token = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    slot_wsrc = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    slot_token[dest] = order // m.top_k
    slot_valid[dest] = True
    slot_wsrc[dest] = order
    return slot_token[:-1], slot_valid[:-1], slot_wsrc[:-1]


def _gather_slots(xf: torch.Tensor, slot_token: torch.Tensor,
                  slot_valid: torch.Tensor) -> torch.Tensor:
    """(E*C, d): each slot's token, zero where the slot is empty."""
    return xf[slot_token] * slot_valid[:, None].to(xf.dtype)


def _combine(yf: torch.Tensor, weights: torch.Tensor, slot_token, slot_valid,
             slot_wsrc, n_tokens: int) -> torch.Tensor:
    """(T, d): each token's expert outputs weighted by its routing weights,
    added in the activations' dtype (at most top_k non-zero terms a token,
    so the order of the adds does not change the sum)."""
    w_slot = weights.reshape(-1)[slot_wsrc] * slot_valid.to(torch.float32)
    contrib = yf * w_slot[:, None].to(yf.dtype)
    return torch.zeros((n_tokens, yf.shape[-1]), dtype=yf.dtype,
                       device=yf.device).index_add(0, slot_token, contrib)


def moe_apply(p: dict, x: torch.Tensor, m: MoEConfig, *,
              act: str = "silu", batch_groups: Sequence = (), tp_axis=None,
              layout: dict | None = None):
    """x (B, S, d) -> (y (B, S, d), aux_loss). All B*S tokens are routed
    together, at the capacity of that many tokens. With `batch_groups` of
    more than one rank, x is this rank's rows of the batch the data ranks
    hold together, and the whole batch is routed as one
    (`_global_routing`: the reference's gspmd step).

    Under model parallelism (`tp_axis`, the leaves' `layout`) the expert
    leaves are this rank's experts (split at E, the reference's choice
    when E divides by the group size) or its slice of every expert's ff
    (w1/w3 by column, w2 by row). The router, top-k, capacity and
    load-balance term run replicated and identical on every rank; the
    tokens enter the expert slots, and the routing weights the combine,
    through the f operator; a rank runs its experts' slots or its ff slice
    of all of them, and its partial combine leaves through g. The dense
    residual MLP, when split, is the column/row-split MLP."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    offset = None
    if batch_groups and cl.axis_size(batch_groups) > 1:
        probs, weights, ids = _router(xf, p["router"], m)
        offset, cap, slots, aux = _global_routing(probs, ids, m,
                                                  batch_groups)
    else:
        cap = slots = capacity(T, m)
        weights, ids, aux = route(xf, p["router"], m)
    idx = _dispatch_indices(ids, m, cap, offset=offset, slots=slots)
    e_loc = p["w1"].shape[0]
    if tp_axis is not None:
        xf = cl.tp_replicate(xf, tp_axis)
        weights = cl.tp_replicate(weights, tp_axis)
        if layout["w1"] == -3:            # this rank's experts' slots
            e0 = dist.get_rank(tp_axis) * e_loc
            idx = tuple(t[e0 * slots:(e0 + e_loc) * slots] for t in idx)
    slot_token, slot_valid, slot_wsrc = idx
    xe = _gather_slots(xf, slot_token, slot_valid).reshape(e_loc, slots, d)
    ye = _expert_ffn(p["w1"], p["w2"], p["w3"], xe, act)
    y = _combine(ye.reshape(e_loc * slots, d), weights, slot_token,
                 slot_valid, slot_wsrc, T).reshape(B, S, d)
    if tp_axis is not None:
        y = cl.tp_psum(y, tp_axis)
    if "dense" in p:
        y = y + _dense(p, x, act, tp_axis, layout)
    return y, aux


def _dense(p: dict, x: torch.Tensor, act: str, group, layout) -> torch.Tensor:
    """The dense residual MLP on the whole x, column/row-split over `group`
    when the `layout` splits it."""
    split = layout is not None and layout["dense"]["w1"] is not None
    return mlp.mlp_apply(p["dense"], x, act=act,
                         tp_axis=group if split else None)


# --- explicit expert parallelism over process groups ----------------------------
#
# Gradient convention: the outputs (y, aux) are replicated over the model
# group and every rank of it computes the same loss from them, as under the
# tensor-parallel f/g pair; over the batch (and FSDP) groups the ranks hold
# different tokens and their losses add up. So the inputs replicated over
# the model group (x, the router) get their whole gradient on every model
# rank (the f operator all-reduces it there), y's all-gather keeps this
# rank's slice of the cotangent, and gradients of weights replicated over
# the batch groups are each rank's part of a sum the caller reduces.

class _Int8WeightGather(torch.autograd.Function):
    """The ZeRO weight all-gather of a shard along `axis` over `group`, in
    rank order, on the int8 wire (the reference's `_quantized_gather`,
    paper C6 applied to the FSDP data path): each shard travels as int8
    codes and f32 scales (`kops.quantize`, blocks of 512) and is
    dequantized part by part. The backward is the exact vjp of the
    unquantized gather (`collectives.fsdp_gather`'s), a reduce-scatter of
    the cotangent along `axis`: the straight-through rule, without which
    round() would zero the weights' gradients."""

    @staticmethod
    def forward(ctx, w, group, axis):
        ctx.group, ctx.axis = group, axis
        p = dist.get_world_size(group)
        q, s, meta = kops.quantize(w, block=WGATHER_BLOCK)
        qg = cl._all_gather(q, group).chunk(p)
        sg = cl._all_gather(s, group).chunk(p)
        return torch.cat([kops.dequantize(qi, si, meta)
                          for qi, si in zip(qg, sg)], dim=axis)

    @staticmethod
    def backward(ctx, ct):
        g = cl._psum_scatter(ct.movedim(ctx.axis, 0), ctx.group)
        return g.movedim(0, ctx.axis).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all along dim 0 over `group`: block j goes to rank j;
    the received blocks come back in rank order. Its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all(ct, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _GroupMean(torch.autograd.Function):
    """The mean of a replicated-per-rank scalar over the model and batch
    groups. Under the convention above its cotangent is the same on the
    ranks of a model group and adds up over the batch groups."""

    @staticmethod
    def forward(ctx, x, model_group, batch_groups):
        groups = [model_group, *batch_groups]
        ctx.batch_groups, ctx.n = batch_groups, cl.axis_size(groups)
        return cl._div(cl._psum(x, groups), ctx.n)

    @staticmethod
    def backward(ctx, ct):
        return cl._div(cl._psum(ct, ctx.batch_groups), ctx.n), None, None


def moe_apply_ep(p: dict, x: torch.Tensor, m: MoEConfig, *, act: str,
                 model_group, batch_groups: Sequence = (),
                 fsdp_groups: Sequence = (), wire_bf16_a2a: bool = False,
                 wgather_wire: str = "bf16", layout: dict | None = None):
    """Expert parallelism over the process group `model_group` (ep ranks).

    x (b_loc, S, d) is this rank's batch shard, replicated over the model
    group; the router is replicated; p's expert leaves are this rank's
    shard, experts [r*E/ep, (r+1)*E/ep) of model rank r, and with
    `fsdp_groups` also a 1/size slice of d over each (gathered in reverse
    order, on the int8 wire when `wgather_wire="int8"`). Each model rank
    routes its t_loc = b_loc*S/ep tokens at the capacity of t_loc tokens,
    exchanges the slots with `all_to_all_single` (in bf16 with
    `wire_bf16_a2a`), runs its experts, exchanges back and adds its tokens'
    outputs; y is all-gathered over the model group, and aux is the mean of
    every source rank's aux over the model and batch groups. Returns (y,
    aux); the dense residual MLP, when p has one, runs on the whole x,
    column/row-split over the model group when the leaves' `layout`
    (model parallelism) splits it."""
    if wgather_wire not in ("bf16", "int8"):
        raise ValueError(f"unknown weight-gather wire {wgather_wire!r}")
    ep = dist.get_world_size(model_group)
    r = dist.get_rank(model_group)
    if m.n_experts % ep:
        raise ValueError(f"{m.n_experts} experts do not split over {ep} "
                         f"model ranks")
    e_local = m.n_experts // ep
    w1, w2, w3 = p["w1"], p["w2"], p["w3"]
    if fsdp_groups and wgather_wire == "int8":
        for g in reversed(list(fsdp_groups)):
            w1, w3, w2 = (_Int8WeightGather.apply(w, g, axis)
                          for w, axis in ((w1, 1), (w3, 1), (w2, 2)))
    elif fsdp_groups:
        w1, w3, w2 = (cl.fsdp_gather(w, list(fsdp_groups), axis)
                      for w, axis in ((w1, 1), (w3, 1), (w2, 2)))
    b, S, d = x.shape
    T = b * S
    if T % ep:
        raise ValueError(f"{T} local tokens do not split over {ep} model "
                         f"ranks")
    t_loc = T // ep
    xr = cl.tp_replicate(x, [model_group])
    my = xr.reshape(T, d)[r * t_loc:(r + 1) * t_loc]
    router = cl.tp_replicate(p["router"], [model_group])
    weights, ids, aux = route(my, router, m)
    cap = capacity(t_loc, m)            # per source rank, per expert
    slot_token, slot_valid, slot_wsrc = _dispatch_indices(ids, m, cap)
    # (E*C, d) -> (ep, e_local*C, d): block j goes to expert-owner rank j
    send = _gather_slots(my, slot_token, slot_valid).reshape(
        ep, e_local * cap, d)
    if wire_bf16_a2a:
        send = send.to(torch.bfloat16)
    recv = _AllToAll.apply(send, model_group).to(x.dtype)
    # recv: the slots of every source rank for my experts
    xe_mine = recv.reshape(ep, e_local, cap, d).transpose(0, 1).reshape(
        e_local, ep * cap, d)
    ye = _expert_ffn(w1, w2, w3, xe_mine, act)
    back = ye.reshape(e_local, ep, cap, d).transpose(0, 1).reshape(
        ep, e_local * cap, d)
    if wire_bf16_a2a:
        back = back.to(torch.bfloat16)
    got = _AllToAll.apply(back, model_group).to(x.dtype)
    y_my = _combine(got.reshape(m.n_experts * cap, d), weights, slot_token,
                    slot_valid, slot_wsrc, t_loc)
    # every model rank's tokens, in rank order (gathered along dim 0
    # through the last-dimension gather)
    y = cl.tp_all_gather(y_my.T, model_group).T.reshape(b, S, d)
    aux = _GroupMean.apply(aux, model_group, list(batch_groups))
    if "dense" in p:
        y = y + _dense(p, x, act, model_group, layout)
    return y, aux
