"""Per-layer block assembly: norm + mixer + MLP with residuals.

Ports these kinds of `repro/models/blocks.py`:
  attn   -- (windowed) causal self-attention + dense MLP
  local  -- sliding-window causal self-attention + dense MLP (hybrid
            models; a window of 2048 where the config names none)
  mla    -- multi-head latent attention + dense MLP
  moe    -- the attn kind's attention and cache + a top-k MoE feed-forward
            (plus a parallel dense residual MLP where the config has one)
  ssm    -- Mamba-2 SSD mixer (no separate MLP, as in the source arch)
  rglru  -- RG-LRU recurrent mixer + dense MLP
  enc    -- bidirectional self-attention + MLP (encoder towers)
  cross  -- causal self-attention + cross-attention + MLP (enc-dec decoders)
with rmsnorm or layernorm: full-sequence apply, serving caches and
one-token decode. Under model parallelism (`BlockCtx.layout`) every kind
runs sharded by its layout: attention by head (or gathered), MLA, the SSM
and the RG-LRU by head or channel, the experts by expert or by their ff,
the MLPs by feature; under a hybrid plan the "attn" and "local" kinds
detect their shards from the shapes. Serving under model parallelism
keeps each cache leaf as the reference's cache layout splits it
(`BlockCtx.cache_split`).
`block_apply` returns (h, aux): the router's load-balance loss of a "moe"
block, None for every other kind (the reference's zero scalar, which the
port neither makes nor adds). A moe block trains and prefills on the
gather dispatch or, with `BlockCtx.moe_impl == "ep"`, on the
expert-parallel one (`moe.moe_apply_ep`); `Model.decode_step` gathers, as
the reference's `block_decode` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner as pl
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, mlp, moe, rglru, ssm

PORTED_KINDS = ("attn", "local", "mla", "moe", "ssm", "rglru", "enc",
                "cross")


def norm_defs(d: int, cfg: ModelConfig) -> dict:
    out = {"scale": pl.ParamDef((d,), pl.K_NORM, cfg.dtype, init="ones")}
    if cfg.norm == "layernorm":
        out["bias"] = pl.ParamDef((d,), pl.K_NORM, cfg.dtype, init="zeros")
    return out


def norm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return common.layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return common.rmsnorm(x, p["scale"], cfg.norm_eps)


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not yet ported to repro_torch "
            f"(ported: {PORTED_KINDS})")


def block_defs(kind: str, cfg: ModelConfig) -> dict:
    _check_kind(kind)
    d, dt = cfg.d_model, cfg.dtype
    if kind == "ssm":
        return {"ln1": norm_defs(d, cfg),
                "ssm": ssm.ssm_defs(d, cfg.ssm, dt)}
    if kind == "mla":
        mixer = {"mla": attn_mod.mla_defs(d, cfg.mla, dt)}
    elif kind == "rglru":
        mixer = {"rec": rglru.rglru_defs(d, cfg.rglru, dt)}
    else:
        mixer = {"attn": attn_mod.gqa_defs(d, cfg.attn, dt)}
    cross = ({"ln_x": norm_defs(d, cfg),
              "xattn": attn_mod.gqa_defs(d, cfg.attn, dt)}
             if kind == "cross" else {})
    ff = ({"moe": moe.moe_defs(d, cfg.moe, dt)} if kind == "moe" else
          {"mlp": mlp.mlp_defs(d, cfg.d_ff, dt, gated=cfg.mlp_gated)})
    return {"ln1": norm_defs(d, cfg), **mixer, **cross,
            "ln2": norm_defs(d, cfg), **ff}


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    """Runtime options passed down from the model (other block kinds'
    options come with their slices)."""

    cfg: ModelConfig
    window_override: Optional[int] = None  # force SWA on full-attn blocks
    enc_out: Optional[torch.Tensor] = None  # encoder output (cross blocks)
    # model parallelism: enc_out through the f operator, once for every
    # cross block (autograd then adds its cotangents as without a layout)
    enc_rep: Optional[torch.Tensor] = None
    kv_chunk: Optional[int] = None         # online-softmax attention chunk
    kv_dtype: str = "native"               # int8: quantized GQA KV cache
    # the activation-exchange group (process group) of model-sharded
    # blocks. Under a hybrid plan whether a given block actually runs
    # sharded is detected from its shard shapes (attn_tp / mlp_tp) -- the
    # per-layer plan leaves fallback layers replicated, and putting f/g
    # around full-size weights would multiply their output by the group
    # size.
    tp_axis: object = None
    # model parallelism: this block's model-sharded dimension per leaf
    # (Planner.model_dims), which shard shapes cannot tell (a shard of
    # half a head has a shape a whole head could have)
    layout: Optional[dict] = None
    # the moe blocks' dispatch (CommConfig.moe_impl): "ep" runs
    # moe_apply_ep over `model_group` with the tokens split over
    # `batch_groups`; its expert leaves arrive split on d over
    # `fsdp_groups` (this block's FSDP axes; () when they are whole) and
    # are gathered there, on the `wgather_wire`. The gather dispatch with
    # `batch_groups` routes the batch their ranks hold together (gspmd)
    moe_impl: str = "gather"
    model_group: object = None
    batch_groups: tuple = ()
    fsdp_groups: tuple = ()
    wgather_wire: str = "bf16"
    # serving under model parallelism: the model-split dimension of each
    # of this block's cache leaves (`transformer.cache_model_dim`), the
    # tree of its cache
    cache_split: Optional[dict] = None

    def attn_tp(self, p_attn: dict, a):
        if self.tp_axis is None:
            return None
        if self.layout is not None:
            return self.sub_tp("attn")[0]
        sharded = p_attn["wo"].shape[-2] != a.n_heads * a.head_dim
        return self.tp_axis if sharded else None

    def sub_tp(self, name: str):
        """(the model group, the layout of the block's sub-tree `name`)
        under model parallelism when any of its leaves is model-sharded,
        else (None, None)."""
        if self.tp_axis is None or self.layout is None:
            return None, None
        dims = self.layout[name]
        if all(d is None for d in tree_lib.leaves(dims)):
            return None, None
        return self.tp_axis, dims

    def mlp_tp(self, p_mlp: dict):
        if self.tp_axis is None:
            return None
        if self.layout is not None:
            return self.sub_tp("mlp")[0]
        return self.tp_axis if p_mlp["w2"].shape[-2] != self.cfg.d_ff else None

    def window_for(self, kind: str) -> Optional[int]:
        a = self.cfg.attn
        native = a.window if a is not None else None
        if kind == "local":
            native = native or 2048
        if self.window_override is not None:
            return (min(native, self.window_override) if native
                    else self.window_override)
        return native


def _mlp_residual(p: dict, h: torch.Tensor, cfg: ModelConfig,
                  tp_axis=None) -> torch.Tensor:
    x = norm_apply(p["ln2"], h, cfg)
    return h + mlp.mlp_apply(p["mlp"], x, act=cfg.mlp_act, gated=cfg.mlp_gated,
                             tp_axis=tp_axis)


def _moe_residual(p: dict, h: torch.Tensor, ctx: BlockCtx):
    """A moe block's feed-forward with its residual: (h, aux). The gather
    dispatch, or with `ctx.moe_impl == "ep"` the expert-parallel one (its
    dense residual MLP split over the model group with the layout)."""
    cfg = ctx.cfg
    x = norm_apply(p["ln2"], h, cfg)
    tp, lay = ctx.sub_tp("moe")
    if ctx.moe_impl == "ep":
        y, aux = moe.moe_apply_ep(
            p["moe"], x, cfg.moe, act=cfg.mlp_act,
            model_group=ctx.model_group, batch_groups=ctx.batch_groups,
            fsdp_groups=ctx.fsdp_groups, wgather_wire=ctx.wgather_wire,
            layout=lay)
    else:
        y, aux = moe.moe_apply(p["moe"], x, cfg.moe, act=cfg.mlp_act,
                               batch_groups=ctx.batch_groups, tp_axis=tp,
                               layout=lay)
    return h + y, aux


def _cross_residual(p: dict, h: torch.Tensor, kv: tuple, cfg: ModelConfig,
                    tp_axis=None, layout: Optional[dict] = None
                    ) -> torch.Tensor:
    """A cross block's cross-attention over the encoder's (k, v), with its
    residual (model-parallel with the xattn's group and layout)."""
    x = norm_apply(p["ln_x"], h, cfg)
    return h + attn_mod.gqa_cross(p["xattn"], x, kv, cfg.attn,
                                  tp_axis=tp_axis, layout=layout)


def block_apply(kind: str, p: dict, h: torch.Tensor, ctx: BlockCtx):
    """Returns (the block's output, its auxiliary loss: a moe block's
    router loss, None for the other kinds)."""
    _check_kind(kind)
    cfg = ctx.cfg
    x = norm_apply(p["ln1"], h, cfg)
    if kind == "ssm":
        return h + ssm.ssm_apply(p["ssm"], x, cfg.ssm,
                                 tp_axis=ctx.sub_tp("ssm")[0]), None
    if kind == "rglru":
        h = h + rglru.rglru_apply(p["rec"], x, cfg.rglru,
                                  tp_axis=ctx.sub_tp("rec")[0])
        return _mlp_residual(p, h, cfg, ctx.mlp_tp(p["mlp"])), None
    if kind == "mla":
        tp, lay = ctx.sub_tp("mla")
        h = h + attn_mod.mla_apply(p["mla"], x, cfg.mla,
                                   window=ctx.window_override,
                                   kv_chunk=ctx.kv_chunk, tp_axis=tp,
                                   layout=lay)
        return _mlp_residual(p, h, cfg, ctx.mlp_tp(p["mlp"])), None
    if kind == "cross":
        h = h + attn_mod.gqa_apply(p["attn"], x, cfg.attn,
                                   kv_chunk=ctx.kv_chunk,
                                   tp_axis=ctx.attn_tp(p["attn"], cfg.attn),
                                   layout=ctx.sub_tp("attn")[1])
        tp, lay = ctx.sub_tp("xattn")
        h = _cross_residual(p, h, attn_mod.gqa_cross_kv(
            p["xattn"], ctx.enc_out, cfg.attn, tp_axis=tp, layout=lay,
            enc_rep=ctx.enc_rep), cfg, tp, lay)
        return _mlp_residual(p, h, cfg, ctx.mlp_tp(p["mlp"])), None
    # attn, local and moe are causal; only the encoder's attention is not
    a = (dataclasses.replace(cfg.attn, causal=False) if kind == "enc"
         else cfg.attn)
    h = h + attn_mod.gqa_apply(p["attn"], x, a, window=ctx.window_for(kind),
                               kv_chunk=ctx.kv_chunk,
                               tp_axis=ctx.attn_tp(p["attn"], a),
                               layout=ctx.sub_tp("attn")[1])
    if kind == "moe":
        return _moe_residual(p, h, ctx)
    return _mlp_residual(p, h, cfg, ctx.mlp_tp(p["mlp"])), None


# --- caches ----------------------------------------------------------------------

def block_init_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     ctx: BlockCtx, device=None) -> dict:
    """The serving cache of one block: the attn and local kinds' (int8 with
    `ctx.kv_dtype`; local: a ring of its window), MLA's latent, the
    recurrent kinds' state and conv tails, or a cross block's {"self": its
    self-attention's, "cross": the encoder's K/V}. The encoder's blocks
    keep no cache."""
    _check_kind(kind)
    if kind == "ssm":
        return ssm.ssm_init_cache(batch, cfg.d_model, cfg.ssm, cfg.dtype,
                                  device=device)
    if kind == "rglru":
        return rglru.rglru_init_cache(batch, cfg.rglru, cfg.dtype,
                                      device=device)
    if kind == "mla":
        return attn_mod.mla_init_cache(batch, max_seq, cfg.mla, cfg.dtype,
                                       window=ctx.window_override,
                                       device=device)
    if kind == "cross":
        a = cfg.attn
        shape = (batch, cfg.encoder.n_frames, a.n_kv, a.head_dim)
        return {"self": attn_mod.gqa_init_cache(batch, max_seq, a, cfg.dtype,
                                                device=device),
                "cross": {n: torch.zeros(shape, dtype=cfg.dtype,
                                         device=device) for n in "kv"}}
    return attn_mod.gqa_init_cache(batch, max_seq, cfg.attn, cfg.dtype,
                                   window=ctx.window_for(kind),
                                   kv_dtype=ctx.kv_dtype, device=device)


def _split(ctx: BlockCtx, *names):
    """The model-split dimension of the cache leaf at `names` (None
    without a model axis or where the layout keeps it whole)."""
    t = ctx.cache_split
    for n in names:
        if t is None:
            return None
        t = t[n]
    return t


def block_prefill(kind: str, p: dict, h: torch.Tensor, ctx: BlockCtx):
    """`block_apply` over the prompt; returns (h, the block's cache after
    the prompt). Takes the place of the reference's `block_prefill_cache`,
    which projects the block input's K/V (MLA: its latent; cross: the
    encoder's K/V; the recurrent kinds: runs the scan) a second time.
    `ctx.kv_chunk` reaches every self-attention, as the reference's
    `block_apply` passes it.
    Under model parallelism the cache leaves hold this rank's heads or
    channels and every slot; `Model.prefill` keeps this rank's slots."""
    _check_kind(kind)
    cfg = ctx.cfg
    x = norm_apply(p["ln1"], h, cfg)
    if kind == "ssm":
        y, cache = ssm.ssm_prefill(p["ssm"], x, cfg.ssm,
                                   tp_axis=ctx.sub_tp("ssm")[0],
                                   split=ctx.cache_split)
        return h + y, cache
    mlp_tp = None if kind == "moe" else ctx.mlp_tp(p["mlp"])
    if kind == "rglru":
        y, cache = rglru.rglru_prefill(p["rec"], x, cfg.rglru,
                                       tp_axis=ctx.sub_tp("rec")[0])
        return _mlp_residual(p, h + y, cfg, mlp_tp), cache
    if kind == "mla":
        tp, lay = ctx.sub_tp("mla")
        y, cache = attn_mod.mla_prefill(p["mla"], x, cfg.mla,
                                        window=ctx.window_override,
                                        kv_chunk=ctx.kv_chunk, tp_axis=tp,
                                        layout=lay)
        return _mlp_residual(p, h + y, cfg, mlp_tp), cache
    tp, lay = ctx.sub_tp("attn")
    if kind == "cross":
        y, self_c = attn_mod.gqa_prefill(p["attn"], x, cfg.attn,
                                         kv_chunk=ctx.kv_chunk, tp_axis=tp,
                                         layout=lay,
                                         kv_split=_split(ctx, "self", "k"))
        xtp, xlay = ctx.sub_tp("xattn")
        k, v = attn_mod.gqa_cross_kv(p["xattn"], ctx.enc_out, cfg.attn,
                                     tp_axis=xtp, layout=xlay,
                                     enc_rep=ctx.enc_rep)
        h = _cross_residual(p, h + y, (k, v), cfg, xtp, xlay)
        if _split(ctx, "cross", "k") == 2 and not attn_mod.head_aligned(
                xlay, cfg.attn, dist.get_world_size(xtp)):
            k, v = (common.own_part(t, 2, xtp) for t in (k, v))
        return _mlp_residual(p, h, cfg, mlp_tp), {"self": self_c,
                                                  "cross": {"k": k, "v": v}}
    y, cache = attn_mod.gqa_prefill(p["attn"], x, cfg.attn,
                                    window=ctx.window_for(kind),
                                    kv_dtype=ctx.kv_dtype,
                                    kv_chunk=ctx.kv_chunk, tp_axis=tp,
                                    layout=lay, kv_split=_split(ctx, "k"))
    if kind == "moe":
        return _moe_residual(p, h + y, ctx)[0], cache
    return _mlp_residual(p, h + y, cfg, mlp_tp), cache


# --- decode ------------------------------------------------------------------------

def block_decode(kind: str, p: dict, h1: torch.Tensor, cache: dict, pos: int,
                 ctx: BlockCtx):
    """One token through the block; returns (h1, cache), the cache updated
    in place. Under model parallelism the cache is this rank's shard under
    the reference's cache layout (`ctx.cache_split`)."""
    _check_kind(kind)
    cfg = ctx.cfg
    x = norm_apply(p["ln1"], h1, cfg)
    if kind == "ssm":
        y, cache = ssm.ssm_decode(p["ssm"], x, cache, cfg.ssm,
                                  tp_axis=ctx.sub_tp("ssm")[0],
                                  split=ctx.cache_split)
        return h1 + y, cache
    mlp_tp = None if kind == "moe" else ctx.mlp_tp(p["mlp"])
    if kind == "rglru":
        y, cache = rglru.rglru_decode(p["rec"], x, cache, cfg.rglru,
                                      tp_axis=ctx.sub_tp("rec")[0])
        return _mlp_residual(p, h1 + y, cfg, mlp_tp), cache
    if kind == "mla":
        tp, lay = ctx.sub_tp("mla")
        y, cache = attn_mod.mla_decode(p["mla"], x, cache, pos, cfg.mla,
                                       window=ctx.window_override,
                                       tp_axis=tp, layout=lay,
                                       kv_split=_split(ctx, "ckv"))
        return _mlp_residual(p, h1 + y, cfg, mlp_tp), cache
    tp, lay = ctx.sub_tp("attn")
    if kind == "cross":
        y, _ = attn_mod.gqa_decode(p["attn"], x, cache["self"], pos, cfg.attn,
                                   tp_axis=tp, layout=lay,
                                   kv_split=_split(ctx, "self", "k"))
        h1 = h1 + y
        x = norm_apply(p["ln_x"], h1, cfg)
        xtp, xlay = ctx.sub_tp("xattn")
        h1 = h1 + attn_mod.gqa_decode_cross(
            p["xattn"], x, cache["cross"], cfg.attn, tp_axis=xtp,
            layout=xlay, kv_split=_split(ctx, "cross", "k"))
        return _mlp_residual(p, h1, cfg, mlp_tp), cache
    y, cache = attn_mod.gqa_decode(p["attn"], x, cache, pos, cfg.attn,
                                   window=ctx.window_for(kind), tp_axis=tp,
                                   layout=lay, kv_split=_split(ctx, "k"))
    if kind == "moe":
        # the B tokens of the step routed together, at their own capacity
        # (`Model.decode_step` puts them on the gather dispatch)
        return _moe_residual(p, h1 + y, ctx)[0], cache
    return _mlp_residual(p, h1 + y, cfg, mlp_tp), cache
