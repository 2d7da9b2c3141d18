"""Per-layer block assembly: norm + mixer + MLP with residuals.

Ports the "attn" block kind of `repro/models/blocks.py` (causal
self-attention + dense MLP): full-sequence apply, serving caches and
one-token decode. The other kinds come with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner as pl
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, mlp

PORTED_KINDS = ("attn",)


def norm_defs(d: int, cfg: ModelConfig) -> dict:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not yet ported")
    return {"scale": pl.ParamDef((d,), pl.K_NORM, cfg.dtype, init="ones")}


def norm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return common.rmsnorm(x, p["scale"], cfg.norm_eps)


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not yet ported to repro_torch "
            f"(ported: {PORTED_KINDS})")


def block_defs(kind: str, cfg: ModelConfig) -> dict:
    _check_kind(kind)
    d, dt = cfg.d_model, cfg.dtype
    return {"ln1": norm_defs(d, cfg),
            "attn": attn_mod.gqa_defs(d, cfg.attn, dt),
            "ln2": norm_defs(d, cfg),
            "mlp": mlp.mlp_defs(d, cfg.d_ff, dt, gated=cfg.mlp_gated)}


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    """Runtime options passed down from the model (the reference's
    parallelism and other block kinds' options come with their slices)."""

    cfg: ModelConfig
    window_override: Optional[int] = None  # force SWA on full-attn blocks
    kv_dtype: str = "native"               # int8: quantized GQA KV cache

    def window_for(self, kind: str) -> Optional[int]:
        a = self.cfg.attn
        native = a.window if a is not None else None
        if self.window_override is not None:
            return (min(native, self.window_override) if native
                    else self.window_override)
        return native


def _mlp_residual(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = norm_apply(p["ln2"], h, cfg)
    return h + mlp.mlp_apply(p["mlp"], x, act=cfg.mlp_act, gated=cfg.mlp_gated)


def block_apply(kind: str, p: dict, h: torch.Tensor,
                ctx: BlockCtx) -> torch.Tensor:
    """Returns the block's output. (The reference also returns an auxiliary
    loss, which only its MoE kind makes.)"""
    _check_kind(kind)
    cfg = ctx.cfg
    x = norm_apply(p["ln1"], h, cfg)
    h = h + attn_mod.gqa_apply(p["attn"], x, cfg.attn,
                               window=ctx.window_for(kind))
    return _mlp_residual(p, h, cfg)


# --- caches ----------------------------------------------------------------------

def block_init_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     ctx: BlockCtx, device=None) -> dict:
    _check_kind(kind)
    return attn_mod.gqa_init_cache(batch, max_seq, cfg.attn, cfg.dtype,
                                   window=ctx.window_for(kind),
                                   kv_dtype=ctx.kv_dtype, device=device)


def block_prefill(kind: str, p: dict, h: torch.Tensor, ctx: BlockCtx):
    """`block_apply` over the prompt; returns (h, the block's cache after
    the prompt). Takes the place of the reference's `block_prefill_cache`,
    which projects the block input's K/V a second time."""
    _check_kind(kind)
    cfg = ctx.cfg
    x = norm_apply(p["ln1"], h, cfg)
    y, cache = attn_mod.gqa_prefill(p["attn"], x, cfg.attn,
                                    window=ctx.window_for(kind),
                                    kv_dtype=ctx.kv_dtype)
    return _mlp_residual(p, h + y, cfg), cache


# --- decode ------------------------------------------------------------------------

def block_decode(kind: str, p: dict, h1: torch.Tensor, cache: dict, pos: int,
                 ctx: BlockCtx):
    """One token through the block; returns (h1, cache), the cache updated
    in place."""
    _check_kind(kind)
    cfg = ctx.cfg
    x = norm_apply(p["ln1"], h1, cfg)
    y, cache = attn_mod.gqa_decode(p["attn"], x, cache, pos, cfg.attn,
                                   window=ctx.window_for(kind))
    return _mlp_residual(p, h1 + y, cfg), cache
