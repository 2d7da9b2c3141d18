"""Per-layer block assembly: norm + mixer + MLP with residuals.

Ports the "attn" block kind of `repro/models/blocks.py` (causal
self-attention + dense MLP); the other kinds come with their slices.
"""

from __future__ import annotations

import dataclasses

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
    """Runtime options passed down from the model (the reference's serving
    and parallelism options come with their slices)."""

    cfg: ModelConfig


def block_apply(kind: str, p: dict, h: torch.Tensor,
                ctx: BlockCtx) -> torch.Tensor:
    """Returns the block's output. (The reference also returns an auxiliary
    loss, which only its MoE kind makes.)"""
    _check_kind(kind)
    cfg = ctx.cfg
    x = norm_apply(p["ln1"], h, cfg)
    h = h + attn_mod.gqa_apply(p["attn"], x, cfg.attn)
    x = norm_apply(p["ln2"], h, cfg)
    y = mlp.mlp_apply(p["mlp"], x, act=cfg.mlp_act, gated=cfg.mlp_gated)
    return h + y
