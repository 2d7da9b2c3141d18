"""GQA/MHA attention, the training half.

Ports `gqa_defs`, `_split_heads`, `_sdpa`, `_repeat_kv` and `gqa_apply` of
`repro/models/attention.py`. `_sdpa` is the reference's plain einsum +
softmax (the (S, S) score matrix is materialized in f32); the flash kernel
and the serving caches come with the prefill/serving slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.core import planner as pl
from repro_torch.models import common


def gqa_defs(d_model: int, a: AttnConfig, dtype) -> dict:
    H, KV, hd = a.n_heads, a.n_kv, a.head_dim
    return {
        "wq": pl.ParamDef((d_model, H * hd), pl.K_PROJ_IN, dtype),
        "wk": pl.ParamDef((d_model, KV * hd), pl.K_PROJ_IN, dtype),
        "wv": pl.ParamDef((d_model, KV * hd), pl.K_PROJ_IN, dtype),
        "wo": pl.ParamDef((H * hd, d_model), pl.K_PROJ_OUT, dtype),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q (B,Q,H,hd), k/v (B,K,H,hd), mask (Q,K) or (B,Q,K) bool. The
    scores are computed in the input dtype and widened to f32, as the
    reference's einsum does."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if mask is not None:
        mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(mask, scores,
                             torch.full((), -1e30, dtype=scores.dtype,
                                        device=scores.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    if k.shape[-2] == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // k.shape[-2], dim=-2)


def gqa_apply(p: dict, x: torch.Tensor, a: AttnConfig, *, pos0: int = 0,
              window: int | None = None,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full causal self-attention over a sequence (training)."""
    B, S, _ = x.shape
    H, KV, hd = a.n_heads, a.n_kv, a.head_dim
    q = _split_heads(x @ p["wq"], H, hd)
    k = _split_heads(x @ p["wk"], KV, hd)
    v = _split_heads(x @ p["wv"], KV, hd)
    positions = torch.arange(S, device=x.device) + pos0
    q = common.apply_rope(q, positions, rotary_frac=a.rotary_frac,
                          theta=a.rope_theta)
    k = common.apply_rope(k, positions, rotary_frac=a.rotary_frac,
                          theta=a.rope_theta)
    if mask is None and a.causal:
        w = window if window is not None else a.window
        mask = common.causal_mask(S, S, q_offset=0, window=w, device=x.device)
    o = _sdpa(q, _repeat_kv(k, H), _repeat_kv(v, H), mask)
    return o.reshape(B, S, H * hd) @ p["wo"]
