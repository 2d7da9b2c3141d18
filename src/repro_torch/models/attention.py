"""GQA/MHA attention: full-sequence apply, serving caches and decode.

Ports `gqa_defs`, `_split_heads`, `_sdpa`, `_repeat_kv`, `gqa_apply`,
`_kv_quant`, `_kv_dequant`, `gqa_init_cache`, `gqa_prefill_cache` and
`gqa_decode` of `repro/models/attention.py`. `gqa_prefill` takes the place
of `gqa_prefill_cache`: it returns the attention's output with the cache,
built from the K/V the attention computed, where the reference projects
them again.

Which attention `gqa_apply` runs:
  * the flash kernel (`kernels.flashattn.gqa_flash_attention`) when the mask
    is the plain causal/window mask that `gqa_apply` builds itself
    (`mask is None and a.causal`) and autograd is not recording
    (`not torch.is_grad_enabled()`, as in `Model.prefill`). The kernel is
    forward-only, as the reference's is;
  * otherwise `_sdpa`, the reference's plain einsum + softmax, which
    materializes the (S, S) score matrix in f32. Training takes this path,
    so the train step never launches the flash kernel.
Decode attention is plain `_sdpa` arithmetic over the cache, as in the
reference (which runs it outside any Pallas kernel).

The decode step writes the new token's K/V into the cache tensors in place
and returns the same tensors; the reference returns updated copies.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.core import planner as pl
from repro_torch.kernels import flashattn
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


def _attend(p: dict, x: torch.Tensor, a: AttnConfig, *, pos0: int,
            window: int | None, mask: torch.Tensor | None):
    """`gqa_apply`'s attention; also returns the roped K and V it attended
    to, (B, S, KV, hd) each, from which the prefill builds its cache."""
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
    w = window if window is not None else a.window
    if mask is None and a.causal and not torch.is_grad_enabled():
        o = flashattn.gqa_flash_attention(q, k, v, causal=True, window=w)
    else:
        if mask is None and a.causal:
            mask = common.causal_mask(S, S, q_offset=0, window=w,
                                      device=x.device)
        o = _sdpa(q, _repeat_kv(k, H), _repeat_kv(v, H), mask)
    return o.reshape(B, S, H * hd) @ p["wo"], k, v


def gqa_apply(p: dict, x: torch.Tensor, a: AttnConfig, *, pos0: int = 0,
              window: int | None = None,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full causal self-attention over a sequence (training and prefill)."""
    return _attend(p, x, a, pos0=pos0, window=window, mask=mask)[0]


# --- serving caches ------------------------------------------------------------

def _kv_quant(x: torch.Tensor):
    """Per-(position, head) vector int8 quantization of K/V rows: x (..., hd)
    -> (int8 (..., hd), f16 scale (..., 1)). q is computed with the f32
    scale; only the stored scale is f16."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar
    # through its reciprocal, which is not IEEE division
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q = torch.clip(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def gqa_init_cache(batch: int, max_seq: int, a: AttnConfig, dtype, *,
                   window: int | None = None, kv_dtype: str = "native",
                   device=None) -> dict:
    slots = min(max_seq, window) if window else max_seq
    shape = (batch, slots, a.n_kv, a.head_dim)
    if kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, dtype=torch.float16, device=device),
                "v_s": torch.zeros(sshape, dtype=torch.float16, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill(p: dict, x: torch.Tensor, a: AttnConfig, *,
                window: int | None = None, kv_dtype: str = "native"):
    """`gqa_apply` over the whole prompt, and the cache of the K/V it
    attended to (ring-compacted if windowed): returns (y, cache). The
    reference's `gqa_prefill_cache` projects K/V a second time."""
    y, k, v = _attend(p, x, a, pos0=0, window=window, mask=None)
    S = x.shape[1]
    if window and S > window:
        # keep the last `window` positions, position p at ring slot
        # p % window
        k = torch.roll(k[:, -window:], S % window, dims=1)
        v = torch.roll(v[:, -window:], S % window, dims=1)
    if kv_dtype == "int8":
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        return y, {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    return y, {"k": k, "v": v}


def _decode_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """`_sdpa(q, _repeat_kv(k, H), _repeat_kv(v, H), valid)` for one query
    token, without the repeated copy of the cache: q (B, 1, H, hd), k/v
    (B, slots, KV, hd), valid (slots,) bool. Query head h reads KV head
    h // (H / KV), as `_repeat_kv` lays them out."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = torch.where(valid, scores,
                         torch.full((), -1e30, dtype=scores.dtype,
                                    device=scores.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", w, v).reshape(B, 1, H, hd)


def gqa_decode(p: dict, x1: torch.Tensor, cache: dict, pos: int,
               a: AttnConfig, *, window: int | None = None):
    """One-token decode. x1 (B, 1, d); pos (int) is the current length.
    Writes the token's K/V into `cache` in place; returns (y, cache)."""
    B = x1.shape[0]
    H, KV, hd = a.n_heads, a.n_kv, a.head_dim
    slots = cache["k"].shape[1]
    q = _split_heads(x1 @ p["wq"], H, hd)
    k1 = _split_heads(x1 @ p["wk"], KV, hd)
    v1 = _split_heads(x1 @ p["wv"], KV, hd)
    posv = torch.full((1,), pos, device=x1.device)
    q = common.apply_rope(q, posv, rotary_frac=a.rotary_frac,
                          theta=a.rope_theta)
    k1 = common.apply_rope(k1, posv, rotary_frac=a.rotary_frac,
                           theta=a.rope_theta)
    # the reference's dynamic_update_slice clamps the slot into range
    write = pos % slots if window else min(pos, slots - 1)
    if "k_s" in cache:
        k1q, k1s = _kv_quant(k1)
        v1q, v1s = _kv_quant(v1)
        cache["k"][:, write] = k1q[:, 0]
        cache["v"][:, write] = v1q[:, 0]
        cache["k_s"][:, write] = k1s[:, 0]
        cache["v_s"][:, write] = v1s[:, 0]
        k = _kv_dequant(cache["k"], cache["k_s"], x1.dtype)
        v = _kv_dequant(cache["v"], cache["v_s"], x1.dtype)
    else:
        cache["k"][:, write] = k1[:, 0]
        cache["v"][:, write] = v1[:, 0]
        k, v = cache["k"], cache["v"]
    idx = torch.arange(slots, device=x1.device)
    if window and pos >= slots:
        # ring buffer: once full, every slot holds one of the last `slots`
        # positions; before that only slots <= pos are written
        valid = torch.ones_like(idx, dtype=torch.bool)
    else:
        valid = idx <= pos
    o = _decode_sdpa(q, k, v, valid)
    return o.reshape(B, 1, H * hd) @ p["wo"], cache
