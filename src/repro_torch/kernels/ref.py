"""Plain PyTorch versions of the kernels.

They are the CPU path of `repro_torch.kernels.quant8` and
`repro_torch.kernels.flashattn`, and the yardstick their CUDA kernels are
held to on the card. The quantization versions repeat the kernel's
arithmetic op by op (IEEE division, round half to even, the product rounded
before the add), so a kernel built without FMA contraction matches them bit
for bit; `flash_attention` materializes the masked score matrix, and the
kernel is held to it within a tolerance. Signatures mirror the wrappers'.
"""

from __future__ import annotations

import math

import torch


def quantize_blocks(x2d: torch.Tensor):
    """(n_blocks, block) float -> (int8 q, f32 scale per row)."""
    x = x2d.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=1)
    # divide by a tensor, not a Python scalar: on CUDA, PyTorch divides by a
    # scalar through its reciprocal, which is not IEEE division
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clip(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(q2d: torch.Tensor, scales: torch.Tensor, *,
                      out_dtype=torch.float32) -> torch.Tensor:
    return (q2d.to(torch.float32)
            * scales.to(torch.float32)[:, None]).to(out_dtype)


def dequantize_accumulate_blocks(q2d: torch.Tensor, scales: torch.Tensor,
                                 acc: torch.Tensor, *,
                                 out_dtype=torch.float32) -> torch.Tensor:
    deq = q2d.to(torch.float32) * scales.to(torch.float32)[:, None]
    return (acc.to(torch.float32) + deq).to(out_dtype)


def quantize_ef_blocks(x2d: torch.Tensor, res2d: torch.Tensor):
    """Error-feedback quantize: y = f32(x) + r; (q, s) = quantize(y);
    new residual y + q * (-s), which is bitwise y - q * s."""
    y = x2d.to(torch.float32) + res2d.to(torch.float32)
    q, scale = quantize_blocks(y)
    new_residual = dequantize_accumulate_blocks(q, -scale, y)
    return q, scale, new_residual


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Plain masked softmax attention in f32, cast to q's dtype.

    q (B, H, Sq, D), k/v (B, H, Sk, D); key j is visible to query i when
    j <= i (causal) and j > i - window (windowed), positions from 0."""
    D = q.shape[-1]
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    s = torch.where(valid, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w,
                        v.to(torch.float32)).to(q.dtype)
