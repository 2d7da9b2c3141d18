"""Plain PyTorch pieces the model references share: the parameter layout
and its initial values, products (in float32, or in float8 for the
lower-precision control), norms, rotary embeddings and the loss.

Nothing here imports the program. A family's reference module
(`reference/<arch_type>.py`) gives `layout(cfg)` and `loss(params, tokens,
cfg, mm)`; `train.py` drives them.
"""

from __future__ import annotations

import math

import torch

def spec(shape, dtype: str = "bfloat16", init: str = "normal",
         scale: float | None = None) -> dict:
    """One leaf of a layout: its shape, its stored dtype and how its
    initial value is drawn ("normal": standard normal times `scale`, by
    default 1/sqrt(fan in); "ones"; "zeros")."""
    shape = tuple(int(n) for n in shape)
    if init == "normal" and scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(fan_in)
    return {"shape": shape, "dtype": dtype, "init": init, "scale": scale}


def stacked(n: int, leaf: dict) -> dict:
    """`leaf` with a leading dimension of n layers (whose slices the
    comparison reads one by one)."""
    return {**leaf, "shape": (n,) + tuple(leaf["shape"]), "stacked": True}


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 format under one scale for the whole tensor
    (its largest magnitude onto the format's largest), back in float32."""
    top = torch.finfo(dtype).max
    s = x.abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    """The float8 training recipe's product: both operands in e4m3 going
    forward; going back, the incoming gradient in e5m2 times the saved
    e4m3 operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) \
            @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product (a (..., k) times b (k, n))."""
    return _Fp8Matmul.apply(a, b)


MATMULS = {"f32": f32_matmul, "fp8": fp8_matmul}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions 0 .. S-1: each
    head's first and second halves rotated as pairs (the llama layout)."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Mean cross-entropy of each position's logits against the next
    token."""
    lg = logits[:, :-1].reshape(-1, logits.shape[-1])
    return torch.nn.functional.cross_entropy(lg, tokens[:, 1:].reshape(-1)
                                             .long())
