"""Shared model building blocks: init, norms, rotary embeddings, losses.

Ports the dense-model half of `repro/models/common.py`. Parameters are
nested dicts of tensors keyed like the reference's pytrees.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core.planner import ParamDef


# --- parameter initialization -----------------------------------------------

def init_param(generator: torch.Generator, pd: ParamDef,
               device: torch.device) -> torch.Tensor:
    """Random init drawn from `generator` (which must live on `device`).
    torch's and jax.random's streams differ, so the reference's weights are
    carried over with repro_torch.convert rather than re-drawn."""
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=pd.dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=pd.dtype, device=device)
    fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
    scale = pd.init_scale if pd.init_scale is not None \
        else 1.0 / math.sqrt(fan_in)
    x = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(pd.dtype)


def init_tree(generator: torch.Generator, defs_tree, device) -> Any:
    return tree_lib.tree_map(lambda pd: init_param(generator, pd, device),
                             defs_tree)


def count_params(defs_tree) -> int:
    return int(sum(pd.size for pd in tree_lib.leaves(defs_tree)))


def stack_defs(defs_tree, n: int):
    """Add a leading scan dimension of size n to every ParamDef."""
    return tree_lib.tree_map(
        lambda pd: ParamDef(shape=(n,) + pd.shape, kind=pd.kind,
                            dtype=pd.dtype, init=pd.init,
                            init_scale=pd.init_scale), defs_tree)


# --- norms --------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


# --- rotary position embeddings ------------------------------------------------

def rope_freqs(rotary_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for the rotated prefix of the head dim."""
    exponents = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                             device=device) / rotary_dim
    return 1.0 / (theta ** exponents)          # (rotary_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               rotary_frac: float = 1.0, theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    rotary_frac < 1 rotates only the leading fraction of head_dim."""
    head_dim = x.shape[-1]
    rot = int(head_dim * rotary_frac)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_freqs(rot, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv     # (..., seq, rot/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., seq, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# --- activations / loss ---------------------------------------------------------

def act_fn(name: str):
    return {"silu": F.silu, "gelu": F.gelu,
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) promoted to f32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def causal_mask(q_len: int, kv_len: int, *, q_offset: int = 0,
                window: int | None = None, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask; True == attend. Supports sliding window."""
    q_pos = torch.arange(q_len, device=device) + q_offset
    k_pos = torch.arange(kv_len, device=device)
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m
