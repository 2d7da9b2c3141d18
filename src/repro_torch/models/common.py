"""Shared model building blocks: init, norms, rotary embeddings, losses.

Ports `repro/models/common.py` but for its JAX-only helper
`abstract_tree`. Parameters are nested dicts of tensors keyed like the
reference's pytrees. Under model parallelism the embedding lookup and the cross-entropy also run on this
rank's shard of the table or of the logits (`embed_lookup`,
`vocab_parallel_xent`), with their collectives explicit where the
reference's partitioner inserts them.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core import collectives as cl
from repro_torch.core.planner import ParamDef


# --- parameter initialization -----------------------------------------------

# a leaf whose f32 draw passes INIT_ONE_DRAW_BYTES is drawn in groups of
# its trailing matrices, INIT_CHUNK_BYTES of f32 a group. Only the MoE
# archs' stacked expert leaves pass it (arctic-480b's at 2 layers is 8.9 G
# elements: 36 GB as one f32 draw); every other arch's largest leaf
# (llava-next-mistral-7b's stacked MLP, 7 GiB of f32) is drawn at once.
INIT_ONE_DRAW_BYTES = 16 * 2 ** 30
INIT_CHUNK_BYTES = 2 ** 30


def init_param(generator: torch.Generator, pd: ParamDef,
               device: torch.device) -> torch.Tensor:
    """Random init drawn from `generator` (which must live on `device`).
    torch's and jax.random's streams differ, so the reference's weights are
    carried over with repro_torch.convert rather than re-drawn. A leaf
    whose f32 draw would pass INIT_ONE_DRAW_BYTES is drawn in groups of
    its trailing matrices, so that only one group's f32 copy is alive."""
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=pd.dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=pd.dtype, device=device)
    fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
    scale = pd.init_scale if pd.init_scale is not None \
        else 1.0 / math.sqrt(fan_in)

    def draw(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(pd.dtype)

    if len(pd.shape) <= 2 or 4 * math.prod(pd.shape) <= INIT_ONE_DRAW_BYTES:
        return draw(pd.shape)
    out = torch.empty(pd.shape, dtype=pd.dtype, device=device)
    mats = out.view(-1, *pd.shape[-2:])
    step = max(1, INIT_CHUNK_BYTES // (4 * math.prod(pd.shape[-2:])))
    for i in range(0, mats.shape[0], step):
        part = mats[i:i + step]
        part.copy_(draw(part.shape))
    return out


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

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            group=None):
    """RMS norm over the last dimension in f32. With `group`, x and scale
    are this rank's slices of a dimension split over the model group: the
    mean square is the mean of the ranks' means, all-reduced over it (a
    replicated value feeding every rank's slice, so its backward
    all-reduces too: g, then f)."""
    dt = x.dtype
    x = x.to(torch.float32)
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    if group is not None:        # the mean of the ranks' equal slices' means
        ms = cl.tp_replicate(cl.tp_psum(ms, group), group) \
            / dist.get_world_size(group)
    x = x * torch.rsqrt(ms + eps)
    return (x * scale.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in f32 with a scale and a bias, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


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


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) f32 sinusoidal position table: sin in the even columns, cos in
    the odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# --- activations / loss ---------------------------------------------------------

def act_fn(name: str):
    """The reference's activations. Its "gelu" is `jax.nn.gelu`, whose
    default is the tanh approximation, so "gelu" and "gelu_tanh" are the
    same function."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) promoted to f32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _nll_mean(logz - gold, mask)


def _nll_mean(nll: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _owned(ids: torch.Tensor, n: int, group):
    """(ids local to this rank's block of n rows, whether it owns each)."""
    local = ids.long() - dist.get_rank(group) * n
    own = (local >= 0) & (local < n)
    return torch.where(own, local, torch.zeros_like(local)), own


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor, group,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """`softmax_xent` of logits whose vocabulary is split over `group` in
    rank order: `logits` (..., V / p) is this rank's block of columns. The
    running max is MAX-reduced over the group (no gradient: the shift
    cancels), the sum of exponentials and the gold logit (taken on the rank
    that owns the label, zero elsewhere) are summed over it with `tp_psum`,
    so the loss is the same on every rank and the backward gives each rank
    only its own columns."""
    logits = logits.to(torch.float32)
    m = cl.tp_max(torch.amax(logits, dim=-1), group)
    sumexp = cl.tp_psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                        group)
    logz = torch.log(sumexp) + m
    local, own = _owned(labels, logits.shape[-1], group)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    gold = cl.tp_psum(torch.where(own, gold, torch.zeros_like(gold)), group)
    return _nll_mean(logz - gold, mask)


def own_part(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of `t` along `dim`, split evenly over `group` in
    rank order (a cache leaf's shard under the cache layout)."""
    n = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *, group=None,
                 dim: int | None = None) -> torch.Tensor:
    """`table[ids]`. With `group`, `table` is this rank's shard of the
    (vocab, d) embedding split along `dim`: -2 by vocabulary (ids this rank
    does not own look up zeros, so their rows get no gradient, and the
    ranks' partial lookups are summed with `tp_psum`), -1 by the model
    dimension (the local columns, then `tp_all_gather`)."""
    if group is None or dim is None:
        return table[ids.long()]
    if dim == -2:
        local, own = _owned(ids, table.shape[0], group)
        h = table[local]
        return cl.tp_psum(torch.where(own[..., None], h, torch.zeros_like(h)),
                          group)
    if dim == -1:
        return cl.tp_all_gather(table[ids.long()], group)
    raise ValueError(f"an embedding split along dimension {dim}")


def causal_mask(q_len: int, kv_len: int, *, q_offset: int = 0,
                window: int | None = None, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask; True == attend. Supports sliding window."""
    q_pos = torch.arange(q_len, device=device) + q_offset
    k_pos = torch.arange(kv_len, device=device)
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m
