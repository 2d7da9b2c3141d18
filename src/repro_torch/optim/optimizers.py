"""Optimizers built in-tree: SGD-momentum, AdamW, and the layerwise
large-batch optimizers LARS and LAMB.

Ports `repro/optim/optimizers.py`. One interface:

    opt = adamw(lr=..., ...)
    state = opt.init(params)
    opt.update(grads, state, params, step, norm_groups=None)

`lr` is a float or a schedule step -> lr (repro_torch.optim.schedules).
`state_dtype` keeps the moments in another dtype (bf16 for giant models);
they are read into f32, updated there and stored back rounded. Where the
reference returns new parameter and state trees, `update` writes them in
place under `torch.no_grad()` (it saves one copy of the model and of the
moments) and returns the same trees. The arithmetic is the reference's, op
by op in f32.

LARS and LAMB take per-leaf norms for their trust ratios. Under model
parallelism or FSDP a rank holds shards of some leaves, and the
reference's automatic axes take the norms of the whole tensors: `update`'s
`norm_groups` (per leaf, in tree order, a list of process groups: the
leaf's FSDP axes' groups and the model group where the leaf is split over
it; empty: whole) says over which ranks each leaf's sums of squares are
all-reduced. The train step passes them (`trainer.norm_groups`); the other
optimizers ignore them. Without them every norm is the leaf's own, as
under a hybrid plan, whose reference takes the norms of the local shards.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib


class Optimizer(NamedTuple):
    init: Callable
    update: Callable          # (grads, state, params, step, norm_groups=None)
    #                           -> (params, state)
    state_bytes_per_param: float


def _lr_at(lr, step: int) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in leaves))


def clip_by_global_norm(grads, max_norm: float, *,
                        global_norm: torch.Tensor | None = None):
    """Scale every gradient by min(1, max_norm / global norm). Returns
    (clipped tree, global norm). `global_norm` replaces the norm of the
    local leaves where the caller reckons it over more ranks (the hybrid
    step's sharded leaves)."""
    gn = (_global_norm(tree_lib.leaves(grads)) if global_norm is None
          else global_norm)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_lib.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def _zeros_like_tree(params, dtype):
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def sgd_momentum(lr, momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False,
                 state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_tree(params, state_dtype)}

    @torch.no_grad()
    def update(grads, state, params, step, norm_groups=None):
        del norm_groups
        lr_t = _lr_at(lr, step).to(_device(params))
        for g, mu, p in zip(tree_lib.leaves(grads),
                            tree_lib.leaves(state["mu"]),
                            tree_lib.leaves(params)):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            mu_new = momentum * mu.to(torch.float32) + g
            d = g + momentum * mu_new if nesterov else mu_new
            p.copy_((p.to(torch.float32) - lr_t * d).to(p.dtype))
            mu.copy_(mu_new)
        return params, state

    return Optimizer(init, update,
                     state_bytes_per_param=_itemsize(state_dtype))


def _adam_moments(g, m, v, b1, b2):
    g = g.to(torch.float32)
    m_new = b1 * m.to(torch.float32) + (1 - b1) * g
    v_new = b2 * v.to(torch.float32) + (1 - b2) * g * g
    return m_new, v_new


def _adam_update(lr, b1, b2, eps, weight_decay, trust: bool):
    """AdamW's update, and with `trust` LAMB's (the step scaled by the
    layer's trust ratio, whole-tensor norms over `norm_groups`)."""
    @torch.no_grad()
    def update(grads, state, params, step, norm_groups=None):
        dev = _device(params)
        lr_t = _lr_at(lr, step).to(dev)
        t = torch.tensor(step + 1, dtype=torch.float32, device=dev)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        for g, m, v, p, ng in zip(tree_lib.leaves(grads),
                                  tree_lib.leaves(state["m"]),
                                  tree_lib.leaves(state["v"]),
                                  tree_lib.leaves(params),
                                  _norm_groups(params, norm_groups)):
            m_new, v_new = _adam_moments(g, m, v, b1, b2)
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            upd = upd + weight_decay * p.to(torch.float32)
            step_t = lr_t * _trust_ratio(p, upd, group=ng) * upd if trust \
                else lr_t * upd
            p.copy_((p.to(torch.float32) - step_t).to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
        return params, state
    return update


def _adam_init(state_dtype):
    def init(params):
        return {"m": _zeros_like_tree(params, state_dtype),
                "v": _zeros_like_tree(params, state_dtype)}
    return init


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype=torch.float32) -> Optimizer:
    return Optimizer(_adam_init(state_dtype),
                     _adam_update(lr, b1, b2, eps, weight_decay, False),
                     state_bytes_per_param=2 * _itemsize(state_dtype))


def _norm_groups(params, norm_groups) -> list:
    """Per leaf, the groups its norms are summed over (None: its own)."""
    n = len(tree_lib.leaves(params))
    if norm_groups is None:
        return [None] * n
    if len(norm_groups) != n:
        raise ValueError(f"{len(norm_groups)} norm groups for {n} leaves")
    return [list(s) or None for s in norm_groups]


def _trust_ratio(p, upd, eps: float = 1e-9, group=None) -> torch.Tensor:
    """||p|| / (||upd|| + eps) where both norms are positive, else 1. With
    `group` (a list of process groups), p and upd are shards and the norms
    are of the whole tensors: the sums of squares all-reduced over each."""
    if group is None:
        wn = torch.linalg.vector_norm(p.to(torch.float32).reshape(-1))
        un = torch.linalg.vector_norm(upd.reshape(-1))
    else:
        sq = torch.stack([torch.sum(torch.square(p.to(torch.float32))),
                          torch.sum(torch.square(upd))])
        for g in group:
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=g)
        wn, un = torch.sqrt(sq)
    return torch.where((wn > 0) & (un > 0), wn / (un + eps),
                       torch.ones((), dtype=torch.float32, device=wn.device))


def lars(lr, momentum: float = 0.9, weight_decay: float = 1e-4,
         trust_coeff: float = 0.001,
         state_dtype=torch.float32) -> Optimizer:
    """Layerwise Adaptive Rate Scaling (You et al.) for large-batch SGD.
    `update`'s `norm_groups`: whole-tensor norms of split leaves (module
    docstring)."""
    def init(params):
        return {"mu": _zeros_like_tree(params, state_dtype)}

    @torch.no_grad()
    def update(grads, state, params, step, norm_groups=None):
        lr_t = _lr_at(lr, step).to(_device(params))
        for g, mu, p, ng in zip(tree_lib.leaves(grads),
                                tree_lib.leaves(state["mu"]),
                                tree_lib.leaves(params),
                                _norm_groups(params, norm_groups)):
            g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
            local = trust_coeff * _trust_ratio(p, g, group=ng)
            mu_new = momentum * mu.to(torch.float32) + local * lr_t * g
            p.copy_((p.to(torch.float32) - mu_new).to(p.dtype))
            mu.copy_(mu_new)
        return params, state

    return Optimizer(init, update,
                     state_bytes_per_param=_itemsize(state_dtype))


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01,
         state_dtype=torch.float32) -> Optimizer:
    """LAMB (You et al.): layerwise-adaptive AdamW for large-batch
    training. `update`'s `norm_groups`: whole-tensor norms of split leaves
    (module docstring)."""
    return Optimizer(_adam_init(state_dtype),
                     _adam_update(lr, b1, b2, eps, weight_decay, True),
                     state_bytes_per_param=2 * _itemsize(state_dtype))


def _device(params) -> torch.device:
    return tree_lib.leaves(params)[0].device


OPTIMIZERS = {"sgd": sgd_momentum, "adamw": adamw, "lars": lars, "lamb": lamb}

def make_optimizer(name: str, lr, *, state_dtype=torch.float32,
                   **kw) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](lr, state_dtype=state_dtype, **kw)
