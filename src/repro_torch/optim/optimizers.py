"""Optimizers built in-tree: SGD-momentum and AdamW.

Ports `clip_by_global_norm`, `sgd_momentum`, `adamw` and `make_optimizer`
of `repro/optim/optimizers.py` (LARS/LAMB and bf16 `state_dtype` come
later). One interface:

    opt = adamw(lr=..., ...)
    state = opt.init(params)
    opt.update(grads, state, params, step)

`lr` is a float or a schedule step -> lr (repro_torch.optim.schedules).
Where the reference returns new parameter and state trees, `update` writes
them in place under `torch.no_grad()` (it saves one copy of the model and
of both moments) and returns the same trees. The arithmetic is the
reference's, op by op in f32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import tree as tree_lib


class Optimizer(NamedTuple):
    init: Callable
    update: Callable          # (grads, state, params, step) -> (params, state)
    state_bytes_per_param: float


def _lr_at(lr, step: int) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm). Returns
    (clipped tree, global norm)."""
    gn = _global_norm(tree_lib.leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_lib.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def _zeros_like_tree(params):
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def sgd_momentum(lr, momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_tree(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step).to(_device(params))
        for g, mu, p in zip(tree_lib.leaves(grads),
                            tree_lib.leaves(state["mu"]),
                            tree_lib.leaves(params)):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            mu_new = momentum * mu + g
            d = g + momentum * mu_new if nesterov else mu_new
            p.copy_((p.to(torch.float32) - lr_t * d).to(p.dtype))
            mu.copy_(mu_new)
        return params, state

    return Optimizer(init, update, state_bytes_per_param=4)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        dev = _device(params)
        lr_t = _lr_at(lr, step).to(dev)
        t = torch.tensor(step + 1, dtype=torch.float32, device=dev)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        for g, m, v, p in zip(tree_lib.leaves(grads),
                              tree_lib.leaves(state["m"]),
                              tree_lib.leaves(state["v"]),
                              tree_lib.leaves(params)):
            g = g.to(torch.float32)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            upd = upd + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr_t * upd).to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
        return params, state

    return Optimizer(init, update, state_bytes_per_param=8)


def _device(params) -> torch.device:
    return tree_lib.leaves(params)[0].device


OPTIMIZERS = {"sgd": sgd_momentum, "adamw": adamw}


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer {name!r} is not yet ported; ported: "
                         f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](lr, **kw)
