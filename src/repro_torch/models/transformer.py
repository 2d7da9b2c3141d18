"""The Model facade: embeddings + block pattern + head, training entry points.

Ports the training half of `repro/models/transformer.py` for dense decoders.
The parameter tree keeps the reference's paths and shapes, including the
stacked `blocks/p{i}_{kind}/...` leaves with their leading
`pattern_repeats` dimension; the forward loops over that dimension in
Python where the reference scans. With `cfg.remat`, each pattern repeat runs
under `torch.utils.checkpoint` (the reference's `jax.checkpoint` of the scan
body).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner as pl
from repro_torch.models import blocks, common


@dataclasses.dataclass(frozen=True)
class Batch:
    """Model inputs: `tokens` (B, S) integer; labels/mask the same shape."""

    tokens: torch.Tensor
    labels: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---------------- parameter definitions ----------------

    def param_defs(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        defs: dict = {
            "embed": pl.ParamDef((cfg.vocab, d), pl.K_EMBED, cfg.dtype,
                                 init="scaled", init_scale=0.02),
            "ln_f": blocks.norm_defs(d, cfg),
        }
        if not cfg.tie_embeddings:
            defs["head"] = pl.ParamDef((d, cfg.vocab), pl.K_HEAD, cfg.dtype)
        reps = cfg.pattern_repeats
        if reps > 0:
            defs["blocks"] = {
                f"p{i}_{kind}": common.stack_defs(blocks.block_defs(kind, cfg),
                                                  reps)
                for i, kind in enumerate(cfg.block_pattern)
            }
        if cfg.tail_layers:
            defs["tail"] = {
                f"t{i}_{kind}": blocks.block_defs(kind, cfg)
                for i, kind in enumerate(cfg.tail_layers)
            }
        return defs

    def init(self, generator: torch.Generator, device) -> dict:
        """Random parameters drawn from `generator` (on `device`)."""
        return common.init_tree(generator, self.param_defs(), device)

    def n_params(self) -> int:
        return common.count_params(self.param_defs())

    @staticmethod
    def stacked_path(path: tuple) -> bool:
        """Paths whose leaves have a leading stacked (repeat) dimension."""
        return "blocks" in path

    # ---------------- forward ----------------

    def _embed(self, params: dict, batch: Batch) -> torch.Tensor:
        h = params["embed"][batch.tokens.long()]
        if self.cfg.embed_scale:
            h = h * torch.sqrt(torch.tensor(self.cfg.d_model, dtype=h.dtype,
                                            device=h.device))
        return h

    def _run_blocks(self, params: dict, h: torch.Tensor,
                    ctx: blocks.BlockCtx) -> torch.Tensor:
        cfg = self.cfg
        if cfg.pattern_repeats > 0:
            stacked = [params["blocks"][f"p{i}_{k}"]
                       for i, k in enumerate(cfg.block_pattern)]

            def body(hh, r):
                for kind, ps in zip(cfg.block_pattern, stacked):
                    pslice = _slice_tree(ps, r)
                    hh = blocks.block_apply(kind, pslice, hh, ctx)
                return hh

            for r in range(cfg.pattern_repeats):
                if cfg.remat and torch.is_grad_enabled():
                    h = checkpoint(body, h, r, use_reentrant=False)
                else:
                    h = body(h, r)
        for i, kind in enumerate(cfg.tail_layers):
            h = blocks.block_apply(kind, params["tail"][f"t{i}_{kind}"], h,
                                   ctx)
        return h

    def _head(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = blocks.norm_apply(params["ln_f"], h, cfg)
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = h @ w
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def forward(self, params: dict, batch: Batch) -> torch.Tensor:
        """Full-sequence logits (training / evaluation)."""
        ctx = blocks.BlockCtx(cfg=self.cfg)
        h = self._embed(params, batch)
        h = self._run_blocks(params, h, ctx)
        return self._head(params, h)

    def loss(self, params: dict, batch: Batch) -> torch.Tensor:
        logits = self.forward(params, batch)
        return common.softmax_xent(
            logits[:, :-1], batch.labels[:, 1:],
            None if batch.mask is None else batch.mask[:, 1:])


def _slice_tree(tree: dict, r: int) -> dict:
    return {k: _slice_tree(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}
