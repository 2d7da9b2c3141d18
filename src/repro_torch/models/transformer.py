"""The Model facade: embeddings + block pattern + head; training and
serving entry points.

Ports `repro/models/transformer.py` for dense decoders. The parameter tree
keeps the reference's paths and shapes, including the stacked
`blocks/p{i}_{kind}/...` leaves with their leading `pattern_repeats`
dimension; the forward loops over that dimension in Python where the
reference scans. With `cfg.remat`, each pattern repeat runs under
`torch.utils.checkpoint` (the reference's `jax.checkpoint` of the scan
body) when autograd records.

Under model parallelism (`forward(..., tp_axis=group, layout=...)`, the
layout from `mp_layout`) the parameters are this rank's shards and every
collective the reference's partitioner would insert is explicit: a
vocab- or column-split embedding, head-sharded or gathered attention,
feature-sharded MLPs, a vocab- or row-parallel head and the vocab-parallel
cross-entropy.

The serving cache has the reference's tree, `cache["blocks"]["p0_attn"]["k"]`
with the leading `pattern_repeats` dimension. `prefill` and `decode_step`
run under `torch.inference_mode()`; `decode_step` writes into the cache's
tensors in place and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as cl
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

    def mp_layout(self, planner: pl.Planner) -> dict:
        """The model-sharded dimension of every parameter under `planner`
        (`Planner.model_dims`), checked against the layouts the
        model-parallel forward runs; any other raises, naming the leaf and
        its spec. Nothing is replicated in place of a layout it cannot
        run."""
        defs = self.param_defs()
        dims = planner.model_dims(defs, stacked_paths=Model.stacked_path)
        specs = planner.tree_specs(defs, stacked_paths=Model.stacked_path)
        allowed = {"embed": (-2, -1), "head": (-1, -2), "wq": (-1,),
                   "wk": (-1,), "wv": (-1,), "w1": (-1,), "w3": (-1,),
                   "wo": (-2,), "w2": (-2,)}
        for (path, d), spec in zip(tree_lib.leaves_with_paths(dims),
                                   tree_lib.leaves(specs)):
            if d is not None and d not in allowed.get(path[-1], ()):
                raise ValueError(
                    f"model parallelism cannot run {'/'.join(path)} with "
                    f"spec {spec}")
        for name, blk in dims.get("blocks", {}).items():
            if len({d is None for d in blk["mlp"].values()}) > 1:
                raise ValueError(
                    f"model parallelism cannot run blocks/{name}/mlp with "
                    f"some matrices sharded and some not: {blk['mlp']}")
            if (blk["attn"]["wo"] is None) != (blk["attn"]["wq"] is None):
                raise ValueError(
                    f"model parallelism cannot run blocks/{name}/attn with "
                    f"wq and wo sharded differently: {blk['attn']}")
        return dims

    def _ctx(self, window_override: Optional[int] = None,
             kv_dtype: str = "native", tp_axis=None) -> blocks.BlockCtx:
        return blocks.BlockCtx(cfg=self.cfg, window_override=window_override,
                               kv_dtype=kv_dtype, tp_axis=tp_axis)

    def _embed(self, params: dict, batch: Batch, *, group=None,
               layout: Optional[dict] = None) -> torch.Tensor:
        h = common.embed_lookup(params["embed"], batch.tokens, group=group,
                                dim=None if layout is None
                                else layout["embed"])
        if self.cfg.embed_scale:
            h = h * torch.sqrt(torch.tensor(self.cfg.d_model, dtype=h.dtype,
                                            device=h.device))
        return h

    def _run_blocks(self, params: dict, h: torch.Tensor,
                    ctx: blocks.BlockCtx,
                    layout: Optional[dict] = None) -> torch.Tensor:
        cfg = self.cfg

        def block_ctx(part: str, key: str) -> blocks.BlockCtx:
            if layout is None:
                return ctx
            return dataclasses.replace(ctx, layout=layout[part][key])

        if cfg.pattern_repeats > 0:
            keys = [f"p{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
            stacked = [params["blocks"][key] for key in keys]
            ctxs = [block_ctx("blocks", key) for key in keys]

            def body(hh, r):
                for kind, ps, c in zip(cfg.block_pattern, stacked, ctxs):
                    pslice = _slice_tree(ps, r)
                    hh = blocks.block_apply(kind, pslice, hh, c)
                return hh

            for r in range(cfg.pattern_repeats):
                if cfg.remat and torch.is_grad_enabled():
                    h = checkpoint(body, h, r, use_reentrant=False)
                else:
                    h = body(h, r)
        for i, kind in enumerate(cfg.tail_layers):
            key = f"t{i}_{kind}"
            h = blocks.block_apply(kind, params["tail"][key], h,
                                   block_ctx("tail", key))
        return h

    def _head_dim(self, layout: Optional[dict]) -> Optional[int]:
        """The (d, vocab) head's model-sharded dimension: -1 by vocabulary,
        -2 by the model dimension (a tied head is the embedding's
        transpose)."""
        if layout is None:
            return None
        if not self.cfg.tie_embeddings:
            return layout["head"]
        return {-2: -1, -1: -2, None: None}[layout["embed"]]

    def _head(self, params: dict, h: torch.Tensor, *, group=None,
              layout: Optional[dict] = None) -> torch.Tensor:
        cfg = self.cfg
        h = blocks.norm_apply(params["ln_f"], h, cfg)
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        dim = self._head_dim(layout)
        if dim == -1:               # this rank's vocabulary columns
            logits = cl.tp_replicate(h, group) @ w
        elif dim == -2:             # row-parallel over the model dimension
            logits = cl.tp_psum(cl.tp_split(h, group) @ w, group)
        else:
            logits = h @ w
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def forward(self, params: dict, batch: Batch, *, tp_axis=None,
                layout: Optional[dict] = None) -> torch.Tensor:
        """Full-sequence logits (training / evaluation). `tp_axis` (a
        process group): blocks whose weights are head/feature shards run
        tensor-parallel over it; replicated blocks ignore it.

        `layout` (with `tp_axis`: model parallelism over that group):
        every parameter's model-sharded dimension (`mp_layout`); `params`
        holds this rank's shards. The embedding, every block and the head
        place their collectives by it, and the logits come back as this
        rank's block of vocabulary columns when the head is split by
        vocabulary (the full logits when it is split by the model
        dimension or not at all)."""
        ctx = self._ctx(tp_axis=tp_axis)
        h = self._embed(params, batch, group=tp_axis, layout=layout)
        h = self._run_blocks(params, h, ctx, layout)
        return self._head(params, h, group=tp_axis, layout=layout)

    def loss(self, params: dict, batch: Batch, *, tp_axis=None,
             layout: Optional[dict] = None) -> torch.Tensor:
        logits = self.forward(params, batch, tp_axis=tp_axis, layout=layout)
        labels = batch.labels[:, 1:]
        mask = None if batch.mask is None else batch.mask[:, 1:]
        if self._head_dim(layout) == -1:
            return common.vocab_parallel_xent(logits[:, :-1], labels,
                                              tp_axis, mask)
        return common.softmax_xent(logits[:, :-1], labels, mask)

    # ---------------- serving ----------------

    def init_cache(self, batch: int, max_seq: int, device=None,
                   **ctx_kw) -> dict:
        cfg = self.cfg
        ctx = self._ctx(**ctx_kw)
        cache: dict = {}
        if cfg.pattern_repeats > 0:
            cache["blocks"] = {}
            for i, kind in enumerate(cfg.block_pattern):
                one = blocks.block_init_cache(kind, cfg, batch, max_seq, ctx,
                                              device)
                cache["blocks"][f"p{i}_{kind}"] = {
                    k: t[None].repeat((cfg.pattern_repeats,) + (1,) * t.dim())
                    for k, t in one.items()}
        if cfg.tail_layers:
            cache["tail"] = {
                f"t{i}_{kind}": blocks.block_init_cache(kind, cfg, batch,
                                                        max_seq, ctx, device)
                for i, kind in enumerate(cfg.tail_layers)
            }
        return cache

    @torch.inference_mode()
    def prefill(self, params: dict, batch: Batch, max_seq: int, **ctx_kw):
        """Consume the prompt; return (last-token logits, cache, prompt_len).

        The cache is laid out for `decode_step`: windowed blocks get ring
        buffers (compacted only when the prompt is longer than the window),
        full-attention blocks get max_seq slots.
        """
        cfg = self.cfg
        ctx = self._ctx(**ctx_kw)
        h = self._embed(params, batch)
        S = h.shape[1]
        cache: dict = {}

        def slots(kind: str, t: torch.Tensor) -> int:
            """Grow prompt-length K/V buffers to max_seq slots (the
            reference's pad_cache)."""
            w = ctx.window_for(kind)
            if (not w or w >= max_seq) and t.dim() >= 2 and t.shape[1] == S:
                return max(S, max_seq)
            return t.shape[1]

        def put(bufs: dict, kind: str, c: dict, r: Optional[int]) -> None:
            for key, t in c.items():
                shape = (t.shape[0], slots(kind, t)) + tuple(t.shape[2:])
                if key not in bufs:
                    lead = () if r is None else (cfg.pattern_repeats,)
                    bufs[key] = t.new_zeros(lead + shape)
                (bufs[key] if r is None else bufs[key][r])[:, :t.shape[1]] = t

        if cfg.pattern_repeats > 0:
            stacked = [params["blocks"][f"p{i}_{k}"]
                       for i, k in enumerate(cfg.block_pattern)]
            cache["blocks"] = {f"p{i}_{k}": {}
                               for i, k in enumerate(cfg.block_pattern)}
            for r in range(cfg.pattern_repeats):
                for i, (kind, ps) in enumerate(zip(cfg.block_pattern,
                                                   stacked)):
                    h, c = blocks.block_prefill(kind, _slice_tree(ps, r), h,
                                                ctx)
                    put(cache["blocks"][f"p{i}_{kind}"], kind, c, r)
        if cfg.tail_layers:
            cache["tail"] = {}
            for i, kind in enumerate(cfg.tail_layers):
                h, c = blocks.block_prefill(
                    kind, params["tail"][f"t{i}_{kind}"], h, ctx)
                put(cache["tail"].setdefault(f"t{i}_{kind}", {}), kind, c,
                    None)
        logits = self._head(params, h[:, -1:, :])
        return logits[:, 0, :], cache, S

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: int, **ctx_kw):
        """One-token decode. token (B, 1) integer, pos (int) the number of
        tokens already in the cache. Returns (logits (B, V), cache), the
        cache's tensors updated in place."""
        cfg = self.cfg
        ctx = self._ctx(**ctx_kw)
        pos = int(pos)
        h = self._embed(params, Batch(tokens=token))
        new_cache: dict = {"blocks": {}, "tail": {}}
        if cfg.pattern_repeats > 0:
            keys = [f"p{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
            for r in range(cfg.pattern_repeats):
                for kind, key in zip(cfg.block_pattern, keys):
                    h, _ = blocks.block_decode(
                        kind, _slice_tree(params["blocks"][key], r), h,
                        _slice_tree(cache["blocks"][key], r), pos, ctx)
            new_cache["blocks"] = {key: cache["blocks"][key] for key in keys}
        for i, kind in enumerate(cfg.tail_layers):
            key = f"t{i}_{kind}"
            h, new_cache["tail"][key] = blocks.block_decode(
                kind, params["tail"][key], h, cache["tail"][key], pos, ctx)
        logits = self._head(params, h)
        return logits[:, 0, :], new_cache


def _slice_tree(tree: dict, r: int) -> dict:
    return {k: _slice_tree(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}
