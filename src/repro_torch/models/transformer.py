"""The Model facade: embeddings + block pattern + head; training and
serving entry points.

Ports `repro/models/transformer.py` for the attention family: dense
decoders (attn, mla), the VLM (projected patch embeddings prepended to
the text) and the encoder-decoder (an encoder over frame embeddings, cross
blocks, learned positions); and for the recurrent family: the SSM
(mamba2, ssm blocks only) and the hybrid (recurrentgemma: rglru and local
blocks, scaled embeddings, soft-capped logits, a tail of blocks after the
repeats of the pattern); and for the MoE family (grok-1, arctic: moe
blocks, whose routers' load-balance losses `loss` adds, weighted, to the
cross-entropy; the port returns them where the reference keeps them in
`self._last_aux`). The modality frontends are stubs, as in the
reference: the model takes precomputed patch or frame embeddings. The
parameter tree keeps the reference's paths and shapes, including the
stacked `blocks/p{i}_{kind}/...` and `encoder/blocks/...` leaves with their
leading repeat dimension; the forward loops over that dimension in Python
where the reference scans. With `cfg.remat`, each pattern repeat runs under
`torch.utils.checkpoint` (the reference's `jax.checkpoint` of the scan
body) when autograd records.

Under model parallelism (`forward(..., tp_axis=group, layout=...)`, the
layout from `mp_layout`) the parameters are this rank's shards and every
collective the reference's partitioner would insert is explicit: a
vocab- or column-split embedding, head-sharded or gathered attention (the
encoder's and the cross blocks' too), MLA, the SSM and the RG-LRU split
by head or channel, the experts by expert or ff, feature-sharded MLPs, a
vocab- or row-parallel head and the vocab-parallel cross-entropy. The
image projector, the learned positions and the encoder's input projection
and positions stay replicated ahead of every f operator.

Under FSDP (`forward(..., fsdp=...)`) the parameters are this rank's
shards over the batch axes, gathered just in time: each pattern repeat's
inside its checkpointed body, the head's once a forward and again in the
backward (the graph keeps its shard), the embedding, the encoder's and the
tail's blocks once a forward. With
`moe=` the moe blocks take the expert-parallel dispatch.

The serving cache has the reference's tree, `cache["blocks"]["p0_attn"]["k"]`
with the leading `pattern_repeats` dimension (MLA: `"ckv"`, `"kpe"`; a
cross block: `{"self": {"k", "v"}, "cross": {"k", "v"}}`; ssm: `"state"`
and the conv tails `"conv_x"`, `"conv_B"`, `"conv_C"`; rglru: `"h"`,
`"conv"`). `prefill` and
`decode_step` run under `torch.inference_mode()`; `decode_step` writes
into the cache's tensors in place and returns them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as cl
from repro_torch.core import planner as pl
from repro_torch.models import blocks, common


@dataclasses.dataclass(frozen=True)
class Batch:
    """Model inputs: `tokens` (B, S) integer; labels/mask the same shape.
    img_embeds (B, n_img, d_vision) for VLMs; frame_embeds (B, n_frames,
    d_input) for audio enc-dec."""

    tokens: torch.Tensor
    labels: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    img_embeds: Optional[torch.Tensor] = None
    frame_embeds: Optional[torch.Tensor] = None


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._cache_splits: dict = {}

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
        if cfg.vlm_img_tokens:
            defs["img_proj"] = pl.ParamDef((cfg.vlm_d_vision, d),
                                           pl.K_REPLICATED, cfg.dtype)
        if cfg.learned_positions:
            defs["pos_emb"] = pl.ParamDef((cfg.learned_positions, d),
                                          pl.K_REPLICATED, cfg.dtype,
                                          init="scaled", init_scale=0.02)
        if cfg.encoder is not None:
            enc: dict = {
                "blocks": common.stack_defs(blocks.block_defs("enc", cfg),
                                            cfg.encoder.n_layers),
                "pos": pl.ParamDef((cfg.encoder.n_frames, d), pl.K_REPLICATED,
                                   cfg.dtype, init="scaled", init_scale=0.02),
                "ln_f": blocks.norm_defs(d, cfg),
            }
            if cfg.encoder.d_input != d:
                enc["in_proj"] = pl.ParamDef((cfg.encoder.d_input, d),
                                             pl.K_REPLICATED, cfg.dtype)
            defs["encoder"] = enc
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
        """Paths whose leaves have a leading stacked (repeat) dimension:
        `blocks/...` and the encoder's `encoder/blocks/...`."""
        return "blocks" in path

    # ---------------- forward ----------------

    # the model-sharded dimensions the model-parallel forward runs, by the
    # leaf's parent and name (a name recurs across kinds: moe's w1 is not
    # the mlp's); a leaf not named here runs only replicated
    MP_DIMS = {
        ("embed",): (-2, -1), ("head",): (-1, -2),
        **{(a, n): (-1,) for a in ("attn", "xattn")
           for n in ("wq", "wk", "wv")},
        ("attn", "wo"): (-2,), ("xattn", "wo"): (-2,),
        **{(f, n): (-1,) for f in ("mlp", "dense") for n in ("w1", "w3")},
        ("mlp", "w2"): (-2,), ("dense", "w2"): (-2,),
        ("mla", "w_uq"): (-1,), ("mla", "w_uk"): (-1,),
        ("mla", "w_uv"): (-1,), ("mla", "wo"): (-2,),
        **{("ssm", n): (-1,) for n in ("w_z", "w_x", "w_dt", "A_log", "D",
                                       "dt_bias", "norm")},
        ("ssm", "conv_x"): (-2,), ("ssm", "w_out"): (-2,),
        **{("rec", n): (-1,) for n in ("w_in", "w_gate", "b_a", "b_i",
                                       "lam")},
        ("rec", "conv"): (-2,), ("rec", "w_out"): (-2,),
        # (E, d, ff) at E or ff; (E, ff, d) at E or its ff
        ("moe", "w1"): (-3, -1), ("moe", "w3"): (-3, -1),
        ("moe", "w2"): (-3, -2),
    }
    # sub-trees whose sharded leaves must be all or none: the mixer's
    # channels (or heads) and the MLPs' hidden features are one split
    MP_ALL_OR_NONE = ("mlp", "dense", "ssm", "rec")

    def mp_layout(self, planner: pl.Planner) -> dict:
        """The model-sharded dimension of every parameter under `planner`
        (`Planner.model_dims`), checked against the layouts the
        model-parallel forward runs (`MP_DIMS`); any other raises, naming
        the leaf and its spec. Nothing is replicated in place of a layout
        it cannot run. Every block kind runs under it (an unknown kind
        raises in `blocks.block_defs`); the image projector, the learned
        positions and the encoder's input projection and positions stay
        replicated: they act on replicated activations ahead of every f
        operator, so their gradients arrive whole on every rank."""
        defs = self.param_defs()
        dims = planner.model_dims(defs, stacked_paths=Model.stacked_path)
        specs = planner.tree_specs(defs, stacked_paths=Model.stacked_path)
        for (path, d), spec in zip(tree_lib.leaves_with_paths(dims),
                                   tree_lib.leaves(specs)):
            if d is not None and d not in self.MP_DIMS.get(
                    tuple(path[-2:]), ()):
                raise ValueError(
                    f"model parallelism cannot run {'/'.join(path)} with "
                    f"spec {spec}")

        def check(path: tuple, sub: dict) -> None:
            name, where = path[-1], "/".join(path)
            if name in self.MP_ALL_OR_NONE:
                split = {n: d for n, d in sub.items()
                         if (name, n) in self.MP_DIMS}
                if len({d is None for d in split.values()}) > 1:
                    raise ValueError(
                        f"model parallelism cannot run {where} with some "
                        f"leaves sharded and some not: {split}")
            if name in ("attn", "xattn") and \
                    (sub["wo"] is None) != (sub["wq"] is None):
                raise ValueError(
                    f"model parallelism cannot run {where} with wq and wo "
                    f"sharded differently: {sub}")
            if name == "moe" and (sub["w1"] == -3) != (sub["w2"] == -3):
                raise ValueError(
                    f"model parallelism cannot run {where} with the "
                    f"experts split in one matrix and not another: {sub}")
            for k, v in sub.items():
                if isinstance(v, dict):
                    check(path + (k,), v)

        for k, v in dims.items():
            if isinstance(v, dict):
                check((k,), v)
        return dims

    def _ctx(self, window_override: Optional[int] = None,
             kv_dtype: str = "native", tp_axis=None, enc_out=None,
             kv_chunk: Optional[int] = None,
             moe: Optional[dict] = None) -> blocks.BlockCtx:
        return blocks.BlockCtx(cfg=self.cfg, window_override=window_override,
                               enc_out=enc_out, kv_chunk=kv_chunk,
                               kv_dtype=kv_dtype, tp_axis=tp_axis,
                               **(moe or {}))

    def _embed(self, params: dict, batch: Batch, *, pos0: int = 0,
               group=None, layout: Optional[dict] = None,
               fsdp: Optional[dict] = None) -> torch.Tensor:
        """Token embeddings, with the projected image tokens first (VLM)
        and the learned positions from `pos0` on added."""
        cfg = self.cfg
        table = gather_tree(params["embed"],
                            None if fsdp is None else fsdp["embed"])
        h = common.embed_lookup(table, batch.tokens, group=group,
                                dim=None if layout is None
                                else layout["embed"])
        if cfg.embed_scale:
            h = h * torch.sqrt(torch.tensor(cfg.d_model, dtype=h.dtype,
                                            device=h.device))
        if cfg.vlm_img_tokens and batch.img_embeds is not None:
            img = batch.img_embeds.to(cfg.dtype) @ params["img_proj"]
            h = torch.cat([img, h], dim=1)
        if cfg.learned_positions:
            S = h.shape[1]
            # the reference's dynamic_slice clamps the start into range
            start = max(0, min(pos0, cfg.learned_positions - S))
            h = h + params["pos_emb"][start:start + S][None]
        return h

    def _encode(self, params: dict, batch: Batch,
                fsdp: Optional[dict] = None, *, tp_axis=None,
                layout: Optional[dict] = None) -> Optional[torch.Tensor]:
        """The encoder over the batch's frame embeddings (B, n_frames,
        d_input): bidirectional blocks over learned frame positions, then
        its final norm. None for a model without an encoder. Under FSDP
        each layer's weights are gathered just before it runs; under model
        parallelism (`tp_axis`, `layout`) its blocks run model-parallel
        and the replicated input projection and positions act ahead of
        them."""
        cfg = self.cfg
        if cfg.encoder is None:
            return None
        frame_embeds = batch.frame_embeds
        if frame_embeds is None:
            enc = cfg.encoder
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: its encoder needs frame "
                f"embeddings (Batch.frame_embeds, or frame_embeds= of "
                f"Engine.generate: (batch, {enc.n_frames}, {enc.d_input})), "
                f"and none were given")
        p = params["encoder"]
        h = frame_embeds.to(cfg.dtype)
        if "in_proj" in p:
            h = h @ p["in_proj"]
        h = h + p["pos"][None]
        ctx = self._ctx(tp_axis=tp_axis)
        if layout is not None:
            ctx = dataclasses.replace(ctx,
                                      layout=layout["encoder"]["blocks"])
        fs = None if fsdp is None else fsdp["encoder"]["blocks"]
        for r in range(cfg.encoder.n_layers):
            h, _ = blocks.block_apply(
                "enc", gather_tree(_slice_tree(p["blocks"], r), fs), h, ctx)
        return blocks.norm_apply(p["ln_f"], h, cfg)

    def _run_blocks(self, params: dict, h: torch.Tensor,
                    ctx: blocks.BlockCtx, layout: Optional[dict] = None,
                    fsdp: Optional[dict] = None):
        """The pattern repeats, then the tail: (h, the moe blocks'
        auxiliary losses summed in the reference's order; None without
        moe blocks).

        Under FSDP (`fsdp`: each leaf's (dimension, groups) or None) every
        repeat gathers its slice of the stacked leaves inside the repeat's
        body, so under remat the checkpoint gathers them again in the
        backward and only one repeat's full weights are alive at a time; a
        moe block on the ep dispatch leaves its expert leaves to
        `moe_apply_ep`, which gathers them itself. The tail gathers each
        block's leaves just before it runs."""
        cfg = self.cfg
        aux = None
        if cfg.pattern_repeats > 0:
            keys = [f"p{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
            stacked = [params["blocks"][key] for key in keys]
            ctxs = [_block_ctx(ctx, layout, fsdp, "blocks", key, kind)
                    for key, kind in zip(keys, cfg.block_pattern)]

            def body(hh, aa, r):
                for kind, ps, (c, fs) in zip(cfg.block_pattern, stacked,
                                             ctxs):
                    hh, a = blocks.block_apply(
                        kind, gather_tree(_slice_tree(ps, r), fs), hh, c)
                    aa = _add_aux(aa, a)
                return hh, aa

            for r in range(cfg.pattern_repeats):
                if cfg.remat and torch.is_grad_enabled():
                    h, aux = checkpoint(body, h, aux, r, use_reentrant=False)
                else:
                    h, aux = body(h, aux, r)
        for i, kind in enumerate(cfg.tail_layers):
            key = f"t{i}_{kind}"
            c, fs = _block_ctx(ctx, layout, fsdp, "tail", key, kind)
            h, a = blocks.block_apply(kind, gather_tree(params["tail"][key],
                                                        fs), h, c)
            aux = _add_aux(aux, a)
        return h, aux

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
              layout: Optional[dict] = None,
              fsdp: Optional[dict] = None) -> torch.Tensor:
        """The final norm and the projection to the vocabulary. Under FSDP
        the head's weight is gathered for the projection and not kept for
        the backward, which gathers it again (`_regathered`)."""
        cfg = self.cfg
        h = blocks.norm_apply(params["ln_f"], h, cfg)
        key = "embed" if cfg.tie_embeddings else "head"
        dim = self._head_dim(layout)
        split = None if fsdp is None else fsdp[key]
        w = gather_tree(params[key], split)
        with _regathered(w, params[key], split):
            if cfg.tie_embeddings:
                w = w.T
            if dim == -1:           # this rank's vocabulary columns
                logits = cl.tp_replicate(h, group) @ w
            elif dim == -2:         # row-parallel over the model dimension
                logits = cl.tp_psum(cl.tp_split(h, group) @ w, group)
            else:
                logits = h @ w
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def forward(self, params: dict, batch: Batch, *, tp_axis=None,
                layout: Optional[dict] = None,
                kv_chunk: Optional[int] = None, fsdp: Optional[dict] = None,
                moe: Optional[dict] = None) -> torch.Tensor:
        """Full-sequence logits (training / evaluation). `tp_axis` (a
        process group): blocks whose weights are head/feature shards run
        tensor-parallel over it; replicated blocks ignore it.

        `layout` (with `tp_axis`: model parallelism over that group):
        every parameter's model-sharded dimension (`mp_layout`); `params`
        holds this rank's shards. The embedding, every block and the head
        place their collectives by it, and the logits come back as this
        rank's block of vocabulary columns when the head is split by
        vocabulary (the full logits when it is split by the model
        dimension or not at all).

        `kv_chunk`: the attention runs online-softmax over chunks of that
        many keys (`attention.chunked_sdpa`) where it would materialize
        the scores. A VLM's logits cover the image positions too.

        `fsdp` (FSDP): `params` holds this rank's shards of the leaves the
        planner splits over the batch axes, and this tree (the params'
        structure) gives each leaf's (dimension, process groups) or None;
        the leaves are gathered just in time (`collectives.fsdp_gather`),
        and their gradients come back as this rank's shards, summed over
        the groups. `moe`: the moe blocks' dispatch, `BlockCtx` fields
        (`moe_impl`, `model_group`, `batch_groups`, `wgather_wire`)."""
        return self._forward(params, batch, tp_axis=tp_axis, layout=layout,
                             kv_chunk=kv_chunk, fsdp=fsdp, moe=moe)[0]

    def _forward(self, params: dict, batch: Batch, *, tp_axis=None,
                 layout: Optional[dict] = None,
                 kv_chunk: Optional[int] = None, fsdp: Optional[dict] = None,
                 moe: Optional[dict] = None):
        """(`forward`'s logits, the moe blocks' summed auxiliary loss or
        None)."""
        enc = self._encode(params, batch, fsdp, tp_axis=tp_axis,
                           layout=layout)
        ctx = self._ctx(tp_axis=tp_axis, enc_out=enc, kv_chunk=kv_chunk,
                        moe=moe)
        if enc is not None and layout is not None:
            ctx = dataclasses.replace(ctx,
                                      enc_rep=cl.tp_replicate(enc, tp_axis))
        h = self._embed(params, batch, group=tp_axis, layout=layout,
                        fsdp=fsdp)
        h, aux = self._run_blocks(params, h, ctx, layout, fsdp)
        return self._head(params, h, group=tp_axis, layout=layout,
                          fsdp=fsdp), aux

    def loss(self, params: dict, batch: Batch, *, tp_axis=None,
             layout: Optional[dict] = None,
             kv_chunk: Optional[int] = None, fsdp: Optional[dict] = None,
             moe: Optional[dict] = None) -> torch.Tensor:
        """Next-token cross-entropy over the text positions (a VLM's image
        positions are dropped), plus `router_aux_weight` times the MoE
        blocks' summed load-balance loss."""
        logits, aux = self._forward(params, batch, tp_axis=tp_axis,
                                    layout=layout, kv_chunk=kv_chunk,
                                    fsdp=fsdp, moe=moe)
        if self.cfg.vlm_img_tokens and batch.img_embeds is not None:
            logits = logits[:, batch.img_embeds.shape[1]:]
        labels = batch.labels[:, 1:]
        mask = None if batch.mask is None else batch.mask[:, 1:]
        if self._head_dim(layout) == -1:
            loss = common.vocab_parallel_xent(logits[:, :-1], labels,
                                              tp_axis, mask)
        else:
            loss = common.softmax_xent(logits[:, :-1], labels, mask)
        if aux is not None:
            loss = loss + self.cfg.moe.router_aux_weight * aux
        return loss

    # ---------------- serving ----------------

    def init_cache(self, batch: int, max_seq: int, device=None,
                   **ctx_kw) -> dict:
        """The empty decode cache of `batch` rows (a model-parallel rank's
        shard of it: `serve.engine.cache_spec_tree`)."""
        cfg = self.cfg
        ctx = self._ctx(**ctx_kw)

        def one(kind):
            return blocks.block_init_cache(kind, cfg, batch, max_seq, ctx,
                                           device)

        cache: dict = {}
        if cfg.pattern_repeats > 0:
            cache["blocks"] = {}
            for i, kind in enumerate(cfg.block_pattern):
                cache["blocks"][f"p{i}_{kind}"] = tree_lib.tree_map(
                    lambda t: t[None].repeat((cfg.pattern_repeats,)
                                             + (1,) * t.dim()), one(kind))
        if cfg.tail_layers:
            cache["tail"] = {f"t{i}_{kind}": one(kind)
                             for i, kind in enumerate(cfg.tail_layers)}
        return cache

    def _cache_split(self, kind: str, max_seq: int, ctx: blocks.BlockCtx,
                     tp_axis) -> Optional[dict]:
        """The model-split dimension of each of a block's cache leaves
        (`cache_model_dim`), or None without a model axis."""
        if tp_axis is None:
            return None
        size = dist.get_world_size(tp_axis)
        # the cache's shapes follow from these alone: made once, not at
        # every decode step
        key = (kind, max_seq, size, ctx.window_override, ctx.kv_dtype)
        if key not in self._cache_splits:
            c = blocks.block_init_cache(kind, self.cfg, 1, max_seq, ctx,
                                        "meta")
            self._cache_splits[key] = tree_lib.map_with_path(
                lambda path, t: cache_model_dim(path[-1], t.shape, size), c)
        return self._cache_splits[key]

    def _serve_ctxs(self, ctx: blocks.BlockCtx, max_seq: int, tp_axis,
                    layout, fsdp) -> dict:
        """Per block, by part and key: (its context, carrying its cache
        split, the FSDP splits its weights are gathered by); None without
        a model axis or FSDP (every block takes `ctx` whole)."""
        cfg = self.cfg
        if tp_axis is None and layout is None and fsdp is None:
            return None
        parts = {"blocks": [(f"p{i}_{k}", k)
                            for i, k in enumerate(cfg.block_pattern)]
                 if cfg.pattern_repeats > 0 else [],
                 "tail": [(f"t{i}_{k}", k)
                          for i, k in enumerate(cfg.tail_layers)]}
        out: dict = {}
        for part, items in parts.items():
            for key, kind in items:
                c, fs = _block_ctx(ctx, layout, fsdp, part, key, kind)
                out[(part, key)] = (dataclasses.replace(
                    c, cache_split=self._cache_split(kind, max_seq, ctx,
                                                     tp_axis)), fs)
        return out

    def _last_logits(self, params: dict, h: torch.Tensor, *, tp_axis,
                     layout, fsdp) -> torch.Tensor:
        """The head on the last position: (B, V) logits, whole on every
        rank (a head split by vocabulary has its blocks gathered)."""
        logits = self._head(params, h[:, -1:, :], group=tp_axis,
                            layout=layout, fsdp=fsdp)[:, 0, :]
        if self._head_dim(layout) == -1:
            logits = cl.tp_all_gather(logits, tp_axis)
        return logits

    @torch.inference_mode()
    def prefill(self, params: dict, batch: Batch, max_seq: int, *,
                tp_axis=None, layout: Optional[dict] = None,
                fsdp: Optional[dict] = None, moe: Optional[dict] = None,
                **ctx_kw):
        """Consume the prompt; return (last-token logits, cache, prompt_len).

        The cache is laid out for `decode_step`: windowed blocks get ring
        buffers (compacted only when the prompt is longer than the window),
        full-attention blocks get max_seq slots; a cross block's
        self-attention grows to max_seq and its encoder K/V keep their
        n_frames rows; a recurrent block's state and conv tails keep their
        shapes. The encoder runs once, before the blocks; the
        prompt length counts a VLM's image tokens.

        `tp_axis`, `layout`, `fsdp` and `moe` are `forward`'s: under model
        parallelism `params` holds this rank's shards and `batch` this data
        rank's rows, the blocks run model-parallel, FSDP-split leaves are
        gathered one repeat at a time, and the moe blocks take `moe`'s
        dispatch. Each cache leaf is then this rank's shard under the
        reference's cache layout (`cache_model_dim`), and the logits come
        back whole on every rank.
        """
        cfg = self.cfg
        enc = self._encode(params, batch, fsdp, tp_axis=tp_axis,
                           layout=layout)
        ctx = self._ctx(enc_out=enc, tp_axis=tp_axis, moe=moe, **ctx_kw)
        if enc is not None and layout is not None:
            ctx = dataclasses.replace(ctx,
                                      enc_rep=cl.tp_replicate(enc, tp_axis))
        ctxs = self._serve_ctxs(ctx, max_seq, tp_axis, layout, fsdp)
        h = self._embed(params, batch, group=tp_axis, layout=layout,
                        fsdp=fsdp)
        S = h.shape[1]
        cache: dict = {}

        def grows(kind: str) -> bool:
            """Do the block's prompt-length buffers grow to max_seq slots
            (the reference's pad_cache)? A cross block's self-attention
            always does; a recurrent state never does."""
            if kind == "cross":
                return True
            if kind in ("ssm", "rglru"):
                return False
            w = (ctx.window_override if kind == "mla"
                 else ctx.window_for(kind))
            return not w or w >= max_seq

        def put(bufs: dict, c: dict, split, r: Optional[int],
                grow: bool) -> None:
            for key, t in c.items():
                sp = None if split is None else split[key]
                if isinstance(t, dict):
                    # a cross block's caches: only "self" grows
                    put(bufs.setdefault(key, {}), t, sp, r,
                        grow and key == "self")
                    continue
                n = (max(S, max_seq) if grow and t.dim() >= 2
                     and t.shape[1] == S else t.shape[1])
                lo, hi = 0, n
                if sp == 1 and key in SLOT_LEAVES:   # this rank's slots
                    lo, hi = _own_range(n, tp_axis)
                shape = (t.shape[0], hi - lo) + tuple(t.shape[2:])
                if key not in bufs:
                    lead = () if r is None else (cfg.pattern_repeats,)
                    bufs[key] = t.new_zeros(lead + shape)
                part = t[:, lo:min(hi, t.shape[1])]
                (bufs[key] if r is None else bufs[key][r])[
                    :, :part.shape[1]] = part

        if cfg.pattern_repeats > 0:
            stacked = [params["blocks"][f"p{i}_{k}"]
                       for i, k in enumerate(cfg.block_pattern)]
            cache["blocks"] = {f"p{i}_{k}": {}
                               for i, k in enumerate(cfg.block_pattern)}
            for r in range(cfg.pattern_repeats):
                for i, (kind, ps) in enumerate(zip(cfg.block_pattern,
                                                   stacked)):
                    key = f"p{i}_{kind}"
                    c, fs = ctxs[("blocks", key)] if ctxs else (ctx, None)
                    h, cc = blocks.block_prefill(
                        kind, gather_tree(_slice_tree(ps, r), fs), h, c)
                    put(cache["blocks"][key], cc, c.cache_split, r,
                        grows(kind))
        if cfg.tail_layers:
            cache["tail"] = {}
            for i, kind in enumerate(cfg.tail_layers):
                key = f"t{i}_{kind}"
                c, fs = ctxs[("tail", key)] if ctxs else (ctx, None)
                h, cc = blocks.block_prefill(
                    kind, gather_tree(params["tail"][key], fs), h, c)
                put(cache["tail"].setdefault(key, {}), cc, c.cache_split,
                    None, grows(kind))
        return self._last_logits(params, h, tp_axis=tp_axis, layout=layout,
                                 fsdp=fsdp), cache, S

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: int, *, tp_axis=None, layout: Optional[dict] = None,
                    fsdp: Optional[dict] = None, moe: Optional[dict] = None,
                    max_seq: Optional[int] = None, **ctx_kw):
        """One-token decode. token (B, 1) integer, pos (int) the number of
        tokens already in the cache. Returns (logits (B, V), cache), the
        cache's tensors updated in place.

        `tp_axis`, `layout`, `fsdp` and `moe` as in `prefill`, whose cache
        shards this takes; `max_seq` (the prefill's) is needed with them:
        a shard's length cannot tell a whole ring of slots from a split
        one. The moe blocks route each step's tokens on the gather
        dispatch, as the reference's decode does, with `moe`'s batch
        groups."""
        cfg = self.cfg
        if tp_axis is not None and max_seq is None:
            raise ValueError("decode_step under model parallelism needs the "
                             "prefill's max_seq")
        if moe is not None:
            moe = {**moe, "moe_impl": "gather"}
        ctx = self._ctx(tp_axis=tp_axis, moe=moe, **ctx_kw)
        ctxs = self._serve_ctxs(ctx, max_seq, tp_axis, layout, fsdp)
        pos = int(pos)
        h = self._embed(params, Batch(tokens=token), pos0=pos,
                        group=tp_axis, layout=layout, fsdp=fsdp)
        new_cache: dict = {"blocks": {}, "tail": {}}
        if cfg.pattern_repeats > 0:
            keys = [f"p{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
            for r in range(cfg.pattern_repeats):
                for kind, key in zip(cfg.block_pattern, keys):
                    c, fs = ctxs[("blocks", key)] if ctxs else (ctx, None)
                    h, _ = blocks.block_decode(
                        kind, gather_tree(_slice_tree(params["blocks"][key],
                                                      r), fs), h,
                        _slice_tree(cache["blocks"][key], r), pos, c)
            new_cache["blocks"] = {key: cache["blocks"][key] for key in keys}
        for i, kind in enumerate(cfg.tail_layers):
            key = f"t{i}_{kind}"
            c, fs = ctxs[("tail", key)] if ctxs else (ctx, None)
            h, new_cache["tail"][key] = blocks.block_decode(
                kind, gather_tree(params["tail"][key], fs), h,
                cache["tail"][key], pos, c)
        return self._last_logits(h=h, params=params, tp_axis=tp_axis,
                                 layout=layout, fsdp=fsdp), new_cache


# the cache leaves whose second dimension is the slots (or an encoder's
# frames), which the cache layout may split over the model axis
SLOT_LEAVES = ("k", "v", "k_s", "v_s", "ckv", "kpe")


def cache_model_dim(name: str, shape: tuple, size: int) -> Optional[int]:
    """The dimension of one block's cache leaf `name` (its shape without the
    stacked repeat dimension, batch first) that the reference's cache
    layout splits over a model axis of `size` ranks
    (`repro/launch/dryrun.py:cache_spec_tree`), or None: K/V by KV head
    where the heads divide, else by slot; MLA's latent by slot; the SSM's
    state by head; the conv tails by channel; the RG-LRU's state by
    channel."""
    def div(n):
        return size > 1 and n % size == 0
    if name in ("k", "v", "k_s", "v_s"):        # (B, S, KV, hd|1)
        return 2 if div(shape[2]) else (1 if div(shape[1]) else None)
    if name in ("ckv", "kpe", "state", "h"):    # (B, S, r), (B, H, ..)
        return 1 if div(shape[1]) else None
    if name in ("conv", "conv_x", "conv_B", "conv_C"):   # (B, W-1, C)
        return 2 if div(shape[2]) else None
    return None


def _own_range(n: int, group) -> tuple:
    """This rank's block [lo, hi) of n slots split over `group`."""
    size = dist.get_world_size(group)
    if n % size:
        raise ValueError(f"{n} cache slots do not split over {size} model "
                         f"ranks")
    lo = dist.get_rank(group) * (n // size)
    return lo, lo + n // size


def _block_ctx(ctx: blocks.BlockCtx, layout: Optional[dict],
               fsdp: Optional[dict], part: str, key: str, kind: str):
    """(a block's context, the FSDP splits its body gathers): its layout
    under model parallelism; a moe block on the ep dispatch leaves its
    expert leaves to `moe_apply_ep`."""
    c = ctx
    if layout is not None:
        c = dataclasses.replace(c, layout=layout[part][key])
    fs = None if fsdp is None else fsdp[part][key]
    if fs is not None and kind == "moe" and ctx.moe_impl == "ep":
        fs, c = _ep_experts(fs, c)
    return c, fs


def _add_aux(total, a):
    """The running sum of the blocks' auxiliary losses; None (a block
    without one) adds nothing."""
    if a is None:
        return total
    return a if total is None else total + a


def gather_tree(tree, fsdp):
    """`tree` (a dict of leaves, or one leaf) with every FSDP-split leaf
    gathered: `fsdp` is the matching tree of (dimension, groups) or None
    (None: nothing is split)."""
    if fsdp is None:
        return tree
    if not isinstance(tree, dict):
        return cl.fsdp_gather(tree, fsdp[1], fsdp[0])
    return {k: gather_tree(v, fsdp[k]) for k, v in tree.items()}


@contextlib.contextmanager
def _regathered(w: torch.Tensor, shard: torch.Tensor, split):
    """Inside, the autograd graph keeps this rank's `shard` in place of the
    gathered weight `w` (or a view of it) that an op saves for its
    backward, and the backward gathers it again: FSDP's full weight is
    alive only while it is used. Nothing changes without a `split`."""
    if split is None:
        yield
        return
    ptr = w.untyped_storage().data_ptr()

    def pack(t):
        if t.untyped_storage().data_ptr() == ptr:
            return (t.size(), t.stride(), t.storage_offset())
        return t

    def unpack(saved):
        if not isinstance(saved, tuple):
            return saved
        with torch.no_grad():
            full = gather_tree(shard, split)
        return full.as_strided(*saved)

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


def _ep_experts(fs: dict, ctx: blocks.BlockCtx):
    """A moe block on the ep dispatch: its FSDP splits without the expert
    leaves, and its context with their groups; `moe_apply_ep` gathers them
    on d itself (the planner splits the three alike: on d, (E, d, ff)'s
    second dimension and (E, ff, d)'s last, over the same axes)."""
    split = fs["moe"]["w1"]
    moe_fs = {**fs["moe"], "w1": None, "w2": None, "w3": None}
    return ({**fs, "moe": moe_fs}, dataclasses.replace(
        ctx, fsdp_groups=() if split is None else tuple(split[1])))


def _slice_tree(tree: dict, r: int) -> dict:
    return {k: _slice_tree(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}
