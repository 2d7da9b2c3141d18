"""Attention mixers: GQA/MHA (full, sliding-window, bidirectional and
cross) and multi-head latent attention (MLA).

Ports `repro/models/attention.py`: `gqa_defs`, `_split_heads`, `_sdpa`,
`_repeat_kv`, `chunked_sdpa`, `gqa_apply` (with `kv_chunk`; the
reference's `kv_override` is `gqa_cross`), `gqa_cross_kv`, `_kv_quant`,
`_kv_dequant`, `gqa_init_cache`, `gqa_decode`, `gqa_decode_cross` and the
MLA functions. `gqa_prefill` and `mla_prefill`
take the place of the `*_prefill_cache` functions: each returns the
attention's output with the cache, built from the K/V (MLA: the latent
`ckv` and `kpe`) the attention computed, where the reference projects
them again.

Under model parallelism `gqa_apply` takes the layout of its projections
(`Planner.model_dims`): whole heads per rank run sharded, as under a hybrid
plan; a shard holding part of a head (the smoke yi-6b's 4 heads of 32 over
8 ranks, chatglm3-6b's 2 KV heads over 4, recurrentgemma's one KV head)
runs `gqa_gathered`, which makes K and V whole on every rank and splits
the queries (`mp_path`): a rank attends its own query heads where they
divide by the group size, else its own block of query rows where the
flash kernel does not run (the sequence padded to a multiple of the group
size), else (the flash prefill) every head. The cross-attention
(`gqa_cross_kv`, `gqa_cross`) and MLA (`mla_apply`: its latents through
the f operator; by query rows where its heads do not split) follow the
same cases.

Which attention the GQA functions run (`_attention`):
  * the flash kernel (`kernels.flashattn.gqa_flash_attention`) when no
    mask is given (the causal/window mask the function would build
    itself, or none: the encoder's bidirectional attention and the
    cross-attention, which launch it with `causal=False`) and autograd is
    not recording (`not torch.is_grad_enabled()`, as in `Model.prefill`).
    The kernel is forward-only, as the reference's is;
  * otherwise `chunked_sdpa` with `kv_chunk`, or `_sdpa`, the reference's
    plain einsum + softmax, which materializes the score matrix in f32.
    Training takes these paths, so the train step never launches the
    flash kernel.
MLA's attention is the reference's explicit einsum + softmax (or
`chunked_sdpa` with `kv_chunk`): its query/key head dim differs from its
value head dim, which the flash kernel does not take. Decode attention is
plain arithmetic over the cache, as in the reference (which runs it outside
any Pallas kernel); MLA decodes on the latent cache with the absorbed
projections.

The decode step writes the new token's K/V into the cache tensors in place
and returns the same tensors; the reference returns updated copies.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import AttnConfig, MLAConfig
from repro_torch.core import collectives as cl
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


def _project(p: dict, x: torch.Tensor) -> tuple:
    return x @ p["wq"], x @ p["wk"], x @ p["wv"]


def chunked_sdpa(q, k, v, *, causal: bool = True, window: int | None = None,
                 q_offset: int = 0, kv_chunk: int = 1024,
                 scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks of `kv_chunk` keys, so the
    (Sq, Sk) score matrix never materializes: the reference's
    `chunked_sdpa`, with its rounding (the probabilities and the
    accumulator in q's dtype, the running max and denominator in f32).

    q (B, Sq, H, D); k (B, Sk, H, D) and v (B, Sk, H, Dv) with the heads
    already repeated; query row i sits at key position i + q_offset. Plain
    PyTorch, as the reference's is jnp."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    c = min(kv_chunk, Sk)
    pad = (-Sk) % c
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad) + k.shape[2:])], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], dim=1)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    neg = torch.full((), -1e30, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    for j in range(k.shape[1] // c):
        kj, vj = k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
        k_pos = j * c + torch.arange(c, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kj).to(torch.float32) * scale
        valid = (k_pos[None, :] <= Sk - 1).expand(Sq, c)
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vj)
        acc = acc * corr.transpose(1, 2)[..., None].to(acc.dtype) + pv
        m = m_new
    denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (acc.to(torch.float32) / denom).to(q.dtype)


def _flash_runs(mask: torch.Tensor | None) -> bool:
    """Does `_attention` run the flash kernel (no mask, autograd off)?"""
    return mask is None and not torch.is_grad_enabled()


def _attention(q, k, v, *, causal: bool, window: int | None,
               mask: torch.Tensor | None, q_offset: int = 0,
               kv_chunk: int | None = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd): the flash
    kernel when there is no mask and autograd is not recording, else
    `chunked_sdpa` with `kv_chunk`, else `_sdpa` (with the causal/window
    mask built here when `causal` and no mask is given). `q_offset`: the
    position of q's first row among the keys' (a rank's own query rows;
    the flash kernel never takes one). A bidirectional attention
    (`causal=False`) ignores `window` but in `chunked_sdpa`, as the
    reference's does."""
    H = q.shape[2]
    if _flash_runs(mask):
        return flashattn.gqa_flash_attention(
            q, k, v, causal=causal, window=window if causal else None)
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    if mask is None and kv_chunk is not None:
        return chunked_sdpa(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_chunk=kv_chunk)
    if mask is None and causal:
        mask = common.causal_mask(q.shape[1], k.shape[1], q_offset=q_offset,
                                  window=window, device=q.device)
    return _sdpa(q, k, v, mask)


def _own_kv(t: torch.Tensor, n_heads: int, h0: int, hl: int) -> torch.Tensor:
    """The KV heads of t (B, S, KV, hd) that query heads h0 .. h0 + hl - 1
    of `n_heads` read (head h reads KV head h // (n_heads / KV)), laid out
    for those hl heads as `_attention` takes them: a block of whole groups
    when the heads' range starts and ends on group boundaries, the one KV
    head when it lies inside one group, else one KV head per query head
    (3 heads a rank on groups of 2 start mid-group)."""
    g = n_heads // t.shape[2]
    if h0 % g == 0 and hl % g == 0:
        return t.narrow(2, h0 // g, hl // g)
    if h0 // g == (h0 + hl - 1) // g:
        return t.narrow(2, h0 // g, 1)
    return t.index_select(2, torch.arange(h0, h0 + hl, device=t.device) // g)


def _attend(q, k, v, a: AttnConfig, *, pos0: int, window: int | None,
            mask: torch.Tensor | None, kv_chunk: int | None = None,
            q_row0: int = 0, q_head0: int | None = None):
    """`gqa_apply`'s self-attention over the projections q (B, Sq, Hq *
    hd) and k, v (B, S, KV * hd), the head counts read from their widths.
    Returns the attention output (B, Sq, Hq * hd), before the
    out-projection, and the roped K and V, (B, S, KV, hd) each, from which
    the prefill builds its cache.

    q may hold only some of the queries (model parallelism): `q_row0`, the
    first of the Sq query rows among the S positions (its own rows: roped
    at their absolute positions, masked from there; rows past the last
    position are padding), or `q_head0`, the first of its Hq heads among
    `a.n_heads` (its own heads, attending over the KV heads they read,
    `_own_kv`)."""
    B, Sq, _ = q.shape
    hd = a.head_dim
    H = q.shape[-1] // hd
    q, k, v = (_split_heads(t, t.shape[-1] // hd, hd) for t in (q, k, v))
    q_pos = torch.arange(Sq, device=q.device) + pos0 + q_row0
    k_pos = torch.arange(k.shape[1], device=k.device) + pos0
    q = common.apply_rope(q, q_pos, rotary_frac=a.rotary_frac,
                          theta=a.rope_theta)
    k = common.apply_rope(k, k_pos, rotary_frac=a.rotary_frac,
                          theta=a.rope_theta)
    ka, va = (k, v) if q_head0 is None else \
        (_own_kv(t, a.n_heads, q_head0, H) for t in (k, v))
    if mask is not None:
        mask = mask[..., q_row0:q_row0 + Sq, :]
        if mask.shape[-2] < Sq:     # padded rows (`_own_rows`) see every key
            mask = torch.cat([mask, mask.new_ones(
                mask.shape[:-2] + (Sq - mask.shape[-2], mask.shape[-1]))],
                dim=-2)
    o = _attention(q, ka, va, causal=a.causal,
                   window=window if window is not None else a.window,
                   mask=mask, q_offset=q_row0, kv_chunk=kv_chunk)
    return o.reshape(B, Sq, H * hd), k, v


# the layout of a head-sharded attention: each projection split by output
# column, the out-projection by input row
HEAD_SHARDED = {"wq": -1, "wk": -1, "wv": -1, "wo": -2}


def head_aligned(layout: dict, a: AttnConfig, size: int) -> bool:
    """Does `layout` (a model-sharded dimension or None per projection,
    `Planner.model_dims`) give each of `size` ranks whole query and KV
    heads?"""
    return (layout == HEAD_SHARDED and a.n_heads % size == 0
            and a.n_kv % size == 0)


# how a model-parallel attention splits its work over the model group
# (`mp_path`): whole query and KV heads a rank, its own query heads over the
# gathered K/V, its own block of query rows over every key, or every rank
# attending over every head
ALIGNED, OWN_HEADS, OWN_ROWS, WHOLE = "aligned", "heads", "rows", "whole"


def mp_path(layout: dict, a: AttnConfig, size: int, *, flash: bool) -> str:
    """The work a rank of a model group of `size` does in an attention
    under `layout`:
      * ALIGNED: the layout gives it whole query and KV heads
        (`head_aligned`);
      * OWN_HEADS: its `wq` column shard holds whole query heads (the
        query heads divide by `size`) and the KV heads do not split: it
        attends its own heads over the K/V gathered whole;
      * OWN_ROWS: the query heads do not split either: it attends its
        block of the query rows over every key (`_own_rows`). Causal
        attention splits exactly by query rows; the flash kernel takes no
        query offset, so not where it runs (`flash`: no mask and autograd
        off, `_flash_runs`);
      * WHOLE: there, every rank attends over every head."""
    if head_aligned(layout, a, size):
        return ALIGNED
    if layout["wq"] == -1 and layout["wo"] == -2 and a.n_heads % size == 0:
        return OWN_HEADS
    return WHOLE if flash else OWN_ROWS


def _own_rows(q: torch.Tensor, group) -> tuple:
    """(this rank's block of the query rows of q (B, S, ...), the first
    row's index): ceil(S / m) rows a rank of the m, the sequence padded
    with zero rows to m blocks where S does not divide (a padded row sits
    past the last position, sees every key, and its output is dropped by
    `_gather_rows`)."""
    m, S = dist.get_world_size(group), q.shape[1]
    c = -(-S // m)
    if c * m != S:
        q = torch.cat([q, q.new_zeros((q.shape[0], c * m - S)
                                      + q.shape[2:])], dim=1)
    row0 = dist.get_rank(group) * c
    return q[:, row0:row0 + c], row0


def _gather_rows(o: torch.Tensor, n: int, group) -> torch.Tensor:
    """The ranks' blocks of output rows gathered along the sequence and cut
    to its n rows. The backward keeps this rank's rows of the cotangent,
    which is whole on every rank (`gathered_rows`, `tp_split`'s
    backward)."""
    return cl.tp_all_gather(o, group, dim=1)[:, :n]


def gqa_apply(p: dict, x: torch.Tensor, a: AttnConfig, *, pos0: int = 0,
              window: int | None = None, mask: torch.Tensor | None = None,
              kv_chunk: int | None = None, tp_axis=None,
              layout: dict | None = None) -> torch.Tensor:
    """Self-attention over a sequence (training and prefill): causal, or
    bidirectional when `a.causal` is False (the encoder). `kv_chunk`: the
    online-softmax `chunked_sdpa` over chunks of that many keys where the
    materialized `_sdpa` would run.

    tp_axis (a process group): head-sharded tensor parallelism -- the
    projections in `p` are this rank's head shard (local head counts come
    from the shard shapes), x enters through the f operator (identity
    forward, all-reduce backward) and the out-projection's partial sum
    leaves through g (all-reduce forward, identity backward):
    collectives.tp_replicate / tp_psum. Rope and softmax are per head, so
    the sharded math is exact.

    layout (with tp_axis; model parallelism): each projection's
    model-sharded dimension or None (`Planner.model_dims`). A head-aligned
    layout runs as above; any other (a shard holding part of a head) goes
    through `gqa_gathered`."""
    if layout is not None and not head_aligned(
            layout, a, dist.get_world_size(tp_axis)):
        return gqa_gathered(p, x, a, tp_axis, layout, pos0=pos0,
                            window=window, mask=mask, kv_chunk=kv_chunk)
    if tp_axis is not None:
        x = cl.tp_replicate(x, tp_axis)
    o = _attend(*_project(p, x), a, pos0=pos0, window=window, mask=mask,
                kv_chunk=kv_chunk)[0]
    y = o @ p["wo"]
    if tp_axis is not None:
        y = cl.tp_psum(y, tp_axis)
    return y


def gathered_cols(w: torch.Tensor, x: torch.Tensor, xr: torch.Tensor,
                  dim, group) -> torch.Tensor:
    """x @ w whole on every rank, for a consumer whose cotangent is whole
    on every rank: a column-split w (`dim` -1) takes x through the f
    operator (`xr`, `tp_replicate(x)`) and gathers the product's columns
    over `group`; a replicated w takes x as it is."""
    return cl.tp_all_gather(xr @ w, group) if dim == -1 else x @ w


def summed_cols(w: torch.Tensor, x: torch.Tensor, xr: torch.Tensor,
                dim, group) -> torch.Tensor:
    """x @ w whole on every rank, for a consumer whose cotangent is only
    this rank's share (its own query heads or rows): a column-split w
    gathers `xr @ w` with a backward that sums the shares and keeps this
    rank's columns (`fsdp_gather`); a replicated w's product has its
    cotangent summed over `group` (the f operator), so its gradient, and
    x's, is whole on every rank."""
    if dim == -1:
        return cl.fsdp_gather(xr @ w, [group], -1)
    return cl.tp_replicate(x @ w, group)


def gathered_rows(o: torch.Tensor, w: torch.Tensor, dim,
                  group) -> torch.Tensor:
    """o @ w for a whole o on every rank: a row-split w (`dim` -2) takes
    this rank's columns of o (`tp_split`) and sums the partial products
    (`tp_psum`); a replicated w takes o as it is."""
    if dim == -2:
        return cl.tp_psum(cl.tp_split(o, group) @ w, group)
    return o @ w


def _split_attend(p: dict, x: torch.Tensor, a: AttnConfig, group,
                  layout: dict, *, pos0: int, window: int | None,
                  mask: torch.Tensor | None, kv_chunk: int | None) -> tuple:
    """(`gqa_gathered`'s output, the whole roped K and V, (B, S, KV, hd)
    each). Every projection of x (entering column-split ones through
    `tp_replicate`) is made whole on every rank; the work splits by
    `mp_path`:
      * OWN_HEADS (or ALIGNED): q is this rank's `wq` shard's product
        (its H / m whole heads), K and V are gathered with summing
        backwards (`summed_cols`: each rank's K gradient comes from its
        own heads only), and the output's columns are the rows of its `wo`
        shard (`tp_psum(o @ wo)`);
      * OWN_ROWS: q, K and V are whole through `summed_cols`; the rank
        attends its own query rows (`_own_rows`), whose outputs are
        gathered along the sequence (`_gather_rows`), then
        `gathered_rows`;
      * WHOLE: q, K and V are gathered (`gathered_cols`), every rank
        attends over all heads, and `gathered_rows` takes the output."""
    path = mp_path(layout, a, dist.get_world_size(group),
                   flash=_flash_runs(mask))
    if path == ALIGNED:         # whole KV heads too: its own query heads
        path = OWN_HEADS
    xr = cl.tp_replicate(x, group)
    kw = dict(pos0=pos0, window=window, mask=mask, kv_chunk=kv_chunk)
    if path == WHOLE:
        o, k, v = _attend(*(gathered_cols(p[n], x, xr, layout[n], group)
                            for n in ("wq", "wk", "wv")), a, **kw)
        return gathered_rows(o, p["wo"], layout["wo"], group), k, v
    k, v = (summed_cols(p[n], x, xr, layout[n], group) for n in ("wk", "wv"))
    if path == OWN_HEADS:
        q = xr @ p["wq"]
        o, k, v = _attend(q, k, v, a, q_head0=dist.get_rank(group) * (
            q.shape[-1] // a.head_dim), **kw)
        return cl.tp_psum(o @ p["wo"], group), k, v
    q, row0 = _own_rows(summed_cols(p["wq"], x, xr, layout["wq"], group),
                        group)
    o, k, v = _attend(q, k, v, a, q_row0=row0, **kw)
    return gathered_rows(_gather_rows(o, x.shape[1], group), p["wo"],
                         layout["wo"], group), k, v


def gqa_gathered(p: dict, x: torch.Tensor, a: AttnConfig, group,
                 layout: dict, *, pos0: int = 0, window: int | None = None,
                 mask: torch.Tensor | None = None,
                 kv_chunk: int | None = None) -> torch.Tensor:
    """Attention whose projections' column shards need not hold whole
    heads (a layout that is not `head_aligned`): a rank attends its own
    query heads where the query heads divide by the group size, else its
    own query rows where the flash kernel does not run, else every head
    (`mp_path`, `_split_attend`). Replicated projections use x as it
    is."""
    return _split_attend(p, x, a, group, layout, pos0=pos0, window=window,
                         mask=mask, kv_chunk=kv_chunk)[0]


def gqa_cross_kv(p: dict, enc: torch.Tensor, a: AttnConfig, *,
                 tp_axis=None, layout: dict | None = None,
                 enc_rep: torch.Tensor | None = None) -> tuple:
    """Cross-attention K and V (B, Sk, KV, hd) from the encoder output
    (whisper), unroped. Under model parallelism (`tp_axis` and the
    projections' `layout`) the encoder output enters through the f
    operator (`enc_rep`: `tp_replicate(enc)` made once for every cross
    block, else made here): this rank's heads when the layout gives whole
    heads, else the whole heads, gathered as `gqa_cross` consumes them
    (`summed_cols` for its own heads or rows, `gathered_cols` where every
    rank attends over every head)."""
    hd = a.head_dim
    if tp_axis is None:
        k, v = enc @ p["wk"], enc @ p["wv"]
    else:
        er = cl.tp_replicate(enc, tp_axis) if enc_rep is None else enc_rep
        path = mp_path(layout, a, dist.get_world_size(tp_axis),
                       flash=_flash_runs(None))
        if path == ALIGNED:
            k, v = er @ p["wk"], er @ p["wv"]
        else:
            cols = gathered_cols if path == WHOLE else summed_cols
            k, v = (cols(p[n], enc, er, layout[n], tp_axis)
                    for n in ("wk", "wv"))
    return (_split_heads(k, k.shape[-1] // hd, hd),
            _split_heads(v, v.shape[-1] // hd, hd))


def gqa_cross(p: dict, x: torch.Tensor, kv: tuple, a: AttnConfig, *,
              tp_axis=None, layout: dict | None = None) -> torch.Tensor:
    """Cross-attention of the decoder's x (B, S, d) over the encoder's
    (k, v) from `gqa_cross_kv` (with the same `tp_axis` and `layout`):
    every query sees every key, nothing is roped (the reference's
    `gqa_apply(..., kv_override=kv, mask=None)`). Under model
    parallelism x enters through f, and the work splits by `mp_path` as in
    `gqa_gathered` (own rows: the decoder's, non-causal); the
    out-projection's partial sum leaves through g."""
    S, hd = x.shape[1], a.head_dim

    def attend(q, kv, q_head0=None):
        H = q.shape[-1] // hd
        if q_head0 is not None:
            kv = tuple(_own_kv(t, a.n_heads, q_head0, H) for t in kv)
        return _attention(_split_heads(q, H, hd), *kv, causal=False,
                          window=None, mask=None).reshape(*q.shape[:2], -1)

    if tp_axis is None:
        return attend(x @ p["wq"], kv) @ p["wo"]
    path = mp_path(layout, a, dist.get_world_size(tp_axis),
                   flash=_flash_runs(None))
    xr = cl.tp_replicate(x, tp_axis)
    if path in (ALIGNED, OWN_HEADS):
        q = xr @ p["wq"]
        h0 = dist.get_rank(tp_axis) * (q.shape[-1] // hd) \
            if path == OWN_HEADS else None
        return cl.tp_psum(attend(q, kv, h0) @ p["wo"], tp_axis)
    if path == OWN_ROWS:
        q = _own_rows(summed_cols(p["wq"], x, xr, layout["wq"], tp_axis),
                      tp_axis)[0]
        o = _gather_rows(attend(q, kv), S, tp_axis)
    else:
        o = attend(gathered_cols(p["wq"], x, xr, layout["wq"], tp_axis), kv)
    return gathered_rows(o, p["wo"], layout["wo"], tp_axis)


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
                window: int | None = None, kv_dtype: str = "native",
                kv_chunk: int | None = None, tp_axis=None,
                layout: dict | None = None, kv_split: int | None = None):
    """`gqa_apply` over the whole prompt, and the cache of the K/V it
    attended to (ring-compacted if windowed): returns (y, cache). The
    reference's `gqa_prefill_cache` projects K/V a second time.
    `kv_chunk` is `gqa_apply`'s: where the flash kernel runs (no mask,
    autograd off, as in `Model.prefill`) it keeps running, since it never
    forms the scores; elsewhere `chunked_sdpa` takes it.

    Under model parallelism (`tp_axis`, `layout`) the attention runs as in
    `gqa_apply` (own query heads where they split whole and the KV heads do
    not; the flash kernel keeps whole heads where the query heads do not
    split) and the cache holds the K/V heads the cache layout gives this
    rank (`kv_split` 2: its KV heads, which head-sharded attention
    computed; else every head), every slot: `Model.prefill` keeps this
    rank's slots where the layout splits them (`kv_split` 1)."""
    kw = dict(pos0=0, window=window, mask=None, kv_chunk=kv_chunk)
    if tp_axis is None:
        o, k, v = _attend(*_project(p, x), a, **kw)
        y = o @ p["wo"]
    elif head_aligned(layout, a, dist.get_world_size(tp_axis)):
        o, k, v = _attend(*_project(p, cl.tp_replicate(x, tp_axis)), a, **kw)
        y = cl.tp_psum(o @ p["wo"], tp_axis)
    else:
        y, k, v = _split_attend(p, x, a, tp_axis, layout, **kw)
        if kv_split == 2:
            k, v = (common.own_part(t, 2, tp_axis) for t in (k, v))
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


def _combine_softmax(scores: torch.Tensor, values: torch.Tensor, eq: str,
                     group, dtype) -> torch.Tensor:
    """`einsum(eq, softmax(scores), values)` in `dtype`, the softmax over
    the last dimension of `scores` (the cache's slots). With `group` the
    slots are split over it: each rank takes its slots' running max, sum
    of exponentials and exponential-weighted values (f32); the max is
    MAX-reduced over the group (`tp_max`) and the rescaled sums added
    (`tp_psum`), so every rank gets the softmax over all slots."""
    if group is None:
        return torch.einsum(eq, torch.softmax(scores, dim=-1).to(dtype),
                            values)
    m = cl.tp_max(torch.amax(scores, dim=-1, keepdim=True), group)
    e = torch.exp(scores - m)
    denom = cl.tp_psum(torch.sum(e, dim=-1), group)
    o = cl.tp_psum(torch.einsum(eq, e, values.to(torch.float32)), group)
    # the sums laid out as o (the small output, not the scores, is divided)
    rows, out = eq.split(",")[0][:-1], eq.split("->")[1]
    denom = torch.einsum(f"{rows}->{''.join(c for c in out if c in rows)}",
                         denom)
    return (o / denom.reshape([n if c in rows else 1 for c, n in
                               zip(out, o.shape)])).to(dtype)


def _mask_slots(scores: torch.Tensor, valid: torch.Tensor | None):
    """`scores` with the slots not `valid` (bool over the last dimension;
    None: every slot) at -1e30."""
    if valid is None:
        return scores
    return torch.where(valid, scores, torch.full(
        (), -1e30, dtype=scores.dtype, device=scores.device))


def _decode_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor | None, group=None) -> torch.Tensor:
    """`_sdpa(q, _repeat_kv(k, H), _repeat_kv(v, H), valid)` for one query
    token, without the repeated copy of the cache: q (B, 1, H, hd), k/v
    (B, slots, KV, hd), valid (slots,) bool or None (every slot). Query
    head h reads KV head h // (H / KV), as `_repeat_kv` lays them out.
    With `group` k/v are this rank's block of slots split over it, and the
    softmax is combined over the ranks (`_combine_softmax`)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k).to(torch.float32)
    scores = _mask_slots(scores / math.sqrt(hd), valid)
    return _combine_softmax(scores, v, "bkgs,bskd->bkgd", group,
                            q.dtype).reshape(B, 1, H, hd)


def _slots(cache_len: int, kv_split, group) -> tuple:
    """(the cache's whole slot count, this rank's first slot): the slot
    dimension is split over `group` when `kv_split` is 1."""
    if kv_split != 1:
        return cache_len, 0
    return cache_len * dist.get_world_size(group), \
        cache_len * dist.get_rank(group)


def _decode_project(p: dict, x1: torch.Tensor, a: AttnConfig, names: tuple,
                    tp_axis, layout) -> tuple:
    """The one-token projections `names` of x1 and whether the heads are
    this rank's (head-aligned model parallelism) or whole (no model axis,
    or `gqa_gathered`'s rule)."""
    if tp_axis is None:
        return tuple(x1 @ p[n] for n in names), False
    xr = cl.tp_replicate(x1, tp_axis)
    if head_aligned(layout, a, dist.get_world_size(tp_axis)):
        return tuple(xr @ p[n] for n in names), True
    return tuple(gathered_cols(p[n], x1, xr, layout[n], tp_axis)
                 for n in names), False


def _decode_out(o: torch.Tensor, p: dict, tp_axis, layout,
                aligned: bool) -> torch.Tensor:
    """The out-projection of the attention output o (B, 1, heads * hd):
    this rank's heads' partial sum through g, or a whole o through
    `gathered_rows`."""
    if tp_axis is None:
        return o @ p["wo"]
    if aligned:
        return cl.tp_psum(o @ p["wo"], tp_axis)
    return gathered_rows(o, p["wo"], layout["wo"], tp_axis)


def _own_heads(q: torch.Tensor, kv_heads: int, group) -> torch.Tensor:
    """The query heads (B, 1, H, hd) that read this rank's block of the
    `kv_heads` KV heads (query head h reads KV head h // (H / KV))."""
    n = kv_heads // dist.get_world_size(group)
    g = q.shape[2] // kv_heads
    return q.narrow(2, dist.get_rank(group) * n * g, n * g)


def _attend_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid, kv_heads: int, tp_axis, aligned: bool,
                  kv_split) -> torch.Tensor:
    """q (B, 1, H, hd) over the cache's k/v: the softmax combined over
    the ranks' slots (`kv_split` 1), or whole heads attending over this
    rank's KV heads (`kv_split` 2 with the heads computed whole) and the
    outputs gathered, else `_decode_sdpa`. Returns (B, 1, H * hd)."""
    B = q.shape[0]
    if kv_split == 1:
        return _decode_sdpa(q, k, v, valid, tp_axis).reshape(B, 1, -1)
    if kv_split == 2 and not aligned:
        o = _decode_sdpa(_own_heads(q, kv_heads, tp_axis), k, v, valid)
        return cl.tp_all_gather(o.reshape(B, 1, -1), tp_axis)
    return _decode_sdpa(q, k, v, valid).reshape(B, 1, -1)


def gqa_decode(p: dict, x1: torch.Tensor, cache: dict, pos: int,
               a: AttnConfig, *, window: int | None = None, tp_axis=None,
               layout: dict | None = None, kv_split: int | None = None):
    """One-token decode. x1 (B, 1, d); pos (int) is the current length.
    Writes the token's K/V into `cache` in place; returns (y, cache).

    Under model parallelism (`tp_axis`, `layout`) the cache is this rank's
    shard under the cache layout: its KV heads (`kv_split` 2), its block
    of the slots (`kv_split` 1, where the KV heads do not split: only the
    rank holding the slot `pos` lands in writes it, and the softmax is
    combined over the ranks), or all of it (None)."""
    hd = a.head_dim
    (q, k1, v1), aligned = _decode_project(p, x1, a, ("wq", "wk", "wv"),
                                           tp_axis, layout)
    q, k1, v1 = (_split_heads(t, t.shape[-1] // hd, hd) for t in (q, k1, v1))
    posv = torch.full((1,), pos, device=x1.device)
    q = common.apply_rope(q, posv, rotary_frac=a.rotary_frac,
                          theta=a.rope_theta)
    k1 = common.apply_rope(k1, posv, rotary_frac=a.rotary_frac,
                           theta=a.rope_theta)
    kv_heads = k1.shape[2]
    if kv_split == 2 and not aligned:
        k1, v1 = (common.own_part(t, 2, tp_axis) for t in (k1, v1))
    n = cache["k"].shape[1]
    slots, lo = _slots(n, kv_split, tp_axis)
    # the reference's dynamic_update_slice clamps the slot into range
    k, v = _write_kv(cache, k1, v1, (pos % slots if window
                                     else min(pos, slots - 1)) - lo, x1.dtype)
    # a full ring: every slot holds one of the last `slots` positions;
    # before that only slots <= pos are written
    idx = torch.arange(lo, lo + n, device=x1.device)
    valid = None if window and pos >= slots else idx <= pos
    o = _attend_cache(q, k, v, valid, kv_heads, tp_axis, aligned, kv_split)
    return _decode_out(o, p, tp_axis, layout, aligned), cache


def _write_kv(cache: dict, k1: torch.Tensor, v1: torch.Tensor, write: int,
              dtype) -> tuple:
    """Write the token's K/V (B, 1, KV, hd) at slot `write` of `cache` (int8
    with its scales when the cache has them; nothing when `write` is not
    one of its slots) and return the cache's K/V in `dtype`."""
    if 0 <= write < cache["k"].shape[1]:
        if "k_s" in cache:
            k1q, k1s = _kv_quant(k1)
            v1q, v1s = _kv_quant(v1)
            cache["k"][:, write] = k1q[:, 0]
            cache["v"][:, write] = v1q[:, 0]
            cache["k_s"][:, write] = k1s[:, 0]
            cache["v_s"][:, write] = v1s[:, 0]
        else:
            cache["k"][:, write] = k1[:, 0]
            cache["v"][:, write] = v1[:, 0]
    if "k_s" in cache:
        return (_kv_dequant(cache["k"], cache["k_s"], dtype),
                _kv_dequant(cache["v"], cache["v_s"], dtype))
    return cache["k"], cache["v"]


def gqa_decode_cross(p: dict, x1: torch.Tensor, cross_kv: dict,
                     a: AttnConfig, *, tp_axis=None,
                     layout: dict | None = None,
                     kv_split: int | None = None) -> torch.Tensor:
    """Cross-attention for one decoder token against the fixed encoder K/V
    of the cache (`{"k", "v"}`, (B, Sk, KV, hd) each). Under model
    parallelism the encoder K/V are this rank's shard under the cache
    layout, as in `gqa_decode` (`kv_split` 1: its block of the frames)."""
    hd = a.head_dim
    (q,), aligned = _decode_project(p, x1, a, ("wq",), tp_axis, layout)
    q = _split_heads(q, q.shape[-1] // hd, hd)
    o = _attend_cache(q, cross_kv["k"], cross_kv["v"], None, a.n_kv,
                      tp_axis, aligned, kv_split)
    return _decode_out(o, p, tp_axis, layout, aligned)


# =============================== MLA =========================================

def mla_defs(d_model: int, m: MLAConfig, dtype) -> dict:
    H = m.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_dq": pl.ParamDef((d_model, m.q_lora_rank), pl.K_REPLICATED, dtype),
        "q_norm": pl.ParamDef((m.q_lora_rank,), pl.K_NORM, dtype,
                              init="ones"),
        "w_uq": pl.ParamDef((m.q_lora_rank, H * qk), pl.K_PROJ_IN, dtype),
        "w_dkv": pl.ParamDef((d_model, m.kv_lora_rank + m.qk_rope_dim),
                             pl.K_REPLICATED, dtype),
        "kv_norm": pl.ParamDef((m.kv_lora_rank,), pl.K_NORM, dtype,
                               init="ones"),
        "w_uk": pl.ParamDef((m.kv_lora_rank, H * m.qk_nope_dim),
                            pl.K_PROJ_IN, dtype),
        "w_uv": pl.ParamDef((m.kv_lora_rank, H * m.v_head_dim),
                            pl.K_PROJ_IN, dtype),
        "wo": pl.ParamDef((H * m.v_head_dim, d_model), pl.K_PROJ_OUT, dtype),
    }


def _mla_latents(p: dict, x: torch.Tensor, m: MLAConfig,
                 pos0: int) -> tuple:
    """The latents of a full sequence: the normed query latent cq, the
    normed KV latent ckv and the roped, head-shared key part kpe, each
    (B, S, *)."""
    S = x.shape[1]
    cq = common.rmsnorm(x @ p["w_dq"], p["q_norm"])
    ckv_full = x @ p["w_dkv"]
    ckv = common.rmsnorm(ckv_full[..., :m.kv_lora_rank], p["kv_norm"])
    positions = torch.arange(S, device=x.device) + pos0
    kpe = common.apply_rope(ckv_full[..., None, m.kv_lora_rank:], positions,
                            theta=m.rope_theta)[..., 0, :]
    return cq, ckv, kpe


def _mla_core(q, k_nope, v, kpe, m: MLAConfig, *, pos0: int,
              window: int | None, kv_chunk: int | None,
              q_row0: int = 0) -> torch.Tensor:
    """MLA's causal attention, before the out-projection: q (B, Sq, H *
    (nope + rope)) from the query latent, k_nope (B, S, H * nope) and v
    (B, S, H * v_head_dim) expanded from the KV latent, kpe (B, S, rope)
    shared by the heads; H is read from the widths. q's rows are query
    rows q_row0 .. of the S positions (a rank's own rows under model
    parallelism; all of them by default): roped at their absolute
    positions, masked from there. Returns (B, Sq, H * v_head_dim)."""
    B, Sq, _ = q.shape
    S = k_nope.shape[1]
    d_qk = m.qk_nope_dim + m.qk_rope_dim
    H = q.shape[-1] // d_qk
    q = q.reshape(B, Sq, H, d_qk)
    q_nope = q[..., :m.qk_nope_dim]
    positions = torch.arange(Sq, device=q.device) + pos0 + q_row0
    q_pe = common.apply_rope(q[..., m.qk_nope_dim:], positions,
                             theta=m.rope_theta)
    k_nope = k_nope.reshape(B, S, H, m.qk_nope_dim)
    v = v.reshape(B, S, H, m.v_head_dim)
    if kv_chunk is not None:
        # fold the rope part into the head dim for the online softmax
        q_cat = torch.cat([q_nope, q_pe], dim=-1)
        k_cat = torch.cat([k_nope, kpe[:, :, None, :].expand(
            B, S, H, m.qk_rope_dim)], dim=-1)
        o = chunked_sdpa(q_cat, k_cat, v, causal=True, window=window,
                         q_offset=q_row0, kv_chunk=kv_chunk,
                         scale=1.0 / math.sqrt(d_qk))
    else:
        scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
                  + torch.einsum("bqhd,bkd->bhqk", q_pe, kpe)
                  ).to(torch.float32)
        scores = scores / math.sqrt(d_qk)
        mask = common.causal_mask(Sq, S, q_offset=q_row0, window=window,
                                  device=q.device)
        scores = torch.where(mask[None, None], scores,
                             torch.full((), -1e30, dtype=scores.dtype,
                                        device=scores.device))
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return o.reshape(B, Sq, H * m.v_head_dim)


# the layout of a head-sharded MLA: the up-projections split by output
# column, the out-projection by input row, the down-projections and norms
# replicated
MLA_HEAD_SHARDED = {"w_dq": None, "q_norm": None, "w_uq": -1, "w_dkv": None,
                    "kv_norm": None, "w_uk": -1, "w_uv": -1, "wo": -2}


def mla_apply(p: dict, x: torch.Tensor, m: MLAConfig, *, pos0: int = 0,
              window: int | None = None, kv_chunk: int | None = None,
              tp_axis=None, layout: dict | None = None) -> torch.Tensor:
    """MLA over a full sequence (training). Under model parallelism
    (`tp_axis`, the projections' `layout`): the latents are computed whole
    on every rank from the replicated x, and enter the head-sharded work
    through the f operator (so the down-projections and norms get their
    whole gradients); with whole heads a rank attends over its own and the
    out-projection's partial sum leaves through g; with heads split
    (`MLA_HEAD_SHARDED` not whole over the group) every column-split
    up-projection is gathered whole and a rank attends its own query rows
    (`gqa_gathered`'s rule: MLA never runs the flash kernel)."""
    return _mla_forward(p, x, m, pos0=pos0, window=window, kv_chunk=kv_chunk,
                        tp_axis=tp_axis, layout=layout)[0]


def _mla_aligned(layout: dict, m: MLAConfig, group) -> bool:
    """Does the layout give each rank of `group` whole MLA heads?"""
    return layout == MLA_HEAD_SHARDED and \
        m.n_heads % dist.get_world_size(group) == 0


def mla_path(layout: dict, m: MLAConfig, size: int) -> str:
    """`mp_path` for MLA over a model group of `size`: ALIGNED where the
    layout gives whole heads, else OWN_ROWS (MLA never runs the flash
    kernel)."""
    if layout == MLA_HEAD_SHARDED and m.n_heads % size == 0:
        return ALIGNED
    return OWN_ROWS


def _mla_forward(p: dict, x: torch.Tensor, m: MLAConfig, *, pos0: int,
                 window: int | None, kv_chunk: int | None, tp_axis,
                 layout: dict | None) -> tuple:
    """(`mla_apply`'s output, the whole latents ckv and kpe it attended
    over). With heads split (`mla_path` OWN_ROWS) the up-projections'
    products and kpe are made whole with summing backwards (`summed_cols`,
    `tp_replicate`: each rank's share of their gradient comes from its own
    rows), and the rows' outputs are gathered along the sequence."""
    cq, ckv, kpe = _mla_latents(p, x, m, pos0)
    kw = dict(pos0=pos0, window=window, kv_chunk=kv_chunk)
    if tp_axis is None:
        return _mla_core(cq @ p["w_uq"], ckv @ p["w_uk"], ckv @ p["w_uv"],
                         kpe, m, **kw) @ p["wo"], ckv, kpe
    if _mla_aligned(layout, m, tp_axis):
        cqr, ckvr, kper = (cl.tp_replicate(t, tp_axis) for t in (cq, ckv, kpe))
        o = _mla_core(cqr @ p["w_uq"], ckvr @ p["w_uk"], ckvr @ p["w_uv"],
                      kper, m, **kw)
        return cl.tp_psum(o @ p["wo"], tp_axis), ckv, kpe
    # heads split (`mla_path` OWN_ROWS)
    cqr, ckvr = cl.tp_replicate(cq, tp_axis), cl.tp_replicate(ckv, tp_axis)
    q, row0 = _own_rows(summed_cols(p["w_uq"], cq, cqr, layout["w_uq"],
                                    tp_axis), tp_axis)
    k_nope, v = (summed_cols(p[n], ckv, ckvr, layout[n], tp_axis)
                 for n in ("w_uk", "w_uv"))
    o = _mla_core(q, k_nope, v, cl.tp_replicate(kpe, tp_axis), m,
                  q_row0=row0, **kw)
    return gathered_rows(_gather_rows(o, x.shape[1], tp_axis), p["wo"],
                         layout["wo"], tp_axis), ckv, kpe


def mla_init_cache(batch: int, max_seq: int, m: MLAConfig, dtype, *,
                   window: int | None = None, device=None) -> dict:
    slots = min(max_seq, window) if window else max_seq
    return {"ckv": torch.zeros((batch, slots, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "kpe": torch.zeros((batch, slots, m.qk_rope_dim), dtype=dtype,
                               device=device)}


def mla_prefill(p: dict, x: torch.Tensor, m: MLAConfig, *,
                window: int | None = None, kv_chunk: int | None = None,
                tp_axis=None, layout: dict | None = None):
    """`mla_apply` over the whole prompt (`kv_chunk`: its online softmax
    over chunks of that many keys, the reference's folded-rope
    `chunked_sdpa`), and the latent cache of the `ckv`/`kpe` it attended
    over (ring-compacted if windowed): returns (y, cache). The reference's
    `mla_prefill_cache` computes them again. Under model parallelism the
    latents are whole on every rank, and `Model.prefill` keeps this rank's
    slots where the cache layout splits them."""
    y, ckv, kpe = _mla_forward(p, x, m, pos0=0, window=window,
                               kv_chunk=kv_chunk, tp_axis=tp_axis,
                               layout=layout)
    S = x.shape[1]
    if window and S > window:
        # position p at ring slot p % window
        ckv = torch.roll(ckv[:, -window:], S % window, dims=1)
        kpe = torch.roll(kpe[:, -window:], S % window, dims=1)
    return y, {"ckv": ckv, "kpe": kpe}


def mla_decode(p: dict, x1: torch.Tensor, cache: dict, pos: int,
               m: MLAConfig, *, window: int | None = None, tp_axis=None,
               layout: dict | None = None, kv_split: int | None = None):
    """Absorbed-projection MLA decode: W_uk folds into the query and W_uv
    into the output, so the attention acts on the latent cache. x1 (B, 1,
    d); writes the token's latent into `cache` in place; returns (y,
    cache).

    Under model parallelism (`tp_axis`, `layout`) the latent cache is this
    rank's block of the slots (`kv_split` 1) or whole. With whole heads a
    rank absorbs its heads' queries; over split slots the absorbed queries
    of all heads are gathered (B x H x (r + rope), small), the softmax is
    combined over the ranks, and a rank expands its heads' context. With
    heads split the column-split up-projections are gathered whole (the
    decode's weights, as `gqa_gathered` gathers the training's
    products)."""
    B, r = x1.shape[0], m.kv_lora_rank
    cq = common.rmsnorm(x1 @ p["w_dq"], p["q_norm"])
    posv = torch.full((1,), pos, device=x1.device)
    ckv1_full = x1 @ p["w_dkv"]
    ckv1 = common.rmsnorm(ckv1_full[..., :r], p["kv_norm"])
    kpe1 = common.apply_rope(ckv1_full[..., None, r:], posv,
                             theta=m.rope_theta)[..., 0, :]
    aligned = tp_axis is None or _mla_aligned(layout, m, tp_axis)
    split = tp_axis is not None and kv_split == 1
    w_uq, w_uk, w_uv = p["w_uq"], p["w_uk"], p["w_uv"]
    if tp_axis is not None:
        cq = cl.tp_replicate(cq, tp_axis)
        if not aligned:   # whole heads: the column-split up-projections
            w_uq, w_uk, w_uv = (cl.tp_all_gather(p[n], tp_axis)
                                if layout[n] == -1 else p[n]
                                for n in ("w_uq", "w_uk", "w_uv"))
    Hh = w_uk.shape[-1] // m.qk_nope_dim          # the heads computed here
    q = (cq @ w_uq).reshape(B, 1, Hh, m.qk_nope_dim + m.qk_rope_dim)
    q_nope = q[..., :m.qk_nope_dim]
    q_pe = common.apply_rope(q[..., m.qk_nope_dim:], posv, theta=m.rope_theta)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope,
                         w_uk.reshape(r, Hh, m.qk_nope_dim))
    n = cache["ckv"].shape[1]
    slots, lo = _slots(n, kv_split, tp_axis)
    # the reference's dynamic_update_slice clamps the slot into range; of
    # split slots only the rank holding it writes
    write = (pos % slots if window else min(pos, slots - 1)) - lo
    if 0 <= write < n:
        cache["ckv"][:, write] = ckv1[:, 0]
        cache["kpe"][:, write] = kpe1[:, 0]
    if split and aligned:      # every head's absorbed query
        q_abs = cl.tp_all_gather(q_abs.reshape(B, 1, -1), tp_axis).reshape(
            B, 1, m.n_heads, r)
        q_pe = cl.tp_all_gather(q_pe.reshape(B, 1, -1), tp_axis).reshape(
            B, 1, m.n_heads, m.qk_rope_dim)
    ckv, kpe = cache["ckv"], cache["kpe"]
    scores = (torch.einsum("bqhr,bkr->bhqk", q_abs, ckv)
              + torch.einsum("bqhd,bkd->bhqk", q_pe, kpe)).to(torch.float32)
    scores = scores / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    # before a ring is full only the slots <= pos hold positions
    valid = None if window and pos >= slots else \
        torch.arange(lo, lo + n, device=x1.device) <= pos
    ctx = _combine_softmax(_mask_slots(scores, valid), ckv, "bhqk,bkr->bqhr",
                           tp_axis if split else None, x1.dtype)
    if split and aligned:      # this rank's heads' context
        ctx = common.own_part(ctx, 2, tp_axis)
    o = torch.einsum("bqhr,rhv->bqhv", ctx,
                     w_uv.reshape(r, Hh, m.v_head_dim)).reshape(B, 1, -1)
    return _decode_out(o, p, tp_axis, layout, aligned), cache
