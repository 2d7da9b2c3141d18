"""Plain reference of the data-parallel gradient exchange of a cell whose
"comm" group names it ("reference": "mlsl_int8ef_flat"): MLSL's buckets on
the flat route of a host mesh with no model axis, every leaf fused, the
int8 wire with error feedback. The bucket plan (leaves fused into messages
in forward order), the bf16 sum over the data ranks, the block-wise int8
quantize with error feedback, and the mean folded into the dequantize that
accumulates the microbatches.

The plan's rule, written from the paper's description of MLSL's
prioritized buckets: leaves in sorted-path order, stably sorted by
forward depth (an embedding first, a head last, every other leaf between);
a bucket closes once it holds at least 25e6 bytes at 4 bytes an element,
and a new one opens wherever the number of dimensions of the next leaf
differs from the last one's (leaves of different partition specs never
share a message)."""

from __future__ import annotations

import torch

BLOCK = 512          # elements per quantization block (one f32 scale each)
TILE_ROWS = 8        # blocks per tile: a message pads to dp * BLOCK * TILE_ROWS
BUCKET_BYTES = 25e6


def unmodelled(comm: dict, chips: int) -> list:
    """The settings of a cell's "comm" group that this reference does not
    model (any microbatch count is modelled)."""
    want = {"mode": "mlsl", "wire": "int8", "error_feedback": True,
            "dp_only": True, "mesh": ["host", chips, 1]}
    return [f"{k}={comm.get(k)!r} (modelled: {v!r})"
            for k, v in want.items() if comm.get(k) != v]


def depth(path: tuple) -> float:
    joined = "/".join(str(p) for p in path).lower()
    if "embed" in joined or "tok_emb" in joined:
        return -1.0
    if "head" in joined or "final" in joined or "lm_out" in joined:
        return 1e9
    return 1e6


def plan(layout: dict) -> list:
    """Buckets in priority order, each a list of (path, shape)."""
    paths = sorted(layout)
    order = sorted(paths, key=depth)
    buckets, cur, nbytes, key = [], [], 0.0, None
    for p in order:
        shape = tuple(layout[p]["shape"])
        if cur and len(shape) != key:
            buckets.append(cur)
            cur, nbytes = [], 0.0
        key = len(shape)
        cur.append((p, shape))
        nbytes += 4.0 * _numel(shape)
        if nbytes >= BUCKET_BYTES:
            buckets.append(cur)
            cur, nbytes = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def bucket_elems(bucket: list) -> int:
    return sum(_numel(s) for _, s in bucket)


def padded(n: int, dp: int) -> int:
    q = dp * BLOCK * TILE_ROWS
    return -(-n // q) * q


def fuse(grads: dict, bucket: list, n_pad: int) -> torch.Tensor:
    """The bucket's leaves, flattened and concatenated in f32, zero-padded
    to `n_pad`."""
    flat = torch.cat([grads[p].reshape(-1).float() for p, _ in bucket])
    return torch.nn.functional.pad(flat, (0, n_pad - flat.numel()))


def unfuse(flat: torch.Tensor, bucket: list) -> dict:
    out, off = {}, 0
    for p, shape in bucket:
        n = _numel(shape)
        out[p] = flat[off:off + n].reshape(shape)
        off += n
    return out


def quantize_ef(y: torch.Tensor, residual: torch.Tensor):
    """(q, scales, new residual) of y + residual in blocks of BLOCK: the
    scale is the block's largest magnitude over 127 (IEEE division), q
    rounds half to even and clips to +-127, and the new residual is what q
    times the scale leaves out."""
    y = (y + residual).reshape(-1, BLOCK)
    amax = y.abs().amax(dim=1)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(y / safe[:, None]), -127, 127)
    new_res = y + q * (-scale)[:, None]
    return q, scale, new_res.reshape(-1)


def add_message(total, flat: torch.Tensor) -> torch.Tensor:
    """`total` plus one rank's f32 message rounded to the bf16 wire."""
    wire = flat.to(torch.bfloat16).float()
    return wire if total is None else total + wire


def reduce_microbatch(s: torch.Tensor, residual: torch.Tensor,
                      acc: torch.Tensor, dp: int, group=None):
    """One microbatch's exchange of one bucket: `s`, the sum of the ranks'
    bf16 messages (summed over `group` too, where other processes hold
    other ranks), rounded to bf16, quantized with error feedback, and its
    mean added into `acc`. Returns (acc, residual)."""
    if group is not None:
        torch.distributed.all_reduce(s, group=group)
    s = s.to(torch.bfloat16).float()
    q, scale, residual = quantize_ef(s, residual)
    mean_scale = scale / torch.full_like(scale, float(dp))
    acc = acc + (q * mean_scale[:, None]).reshape(-1)
    return acc, residual
