"""MLSL-style collectives over `torch.distributed`.

Ports the data-parallel half of `repro/core/collectives.py`. The reference
calls `lax` collectives over named mesh axes inside a `shard_map`; here an
axis is a process group (a DeviceMesh dimension), and a tuple of axes is a
list of groups in the same order. Every call goes through
`torch.distributed`, NCCL on the card and gloo on the CPU, also at world size
1: there is no branch that skips the call for one rank.

  * wire precision per collective ("fp32" | "bf16" | "int8"): int8 composes
    reduce_scatter(bf16) -> block-quantize -> all_gather(int8 + f32 scales)
    -> dequantize, scattering over the axes in order and gathering in
    reverse;
  * an optional error-feedback residual for the lossy int8 path; the
    residual is this rank's shard of the fabric message
    (`ef_residual_shape`);
  * the mean folds into the scale vector, and an accumulator folds into the
    gather-side dequantize.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant8

WIRE_FP32 = "fp32"
WIRE_BF16 = "bf16"
WIRE_INT8 = "int8"
WIRES = (WIRE_FP32, WIRE_BF16, WIRE_INT8)

QUANT_BLOCK = 512


def wire_bytes_per_elem(wire: str, compute_dtype=torch.float32) -> float:
    """Bytes that one gradient element occupies on the wire (amortized)."""
    if wire == WIRE_FP32:
        return torch.empty((), dtype=compute_dtype).element_size()
    if wire == WIRE_BF16:
        return 2.0
    if wire == WIRE_INT8:
        # reduce-scatter leg in bf16 + all-gather leg in int8 + one f32
        # scale per QUANT_BLOCK elements
        return (2.0 + 1.0 + 4.0 / QUANT_BLOCK) / 2.0
    raise ValueError(wire)


def axis_size(groups: Sequence) -> int:
    """Product of the group sizes (the reference's manual-axis size)."""
    return math.prod(dist.get_world_size(g) for g in groups)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """x / d as an IEEE division on every device (PyTorch divides a CUDA
    tensor by a Python scalar through the scalar's reciprocal)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _pad_flat(flat: torch.Tensor, quantum: int) -> torch.Tensor:
    n = flat.shape[0]
    padded = ((n + quantum - 1) // quantum) * quantum
    return F.pad(flat, (0, padded - n)) if padded != n else flat


def _psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled reduce-scatter along dim 0: rank i keeps the i-th chunk.
    (PyTorch 2.13 adds the name `reduce_scatter_single` and deprecates this
    one, which still works; likewise `all_gather_into_tensor` below.)"""
    out = torch.empty((x.shape[0] // dist.get_world_size(group),)
                      + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-gather along dim 0, in rank order."""
    out = torch.empty((x.shape[0] * dist.get_world_size(group),)
                      + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _psum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    out = x.clone()
    for g in groups:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    return out


def allreduce(x: torch.Tensor, groups: Sequence, *, wire: str = WIRE_FP32,
              mean: bool = False, backend: str = "auto", fused: bool = True,
              acc: torch.Tensor | None = None) -> torch.Tensor:
    """Allreduce with a selectable wire precision. Shape-preserving.

    `acc` (x's element count, f32) fuses the gather-side accumulate: the
    reduced message is added into `acc` and the sum returned, on the int8
    wire through `dequantize_accumulate` in the same pass."""
    p = axis_size(groups)
    if wire == WIRE_INT8:
        return _allreduce_int8(x, groups, mean=mean, backend=backend,
                               fused=fused, acc=acc)
    if wire == WIRE_FP32:
        out = _psum(x, groups)
    elif wire == WIRE_BF16:
        out = _psum(x.to(torch.bfloat16), groups).to(x.dtype)
    else:
        raise ValueError(wire)
    if mean:
        out = _div(out, p)
    if acc is not None:
        out = acc.reshape(x.shape) + out
    return out


def _gather_quantized(q: torch.Tensor, s: torch.Tensor, groups: Sequence):
    for g in reversed(list(groups)):     # gather back in reverse scatter order
        q = _all_gather(q, g)
        s = _all_gather(s, g)
    return q, s


def _dequant_full(q, s, meta, n_full: int, *, size: int, shape, out_dtype,
                  mean_div: int, backend: str, acc):
    """Gather-side dequantize of the gathered message. The mean folds into
    the per-block scale vector; with `acc` the dequantize accumulates
    straight into the f32 accumulator (dequantize_accumulate_blocks)."""
    if mean_div > 1:
        s = _div(s, mean_div)
    full_meta = dataclasses.replace(meta, shape=(n_full,), n=n_full,
                                    dtype=torch.float32)
    if acc is not None:
        out = kops.dequantize_accumulate(q, s, acc.reshape(-1), full_meta,
                                         backend=backend)
        return out[:size].reshape(shape)          # stays f32 (acc's dtype)
    deq = kops.dequantize(q, s, full_meta, backend=backend)
    return deq[:size].reshape(shape).to(out_dtype)


def _scatter_shard(x: torch.Tensor, groups: Sequence) -> tuple:
    """bf16 wire buffer padded to whole quantization rows per rank, then
    reduce-scattered over each axis in order. Returns (shard, padded n)."""
    p = axis_size(groups)
    flat = x.reshape(-1).to(torch.bfloat16)
    flat = _pad_flat(flat, p * QUANT_BLOCK * quant8.TILE_ROWS)
    shard = flat
    for g in groups:
        shard = _psum_scatter(shard, g)
    return shard, flat.shape[0]


def _allreduce_int8(x: torch.Tensor, groups: Sequence, *, mean: bool = False,
                    backend: str = "auto", fused: bool = True,
                    acc: torch.Tensor | None = None) -> torch.Tensor:
    """reduce_scatter(bf16) + quantize + all_gather(int8) + dequantize."""
    p = axis_size(groups)
    shard, n_full = _scatter_shard(x, groups)
    if fused:
        # the wire cast is folded into the quantize kernel: the bf16 shard
        # is consumed directly, no f32 copy
        q, s, meta = kops.quantize(shard, block=QUANT_BLOCK, backend=backend)
    else:
        q, s, meta = kops.quantize(shard.to(torch.float32), block=QUANT_BLOCK,
                                   backend=backend)
    q, s = _gather_quantized(q, s, groups)
    return _dequant_full(q, s, meta, n_full, size=x.numel(), shape=x.shape,
                         out_dtype=x.dtype, mean_div=p if mean else 1,
                         backend=backend, acc=acc)


def allreduce_ef(x: torch.Tensor, residual: torch.Tensor, groups: Sequence,
                 *, mean: bool = False, backend: str = "auto",
                 fused: bool = True, acc: torch.Tensor | None = None):
    """int8 allreduce with error feedback.

    `residual` has the shape of this rank's reduce-scatter shard
    (`ef_residual_shape`); the quantization error of the local shard is
    carried into the next call. Fused, one kernel reads the bf16 shard and
    the f32 residual and writes q, the scales and the new residual;
    `fused=False` runs the composed passes (bitwise the same at f32).
    Returns (reduced, new_residual)."""
    p = axis_size(groups)
    shard, n_full = _scatter_shard(x, groups)
    if fused:
        q, s, meta, new_residual = kops.quantize_ef(
            shard, residual, block=QUANT_BLOCK, backend=backend)
    else:
        # composed passes: cast/add, quantize, then the residual update as
        # y + q * (-s) through dequantize_accumulate (bitwise y - q * s)
        y = shard.to(torch.float32) + residual
        q, s, meta = kops.quantize(y, block=QUANT_BLOCK, backend=backend)
        new_residual = kops.dequantize_accumulate(q, -s, y, meta,
                                                  backend=backend)
    q, s = _gather_quantized(q, s, groups)
    out = _dequant_full(q, s, meta, n_full, size=x.numel(), shape=x.shape,
                        out_dtype=x.dtype, mean_div=p if mean else 1,
                        backend=backend, acc=acc)
    return out, new_residual


def ef_residual_shape(n_elems: int, p: int) -> tuple:
    """Shape of this rank's error-feedback residual for an n_elems bucket
    on p ranks."""
    quantum = p * QUANT_BLOCK * quant8.TILE_ROWS
    padded = ((n_elems + quantum - 1) // quantum) * quantum
    return (padded // p,)


def reduce_scatter(x: torch.Tensor, groups: Sequence, *,
                   wire: str = WIRE_FP32) -> torch.Tensor:
    y = x.to(torch.bfloat16) if wire == WIRE_BF16 else x
    for g in groups:
        y = _psum_scatter(y, g)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Tiled all-gather along dim 0 over the axes in reverse order."""
    y = x
    for g in reversed(list(groups)):
        y = _all_gather(y, g)
    return y
