"""MLSL-style collectives over `torch.distributed`.

Ports `repro/core/collectives.py`. The reference calls `lax` collectives
over named mesh axes inside a `shard_map`; here an axis is a process group
(a DeviceMesh dimension), and a tuple of axes is a list of groups in the
same order. Every call goes through
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
    gather-side dequantize;
  * the tensor-parallel f/g activation pair (`tp_replicate`, `tp_psum`,
    `tp_psum_scatter`) and the column exchange of model parallelism
    (`tp_all_gather`, `tp_split`, and `tp_max` outside autograd), with
    explicit backward rules, and `TPComm`;
  * FSDP's weight gather (`fsdp_gather`: all-gather forward,
    reduce-scatter backward).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.planner import mesh_shape
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


def all_to_all(x: torch.Tensor, groups: Sequence, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over one axis: x splits into p chunks along
    `split_axis`, chunk j goes to rank j, and the received chunks are
    concatenated in rank order along `concat_axis`."""
    if len(groups) != 1:
        raise ValueError("all_to_all runs over a single mesh axis")
    group = groups[0]
    p = dist.get_world_size(group)
    if x.shape[split_axis] % p:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not split over {p} ranks")
    parts = torch.stack(torch.chunk(x, p, dim=split_axis)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


def broadcast(x: torch.Tensor, groups: Sequence, *,
              root: int = 0) -> torch.Tensor:
    """The value of rank `root`, its row-major index over the axes (the
    reference's masked psum, as one broadcast per axis)."""
    sizes = [dist.get_world_size(g) for g in groups]
    coords = []
    for size in reversed(sizes):
        root, c = divmod(root, size)
        coords.append(c)
    out = x.clone()
    for g, c in zip(groups, reversed(coords)):
        dist.broadcast(out, group=g, group_src=c)
    return out


# --- activation exchange for tensor/model parallelism (hybrid execution) -----
#
# The Megatron-style conjugate operator pair: a model-sharded block wraps its
# projections as
#
#     y = tp_psum(h @ W_out_shard, group)  where  h = act(tp_replicate(x,
#     group) @ W_in_shard)
#
# `tp_replicate` (the "f" operator) is identity in the forward pass and
# all-reduces the cotangent in the backward pass: the residual stream enters
# replicated, and its gradient must re-synchronize after each rank
# back-propagated through its own head/feature shard only. `tp_psum` ("g")
# is the conjugate: all-reduce forward (the out-projection computes a
# partial sum over the sharded contraction dim), identity backward (the
# incoming cotangent is already replicated). Together they keep every
# residual-stream activation AND its gradient replicated across the model
# group while weights stay sharded. Both directions are written out as
# autograd Functions (the reference's custom_vjp), not left to autograd of
# the collectives. `groups` is one process group or a sequence of them.

def _group_list(groups) -> list:
    return list(groups) if isinstance(groups, (list, tuple)) else [groups]


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _psum(ct.contiguous(), ctx.groups), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _psum(x.contiguous(), groups)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _psum_scatter_gather(x, groups)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def _psum_scatter_gather(x: torch.Tensor, groups: list) -> torch.Tensor:
    """Reduce-scatter then all-gather along the trailing dimension, over
    the groups in order and back in reverse (the ring allreduce's two
    halves)."""
    p = axis_size(groups)
    if x.shape[-1] % p:
        raise ValueError(
            f"tp_psum_scatter: the trailing dimension {x.shape[-1]} must "
            f"divide by the group size {p} (the quantum)")
    y = x.movedim(-1, 0)
    for g in groups:
        y = _psum_scatter(y, g)
    for g in reversed(groups):
        y = _all_gather(y, g)
    return y.movedim(0, -1).contiguous()


def tp_replicate(x: torch.Tensor, groups) -> torch.Tensor:
    """f operator: identity forward; the backward all-reduces the cotangent
    over `groups`. Place on a replicated activation entering model-sharded
    projections."""
    return _Replicate.apply(x, _group_list(groups))


def tp_psum(x: torch.Tensor, groups) -> torch.Tensor:
    """g operator: all-reduce forward (combine per-shard partial sums);
    identity backward (the cotangent arrives replicated across the model
    group)."""
    return _Psum.apply(x, _group_list(groups))


def tp_psum_scatter(x: torch.Tensor, groups) -> torch.Tensor:
    """g operator in the bandwidth-optimal reduce-scatter + all-gather form:
    `tp_psum`'s value, with each rank combining 1/p of the trailing
    dimension, which must divide by the group size p (else ValueError)."""
    return _PsumScatter.apply(x, _group_list(groups))


# Column exchange for a model group whose ranks hold column shards of one
# activation (model parallelism where a head or the model dimension is
# split): `tp_all_gather` concatenates the shards along a dimension (the
# last unless told) in rank order and keeps only this rank's slice of the
# cotangent on the way back (the cotangent of the gathered tensor is the
# same on every rank of the group); `tp_split` is its conjugate, this
# rank's slice of the last dimension forward and the gathered cotangent
# backward. Where the gathered tensor's cotangent is only this rank's
# share (each rank consumes part of it), `fsdp_gather` is the gather to
# take: its backward sums the shares. `tp_max` is an all-reduce MAX
# outside autograd (a softmax's shift, whose gradient cancels). `group`
# is one process group.

def _gather_dim(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _all_gather(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


def _own_slice(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    p = dist.get_world_size(group)
    if x.shape[dim] % p:
        raise ValueError(f"the dimension {x.shape[dim]} does not split "
                         f"over the group size {p}")
    n = x.shape[dim] // p
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _own_slice(ct, ctx.group, ctx.dim), None, None


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_slice(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _gather_dim(ct, ctx.group), None


def tp_all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """All-gather along `dim` (the last by default) over `group`, in rank
    order; the backward keeps this rank's slice of the cotangent."""
    return _GatherDim.apply(x, group, dim)


def tp_split(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of the last dimension (which must divide by the
    group size); the backward all-gathers the cotangent over `group`."""
    return _SplitLast.apply(x, group)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        y = x.movedim(dim, 0)
        for g in reversed(groups):       # the innermost axis first
            y = _all_gather(y, g)
        return y.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, ct):
        y = ct.movedim(ctx.dim, 0)
        for g in ctx.groups:
            y = _psum_scatter(y, g)
        return y.movedim(0, ctx.dim).contiguous(), None, None


def fsdp_gather(x: torch.Tensor, groups, dim: int) -> torch.Tensor:
    """FSDP's just-in-time weight gather: the tiled all-gather of this
    rank's shard along `dim` over `groups` (the axes of one spec entry, in
    order; gathered innermost first, so rank (n, l) of ("node", "local")
    contributes part n * local + l). The backward reduce-scatters (sums)
    the cotangent back to the shard over the groups in order: each rank
    gets the sum over the group of the gradients of its part, which the
    step divides by the data-parallel size."""
    return _FsdpGather.apply(x, _group_list(groups), dim)


def tp_max(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise MAX over `group`, with no gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


@dataclasses.dataclass(frozen=True)
class TPComm:
    """Activation-exchange communicator for one model-parallel mesh axis:
    `axis` names it, `group` is its process group. The CommEngine hands
    this out (`engine.tp`) when its plan carries a tensor-parallel axis;
    the train step passes its group to the model, whose blocks call
    `tp_replicate` / `tp_psum` on it directly."""

    axis: str
    group: object

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        return tp_replicate(x, self.group)

    def psum(self, x: torch.Tensor, *, scatter: bool = False) -> torch.Tensor:
        if scatter:
            return tp_psum_scatter(x, self.group)
        return tp_psum(x, self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)


@dataclasses.dataclass(frozen=True)
class Comm:
    """A communicator bound to a DeviceMesh and its data axes (MLSL
    'distribution').

    `data_axes` are the gradient-reduction axes; `model_axis` names the
    node-group axis of model/hybrid parallelism. When the data dimension is
    factored over the machine hierarchy, `node_axis`/`local_axis` name the
    inter-node (fabric) and intra-node axes, and `allreduce` takes the
    two-level path (repro_torch.core.hier)."""

    mesh: object                       # torch.distributed DeviceMesh
    data_axes: tuple
    model_axis: str | None = "model"
    node_axis: str | None = None       # inter-node fabric axis
    local_axis: str | None = None      # intra-node fast-link axis

    def run(self, fn, *args):
        """Call `fn` on this rank's values. (The reference wraps `fn` in a
        shard_map over the data axes; here every rank already runs its own
        program, so there is nothing to wrap.)"""
        return fn(*args)

    def groups(self, axes: Sequence[str]) -> list:
        return [self.mesh.get_group(a) for a in axes]

    @property
    def data_parallel_size(self) -> int:
        return math.prod(mesh_shape(self.mesh)[a] for a in self.data_axes)

    @property
    def model_parallel_size(self) -> int:
        if self.model_axis is None:
            return 1
        return mesh_shape(self.mesh)[self.model_axis]

    # -- machine-hierarchy awareness ---------------------------------------

    @property
    def hierarchical(self) -> bool:
        """True when the data axes are factored over the node hierarchy."""
        return (self.node_axis is not None and self.local_axis is not None
                and self.node_axis in self.data_axes
                and self.local_axis in self.data_axes)

    @property
    def node_size(self) -> int:
        return mesh_shape(self.mesh)[self.node_axis] if self.node_axis else 1

    @property
    def local_size(self) -> int:
        return (mesh_shape(self.mesh)[self.local_axis] if self.local_axis
                else 1)

    def hier_spec(self, *, wire_intra: str = WIRE_FP32,
                  wire_inter: str = WIRE_FP32, error_feedback: bool = False):
        from repro_torch.core import hier as hier_lib
        if not self.hierarchical:
            raise ValueError(
                f"a two-level spec needs node and local axes among the data "
                f"axes: node={self.node_axis!r} local={self.local_axis!r} "
                f"data={self.data_axes}")
        return hier_lib.HierSpec(node_axis=self.node_axis,
                                 local_axis=self.local_axis,
                                 wire_intra=wire_intra,
                                 wire_inter=wire_inter,
                                 error_feedback=error_feedback)

    def allreduce(self, x: torch.Tensor, *, wire: str = WIRE_FP32,
                  wire_intra: str | None = None,
                  mean: bool = False) -> torch.Tensor:
        """Gradient allreduce over the data axes. On a hierarchical
        communicator this is the two-level path: `wire` selects the fabric
        leg, `wire_intra` the intra-node legs (bf16 when the fabric is
        lossy, fp32 otherwise)."""
        if not self.hierarchical:
            return allreduce(x, self.groups(self.data_axes), wire=wire,
                             mean=mean)
        from repro_torch.core import hier as hier_lib
        if wire_intra is None:
            wire_intra = hier_lib.default_wire_intra(wire)
        spec = self.hier_spec(wire_intra=wire_intra, wire_inter=wire)
        axes = (self.node_axis, self.local_axis)
        return hier_lib.hier_allreduce(
            x, dict(zip(axes, self.groups(axes))), spec, mean=mean)
