"""Hierarchical two-level collectives (machine-hierarchy-aware scale-out).

Ports `repro/core/hier.py`. The two-level decomposition of an allreduce
over p = nodes x local ranks

    intra-node reduce-scatter  (local axis, fast link, full volume)
    inter-node allreduce       (node axis, slow fabric, volume / local)
    intra-node all-gather      (local axis, fast link, full volume)

moves only 1/local of the bytes across the fabric and lets each level pick
its wire: the intra legs run at fp32 or bf16, the fabric leg may run the
int8 block-quantized wire with error feedback (the quant8 kernels through
`kernels/ops.py`, as on the flat route).

An axis is a process group here: `groups` maps the spec's axis names
("node", "local") to the groups of a DeviceMesh's dimensions. Every leg is
a `torch.distributed` call, also over a group of one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import collectives as cl
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant8

NODE_AXIS = "node"      # inter-node (fabric) mesh axis
LOCAL_AXIS = "local"    # intra-node (high-bandwidth) mesh axis

# Intra-node legs must REDUCE in transit, so only real float wire formats are
# legal there; the lossy int8 wire is gather-only and belongs on the fabric.
INTRA_WIRES = (cl.WIRE_FP32, cl.WIRE_BF16)


@dataclasses.dataclass(frozen=True)
class HierSpec:
    """Axis factoring + per-leg wire precision of a two-level allreduce."""

    node_axis: str = NODE_AXIS
    local_axis: str = LOCAL_AXIS
    wire_intra: str = cl.WIRE_FP32     # reduce-scatter / all-gather legs
    wire_inter: str = cl.WIRE_FP32     # fabric allreduce leg
    error_feedback: bool = False       # int8 fabric leg only
    # int8 kernel dispatch, resolved once by the CommEngine through
    # kernels.ops.wire_backend ("auto" | "cuda" | "torch")
    backend: str = "auto"
    fused: bool = True                 # single-pass kernels (False: composed)

    def __post_init__(self):
        if self.wire_intra not in INTRA_WIRES:
            raise ValueError(
                f"intra-node wire must be one of {INTRA_WIRES}, got "
                f"{self.wire_intra!r} (int8 is gather-only; use it on the "
                f"inter-node leg)")
        if self.wire_inter not in cl.WIRES:
            raise ValueError(self.wire_inter)
        if self.error_feedback and self.wire_inter != cl.WIRE_INT8:
            raise ValueError("error feedback requires the int8 fabric leg")
        if self.backend not in ("auto",) + kops.BACKENDS:
            raise ValueError(
                f"unknown quantization backend {self.backend!r}")


def default_wire_intra(wire_inter: str) -> str:
    """Intra-node legs default to fp32 for a lossless fabric and to bf16
    once the fabric leg is lossy anyway (the policy of Comm.allreduce and
    CommConfig.wire_intra=None)."""
    return cl.WIRE_FP32 if wire_inter == cl.WIRE_FP32 else cl.WIRE_BF16


def _pad_quantum(local: int, node: int, wire_inter: str) -> int:
    """Flat-message padding so both legs tile evenly: local | n for the
    intra scatter, and with the int8 fabric leg whole (TILE_ROWS x
    QUANT_BLOCK) quantization rows per node rank, so the fabric allreduce
    never pads again."""
    if wire_inter == cl.WIRE_INT8:
        return local * node * cl.QUANT_BLOCK * quant8.TILE_ROWS
    return local


def _intra_scatter(x: torch.Tensor, spec: HierSpec, local_group, node: int):
    """Leg 1: the wire-dtype message, padded, reduce-scattered over the
    local group."""
    local = cl.axis_size([local_group])
    wire_dtype = (torch.bfloat16 if spec.wire_intra == cl.WIRE_BF16
                  else torch.float32)
    flat = x.reshape(-1).to(wire_dtype)
    flat = cl._pad_flat(flat, _pad_quantum(local, node, spec.wire_inter))
    return cl._psum_scatter(flat, local_group), local


def _intra_gather(shard, x: torch.Tensor, local_group, p: int, *,
                  mean: bool, acc):
    """Leg 3: all-gather over the local group, then the mean and the
    accumulator on the full message (as the reference applies them)."""
    out = cl._all_gather(shard, local_group)
    out = out[: x.numel()].reshape(x.shape).to(x.dtype)
    if mean:
        out = cl._div(out, p)
    if acc is not None:
        out = acc.reshape(x.shape) + out
    return out


def hier_allreduce(x: torch.Tensor, groups: Mapping,
                   spec: HierSpec = HierSpec(), *, mean: bool = False,
                   acc: torch.Tensor | None = None) -> torch.Tensor:
    """Two-level allreduce; shape- and dtype-preserving.

    Equivalent to `collectives.allreduce(x, [node, local])` with the fabric
    leg carrying 1/local of the volume and each leg's wire chosen on its
    own. The int8 fabric leg consumes the wire-dtype shard directly (the
    cast is folded into the quantize kernel). `acc` (f32, x's shape) is
    added to the reduced result."""
    node_group, local_group = groups[spec.node_axis], groups[spec.local_axis]
    node = cl.axis_size([node_group])
    shard, local = _intra_scatter(x, spec, local_group, node)
    # leg 2: the fabric allreduce on 1/local of the volume
    shard = cl.allreduce(shard, [node_group], wire=spec.wire_inter,
                         backend=spec.backend, fused=spec.fused)
    return _intra_gather(shard, x, local_group, local * node, mean=mean,
                         acc=acc)


def hier_allreduce_ef(x: torch.Tensor, residual: torch.Tensor,
                      groups: Mapping,
                      spec: HierSpec = HierSpec(wire_inter=cl.WIRE_INT8,
                                                error_feedback=True), *,
                      mean: bool = False, acc: torch.Tensor | None = None):
    """Two-level allreduce with error feedback on the int8 fabric leg.

    `residual` has shape `ef_residual_shape(x.numel(), local, node)`: the
    quantization error of this rank's fabric shard (the node-th fabric
    sub-chunk of the local-th intra chunk), carried into the next call.
    Returns (reduced, new_residual)."""
    if spec.wire_inter != cl.WIRE_INT8:
        raise ValueError(f"error feedback needs the int8 fabric leg: {spec}")
    node_group, local_group = groups[spec.node_axis], groups[spec.local_axis]
    node = cl.axis_size([node_group])
    shard, local = _intra_scatter(x, spec, local_group, node)
    shard, new_residual = cl.allreduce_ef(shard, residual, [node_group],
                                          backend=spec.backend,
                                          fused=spec.fused)
    return _intra_gather(shard, x, local_group, local * node, mean=mean,
                         acc=acc), new_residual


def ef_residual_shape(n_elems: int, local: int, node: int) -> tuple:
    """Residual shape for an n_elems bucket on a (node, local) factoring:
    n padded to the two-level quantum, divided by local (intra scatter) and
    by node (fabric scatter)."""
    quantum = _pad_quantum(local, node, cl.WIRE_INT8)
    padded = ((n_elems + quantum - 1) // quantum) * quantum
    return (padded // (local * node),)


# --------------------------------------------------------------------------
# Wire-byte accounting (what each level carries)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireBytes:
    """Amortized bytes one gradient element occupies, split by level."""

    intra: float        # bytes/elem over the intra-node link
    inter: float        # bytes/elem over the inter-node fabric
    total: float


def hier_wire_bytes_per_elem(spec: HierSpec, local: int,
                             node: int) -> WireBytes:
    """Per-element wire bytes of the two-level path, by level, in the
    convention of `collectives.wire_bytes_per_elem`: the fabric leg carries
    n/local elements, so its cost is the flat wire's divided by local."""
    isz = 2.0 if spec.wire_intra == cl.WIRE_BF16 else 4.0
    intra = (isz + isz) / 2.0 if local > 1 else 0.0   # RS leg + AG leg
    inter = (cl.wire_bytes_per_elem(spec.wire_inter) / local
             if node > 1 else 0.0)
    return WireBytes(intra=intra, inter=inter, total=intra + inter)


def flat_wire_bytes_per_elem(wire: str) -> WireBytes:
    """Flat single-level allreduce in the same accounting: every byte of the
    message crosses the fabric."""
    b = cl.wire_bytes_per_elem(wire)
    return WireBytes(intra=0.0, inter=b, total=b)
