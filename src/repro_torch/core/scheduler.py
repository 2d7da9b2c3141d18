"""Gradient bucketing + message prioritization (paper C4/C5).

Ports `repro/core/scheduler.py`. Gradients are fused into buckets
(flattened + concatenated), keyed by the layer order of the forward pass,
and the buckets are reduced in priority order (forward-first). The
reference expresses that order with `lax.optimization_barrier` tokens
because XLA schedules statically; in eager PyTorch the order in which the
engine issues the buckets IS the order, so no token is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import planner as planner_lib


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A fused gradient message."""

    priority: int              # 0 == most urgent (first forward layers)
    leaf_ids: tuple            # indices into the flattened gradient tree
    sizes: tuple               # element counts, same order as leaf_ids
    shapes: tuple
    dtypes: tuple

    @property
    def n_elems(self) -> int:
        return int(sum(self.sizes))


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: tuple             # ordered by priority (most urgent first)
    paths: tuple               # leaf paths of the gradient tree, in flat order


def plan_buckets(grad_tree, layer_index: Callable[[tuple], float] | None = None,
                 *, bucket_bytes: float = 25e6, bytes_per_elem: float = 4.0,
                 group_key: Callable[[tuple], object] | None = None
                 ) -> BucketPlan:
    """Group gradient leaves into fused messages ordered by forward depth.

    `grad_tree` is a nested dict of tensors (meta tensors will do: only
    shapes and dtypes are read). `layer_index(path)` maps a path to the
    layer's position in the forward pass (0 == first); the sort is stable
    over the sorted-key leaf order. A new bucket starts whenever the running
    size reaches `bucket_bytes`, and at every change of `group_key(path)`
    (never fuse differently-sharded leaves)."""
    pl = tree_lib.leaves_with_paths(grad_tree)
    order = list(range(len(pl)))
    if layer_index is not None:
        order.sort(key=lambda i: layer_index(pl[i][0]))

    buckets = []
    cur: list = []
    cur_bytes = 0.0
    cur_key = object()

    def close():
        buckets.append(Bucket(
            priority=len(buckets), leaf_ids=tuple(i for i in cur),
            sizes=tuple(int(pl[i][1].numel()) for i in cur),
            shapes=tuple(tuple(pl[i][1].shape) for i in cur),
            dtypes=tuple(pl[i][1].dtype for i in cur)))

    for i in order:
        path, leaf = pl[i]
        key = group_key(path) if group_key else None
        if group_key and cur and key != cur_key:
            close()
            cur, cur_bytes = [], 0.0
        cur_key = key
        cur.append(i)
        cur_bytes += leaf.numel() * bytes_per_elem
        if cur_bytes >= bucket_bytes:
            close()
            cur, cur_bytes = [], 0.0
    if cur:
        close()
    return BucketPlan(buckets=tuple(buckets), paths=tuple(p for p, _ in pl))


def fuse_bucket(leaves: Sequence[torch.Tensor], bucket: Bucket) -> torch.Tensor:
    """Concatenate a bucket's gradient leaves into one flat f32 message."""
    parts = [leaves[i].reshape(-1).to(torch.float32) for i in bucket.leaf_ids]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def unfuse_bucket(flat: torch.Tensor, bucket: Bucket) -> dict:
    """Split a fused message back into {leaf_id: leaf}."""
    out = {}
    off = 0
    for lid, size, shape, dtype in zip(bucket.leaf_ids, bucket.sizes,
                                       bucket.shapes, bucket.dtypes):
        out[lid] = flat[off:off + size].reshape(shape).to(dtype)
        off += size
    return out


def default_layer_index(path: tuple) -> float:
    """Heuristic forward-depth key for common param-tree layouts.

    Understands paths like ('layers', 3, 'attn', 'wq') and stacked params
    ('blocks', 'p0_attn', 'attn', 'wq') (depth unknown -> middle), with
    'embed' first and 'head'/'final' last."""
    names = []
    idx = None
    for p in path:
        if isinstance(p, int):
            idx = p
        else:
            names.append(str(p))
    joined = "/".join(names).lower()
    if "embed" in joined or "tok_emb" in joined:
        return -1.0
    if "head" in joined or "final" in joined or "lm_out" in joined:
        return 1e9
    if idx is not None:
        return float(idx)
    return 1e6


def route_buckets(plan: BucketPlan, topo, nodes: int, *,
                  bytes_per_elem: float = 4.0, fault=None,
                  wire: str = "fp32", ef: bool = False,
                  fused_quant: bool = True) -> tuple:
    """Per-bucket flat-vs-two-level route over a machine hierarchy: for each
    fused message, the per-level cost model's choice on `topo`
    (repro_torch.core.hw.Topology) with `nodes` inter-node ranks, one of
    planner.ALGO_FLAT / ALGO_HIER per bucket in plan order. `wire`/`ef`/
    `fused_quant` charge the int8 quantization term on both routes;
    `fault` (simulator.FaultSpec) re-routes every bucket under an injected
    degradation of the topology's links."""
    return tuple(
        planner_lib.choose_allreduce_algo(
            b.n_elems * bytes_per_elem, nodes, topo, fault=fault, wire=wire,
            ef=ef, fused_quant=fused_quant)
        for b in plan.buckets)
