"""Roofline terms of a dry-run step on an H100 cluster.

The port's counterpart of `repro/launch/roofline.py`. Per (arch x shape x
mesh) the dry-run (`launch/dryrun.py`) runs rank 0's step on `meta` tensors
and counts what it does; this module turns the counts into three terms, each
in seconds a rank:

    compute term    = FLOPs       / 989e12 FLOP/s (bf16 dense tensor cores)
    memory term     = bytes       / 3.35e12 B/s   (HBM3)
    collective term = sum over collectives of their ring wire bytes over
                      the link their group crosses: NVLink, 450e9 B/s a
                      direction, when every rank of the group sits in one
                      node of 8; else the node's NIC, 400 Gb/s = 50e9 B/s a
                      GPU

The constants are the H100 SXM datasheet's and a common cluster layout
(8 GPUs a node on NVLink, one 400 Gb/s NIC a GPU), model data: no run of
this repo measured them. Ranks map to nodes node-major, 8 a node (rank r in
node r // 8).

The reference parses its collectives out of the compiled HLO text and
corrects XLA's once-counted loop bodies layerwise. Here the step runs
eagerly, so every layer's ops and collectives pass the counters one by one
and no correction is needed: `CollectiveLog` records each `c10d.*` or
`_c10d_functional.*` op the step issues (its kind, input and output bytes,
group size and ranks, and the profiler range it ran in, such as the
engine's "bucket <i>"), the way `torch.distributed.tensor.debug.
CommDebugMode` finds them. `_wire_bytes` keeps the reference's ring
formulas, and `Roofline` its fields (`hlo_flops`/`hlo_bytes` hold the
counted FLOPs and bytes), so `scripts/roofline_table.py` renders both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12         # H100 SXM bf16 dense, datasheet
HBM_BW = 3.35e12            # H100 SXM HBM3, datasheet
NVLINK_BW = 450e9           # NVLink 4, a direction, within a node
NIC_BW = 50e9               # one 400 Gb/s NIC a GPU, across nodes
NODE_SIZE = 8               # GPUs a node; ranks node-major


def _wire_bytes(kind: str, nbytes: float, p: int) -> float:
    """Per-chip ring wire volume for one collective of output size nbytes."""
    if p <= 1:
        return 0.0
    if kind.startswith("all-reduce"):
        return 2.0 * nbytes * (p - 1) / p
    if kind.startswith("all-gather"):
        return nbytes * (p - 1) / p            # nbytes == gathered output
    if kind == "reduce-scatter":
        return nbytes * (p - 1)                 # nbytes == scattered output
    if kind == "all-to-all":
        return nbytes * (p - 1) / p
    if kind.startswith("collective-permute"):
        return nbytes
    return 0.0


def link_bw(ranks) -> float:
    """The bandwidth a collective over these global ranks runs at: NVLink
    inside one node, the NIC across nodes."""
    return NVLINK_BW if len({r // NODE_SIZE for r in ranks}) <= 1 else NIC_BW


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective the step issued on this rank."""

    kind: str                # the reference's names: all-reduce, ...
    in_bytes: int            # this rank's input buffer(s)
    out_bytes: int           # this rank's output buffer(s)
    group_size: int
    intra_node: bool         # every rank of the group in one node
    tag: Optional[str]       # the innermost profiler range, or None

    @property
    def message_bytes(self) -> int:
        """The whole message, as `obs.stats.LegBytes` counts a leg: the
        input of a reduce-scatter, the output of the others."""
        return self.in_bytes if self.kind == "reduce-scatter" \
            else self.out_bytes

    @property
    def wire_bytes(self) -> float:
        # _wire_bytes takes the output: an all-gather's gathered tensor, a
        # reduce-scatter's scattered one, an all-reduce's tensor
        return _wire_bytes(self.kind, self.out_bytes, self.group_size)

    @property
    def seconds(self) -> float:
        return self.wire_bytes / (NVLINK_BW if self.intra_node else NIC_BW)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


c10d = torch.ops.c10d
_funcol = torch.ops._c10d_functional

# op -> (kind, index of its output argument, of its input argument); None:
# the op works in place on its first argument
_C10D = {
    c10d.allreduce_: ("all-reduce", None, None),
    c10d.allreduce_coalesced_: ("all-reduce", None, None),
    c10d.broadcast_: ("collective-permute", None, None),
    c10d._allgather_base_: ("all-gather", 0, 1),
    c10d.allgather_: ("all-gather", 0, 1),
    c10d.allgather_into_tensor_coalesced_: ("all-gather", 0, 1),
    c10d._reduce_scatter_base_: ("reduce-scatter", 0, 1),
    c10d.reduce_scatter_: ("reduce-scatter", 0, 1),
    c10d.reduce_scatter_tensor_coalesced_: ("reduce-scatter", 0, 1),
    c10d.alltoall_base_: ("all-to-all", 0, 1),
    c10d.alltoall_: ("all-to-all", 0, 1),
}
# functional collectives return their output; their group is a name
_FUNCTIONAL = {
    _funcol.all_reduce: "all-reduce",
    _funcol.all_gather_into_tensor: "all-gather",
    _funcol.reduce_scatter_tensor: "reduce-scatter",
    _funcol.all_to_all_single: "all-to-all",
    _funcol.broadcast: "collective-permute",
}


class CollectiveLog(TorchDispatchMode):
    """Records every collective issued under it (`records`), tagged with
    the innermost `torch.profiler.record_function` range open at the time.
    Works on any device; the dry-run uses it on `meta` over a fake process
    group, where the collectives move nothing."""

    def __init__(self):
        super().__init__()
        self.records: list[Collective] = []
        self._ranges: list = []          # open range names, innermost last

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet is torch.ops.profiler._record_function_enter_new:
            self._ranges.append(args[0])
        elif packet is torch.ops.profiler._record_function_exit:
            self._ranges.pop()          # ranges nest: the innermost ends
        elif packet in _C10D:
            kind, o, i = _C10D[packet]
            pg = next(_unbox(a) for a in args if _unbox(a) is not None)
            size = _nbytes(args[0])
            self._add(kind, size if i is None else _nbytes(args[i]),
                      size if o is None else _nbytes(args[o]), pg)
        elif packet in _FUNCTIONAL:
            name = [a for a in args if isinstance(a, str)][-1]
            pg = torch._C._distributed_c10d._resolve_process_group(name)
            self._add(_FUNCTIONAL[packet], _nbytes(args[0]), _nbytes(out),
                      pg)
        return out

    def _add(self, kind, in_bytes, out_bytes, pg) -> None:
        ranks = dist.get_process_group_ranks(pg)
        self.records.append(Collective(
            kind=kind, in_bytes=int(in_bytes), out_bytes=int(out_bytes),
            group_size=len(ranks), intra_node=link_bw(ranks) == NVLINK_BW,
            tag=self._ranges[-1] if self._ranges else None))


def _unbox(a):
    if isinstance(a, torch.ScriptObject):
        try:
            return dist.ProcessGroup.unbox(a)
        except RuntimeError:
            return None
    return None


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # rank 0's counted FLOPs (per chip)
    hlo_bytes: float            # rank 0's counted bytes accessed
    wire_bytes: float           # per-chip
    model_flops: float          # 6*N(active)*D
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    useful_ratio: float
    by_kind: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            cost_full: dict, collectives, model_flops: float) -> Roofline:
    """The three terms from rank 0's counted FLOPs and bytes (`cost_full`,
    per chip, as the reference's SPMD cost analysis) and its collectives.
    `by_kind` holds the wire bytes by kind, "_counts" the collectives by
    kind, "_nvlink" the wire bytes that stayed inside a node."""
    flops = float(cost_full.get("flops", 0.0))
    bts = float(cost_full.get("bytes accessed", 0.0))
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    by_kind: dict = dict.fromkeys(kinds, 0.0)
    counts: dict = dict.fromkeys(kinds, 0)
    nvlink = t_coll = 0.0
    for c in collectives:
        by_kind[c.kind] += c.wire_bytes
        counts[c.kind] += 1
        t_coll += c.seconds
        if c.intra_node:
            nvlink += c.wire_bytes
    wire = sum(by_kind.values())
    t_comp = flops / PEAK_FLOPS
    t_mem = bts / HBM_BW
    dom = max((("compute", t_comp), ("memory", t_mem),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops=flops, hlo_bytes=bts, wire_bytes=wire,
                    model_flops=model_flops, t_compute=t_comp, t_memory=t_mem,
                    t_collective=t_coll, dominant=dom,
                    useful_ratio=(model_flops / (flops * chips)
                                  if flops else 0.0),
                    by_kind=by_kind | {"_counts": counts, "_nvlink": nvlink})
