"""Hardware models of the cost model: chips, links, two-level topologies and
the alpha-beta collective times that route each gradient bucket flat or
two-level.

A copy of `repro/core/hw.py` (framework-free arithmetic): the port keeps its
own copy and imports nothing of the reference. It must equal the
reference's exactly (tests/test_torch_hier.py). The constants are the cost
model's data -- the paper's platforms (Intel Xeon Gold 6148 "Skylake"
nodes on 10 GbE Ethernet and on Intel Omni-Path) and the reference's TPU v5e
target -- never measurements of this port.

All bandwidths are bytes/second, latencies are seconds, flops are FLOP/s.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Chip:
    """A compute element (one node in the paper's terms, one chip in ours)."""

    name: str
    peak_flops: float          # peak FLOP/s at the training precision
    mem_bw: float              # bytes/s main-memory bandwidth
    mem_bytes: float           # capacity, bytes
    # Fraction of peak a well-tuned dense workload sustains; used only by the
    # simulator to turn FLOPs into seconds (the roofline harness reports raw
    # peak-referred terms and never applies this).
    sustained_frac: float = 0.55


@dataclasses.dataclass(frozen=True)
class Link:
    """A network link (NIC in the paper, ICI link on TPU)."""

    name: str
    bw: float                  # bytes/s per direction
    latency: float             # per-message latency, seconds


# --- reproduction target: TPU v5e ------------------------------------------
TPU_V5E = Chip("tpu-v5e", peak_flops=197e12, mem_bw=819e9, mem_bytes=16e9)
ICI_LINK = Link("ici", bw=50e9, latency=1e-6)
# inter-pod data-center network: the slow fabric of the TPU hierarchy
DCN_LINK = Link("dcn", bw=6.25e9, latency=50e-6)

# --- paper platforms ---------------------------------------------------------
# 2-socket Xeon Gold 6148: 2 x 20 cores x 2.4 GHz x 32 SP FLOP/cycle ~ 6.1 TF
# fp32 peak; DL kernels of the era sustained roughly half of that with MKL-DNN.
XEON_6148 = Chip("xeon-6148-2s", peak_flops=6.1e12, mem_bw=2 * 128e9,
                 mem_bytes=192e9, sustained_frac=0.45)
ETH_10G = Link("10gbe", bw=1.25e9, latency=30e-6)
OMNIPATH = Link("omni-path-100", bw=12.5e9, latency=1.5e-6)
# intra-node transport (shared memory / QPI): what MLSL's intra-node phase
# of the two-level allreduce rides on (You et al. 1708.02983 §4)
SHM_LINK = Link("shm-qpi", bw=40e9, latency=0.3e-6)


# --- machine hierarchy -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkDegradation:
    """Multiplicative degradation of one link (congestion, oversubscription,
    a flaky cable): effective bw = bw * bw_factor (0 < factor <= 1),
    effective latency = latency * latency_factor (factor >= 1)."""

    bw_factor: float = 1.0
    latency_factor: float = 1.0

    @property
    def healthy(self) -> bool:
        return self.bw_factor >= 1.0 and self.latency_factor <= 1.0

    def apply(self, link: Link) -> Link:
        if self.healthy:
            return link
        return Link(name=f"{link.name}!deg",
                    bw=link.bw * min(self.bw_factor, 1.0),
                    latency=link.latency * max(self.latency_factor, 1.0))


HEALTHY = LinkDegradation()


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-level machine hierarchy: `local_size` ranks per node on a fast
    `intra` link; nodes connected by the slower `inter` fabric.

    `intra_fault` / `inter_fault` are per-link degradation factors and
    `straggler` the slowest node's compute slowdown (>= 1) — the scenario
    knobs Keuper & Pfreundt (arXiv:1609.06870) identify as where scale-out
    limits actually appear. The collective time models below always cost on
    the *effective* (degraded) links; a healthy topology is the default."""

    name: str
    intra: Link
    inter: Link
    local_size: int
    intra_fault: LinkDegradation = HEALTHY
    inter_fault: LinkDegradation = HEALTHY
    straggler: float = 1.0
    # per-rank main-memory bandwidth (bytes/s): what the wire-quantization
    # transform passes are paced by. Defaults to the Xeon 6148 node the
    # paper's platforms are built from; TPU topologies override with HBM.
    mem_bw: float = 2 * 128e9

    def flat_size(self, nodes: int) -> int:
        return nodes * self.local_size

    @property
    def effective_intra(self) -> Link:
        return self.intra_fault.apply(self.intra)

    @property
    def effective_inter(self) -> Link:
        return self.inter_fault.apply(self.inter)

    def degrade(self, *, intra_bw: float = 1.0, intra_latency: float = 1.0,
                inter_bw: float = 1.0, inter_latency: float = 1.0,
                straggler: float = 1.0) -> "Topology":
        """A degraded copy; factors COMPOSE with any existing degradation."""
        return dataclasses.replace(
            self,
            intra_fault=LinkDegradation(
                self.intra_fault.bw_factor * intra_bw,
                self.intra_fault.latency_factor * intra_latency),
            inter_fault=LinkDegradation(
                self.inter_fault.bw_factor * inter_bw,
                self.inter_fault.latency_factor * inter_latency),
            straggler=max(self.straggler, 1.0) * max(straggler, 1.0))


# cloud VMs without a shared-memory transport: intra-host ranks talk MPI over
# the virtio/TCP loopback stack while the fabric NIC is SR-IOV passthrough at
# near line rate -- the virtualization overhead case of Keuper & Pfreundt
# (arXiv:1609.06870). Uniquely, the *intra* link is SLOWER than the fabric,
# so bulk messages legitimately route flat (hier's two intra phases cost more
# than the fabric-volume saving) until the fabric degrades.
VIRTIO_TCP = Link("virtio-tcp", bw=0.9e9, latency=40e-6)
SRIOV_10G = Link("sriov-10gbe", bw=1.25e9, latency=35e-6)

# canonical hierarchies
CLOUD_10G = Topology("xeon-shm-10gbe", intra=SHM_LINK, inter=ETH_10G,
                     local_size=4)
HPC_OPA = Topology("xeon-shm-opa", intra=SHM_LINK, inter=OMNIPATH,
                   local_size=4)
TPU_MULTIPOD = Topology("v5e-ici-dcn", intra=ICI_LINK, inter=DCN_LINK,
                        local_size=256, mem_bw=TPU_V5E.mem_bw)
CLOUD_VIRT = Topology("cloud-virtio-sriov", intra=VIRTIO_TCP,
                      inter=SRIOV_10G, local_size=4)

# by-name lookup for config surfaces (train.CommConfig.topo stays a plain
# string so configs remain hashable/serializable)
TOPOLOGIES = {t.name: t for t in (CLOUD_10G, HPC_OPA, TPU_MULTIPOD,
                                  CLOUD_VIRT)}


# --- collective time models --------------------------------------------------
# Classic alpha-beta models; ring algorithms for bandwidth-bound collectives
# (what MLSL/MPI used on Ethernet/OPA, and a faithful per-link model for ICI).

def ring_allreduce_time(nbytes: float, p: int, link: Link) -> float:
    """Ring allreduce: 2(p-1) steps, each moving nbytes/p."""
    if p <= 1 or nbytes <= 0:
        return 0.0
    steps = 2 * (p - 1)
    return steps * link.latency + steps * (nbytes / p) / link.bw


def reduce_scatter_time(nbytes: float, p: int, link: Link) -> float:
    if p <= 1 or nbytes <= 0:
        return 0.0
    steps = p - 1
    return steps * link.latency + steps * (nbytes / p) / link.bw


def all_gather_time(nbytes: float, p: int, link: Link) -> float:
    # nbytes = full (gathered) size.
    if p <= 1 or nbytes <= 0:
        return 0.0
    steps = p - 1
    return steps * link.latency + steps * (nbytes / p) / link.bw


def all_to_all_time(nbytes: float, p: int, link: Link) -> float:
    """Pairwise-exchange all-to-all; nbytes = local send buffer size."""
    if p <= 1 or nbytes <= 0:
        return 0.0
    steps = p - 1
    return steps * link.latency + nbytes * (p - 1) / p / link.bw


# --- wire-quantization overhead (the int8 transform's HBM traffic) ----------
# Per-element HBM bytes of the int8 wire transform, by pass. The fused Pallas
# kernels (repro.kernels.quant8) read and write each gradient element once
# per leg direction; the composed (unfused) path materializes the cast, the
# error-feedback add, and the residual update as separate round-trips.
#
#   quantize side (per element of the quantized message volume):
#     fused, EF:     read bf16 x (2) + read f32 residual (4)
#                    + write q (1) + write residual (4)          = 11 B
#     unfused, EF:   cast bf16->f32 (2r+4w=6) + EF add (4+4r+4w=12)
#                    + quantize (4r+1w=5) + dequant for the error (1r+4w=5)
#                    + residual subtract (4+4r+4w=12)            = 40 B
#     fused, plain:  read bf16 (2) + write q (1)                 =  3 B
#     unfused, plain: cast (6) + quantize (5)                    = 11 B
#   dequantize side (gather):
#     fused:         read q (1) + read f32 acc (4) + write (4)   =  9 B
#     unfused:       dequant (1r+4w=5) + accumulate (4+4r+4w=12) = 17 B
#
# (per-block scales are n/512 of the volume -- ignored as noise.)

_QUANT_BYTES = {                     # (ef, fused) -> quantize-side B/elem
    (True, True): 11.0, (True, False): 40.0,
    (False, True): 3.0, (False, False): 11.0,
}
_DEQUANT_BYTES = {True: 9.0, False: 17.0}      # fused -> gather-side B/elem


def quant_hbm_bytes(n_elems: float, *, ef: bool = False,
                    fused: bool = True) -> float:
    """Total modeled HBM traffic (bytes) of one int8 wire transform over an
    n_elems message: quantize side + gather-side dequantize/accumulate."""
    if n_elems <= 0:
        return 0.0
    return n_elems * (_QUANT_BYTES[(ef, fused)] + _DEQUANT_BYTES[fused])


def quant_overhead_time(nbytes: float, topo: Topology, *, ef: bool = False,
                        fused: bool = True) -> float:
    """Time the int8 wire transform adds to one leg: passes x bytes / mem_bw.

    `nbytes` is the f32 size of the quantized message volume (the shard the
    leg actually quantizes); the per-pass byte counts above are per element,
    so elems = nbytes / 4."""
    if nbytes <= 0:
        return 0.0
    return quant_hbm_bytes(nbytes / 4.0, ef=ef, fused=fused) / topo.mem_bw


def hier_allreduce_time(nbytes: float, nodes: int, topo: Topology, *,
                        wire_inter: str = "fp32", ef: bool = False,
                        fused_quant: bool = True) -> float:
    """Two-level allreduce over `nodes` nodes of `topo.local_size` ranks.

    intra-node reduce-scatter (full volume, fast link) + inter-node ring
    allreduce on nbytes/local_size (slow fabric) + intra-node all-gather.
    Reduces the fabric volume by local_size vs `flat_allreduce_time`.

    With the int8 fabric wire (`wire_inter="int8"`), the per-leg
    quantization overhead (passes x bytes / mem_bw) is charged on the
    fabric-shard volume -- `fused_quant` selects the single-pass kernels,
    so the planner sees the fusion win.
    """
    local = topo.local_size
    if nbytes <= 0 or topo.flat_size(nodes) <= 1:
        return 0.0
    t = reduce_scatter_time(nbytes, local, topo.effective_intra)
    t += ring_allreduce_time(nbytes / max(local, 1), nodes,
                             topo.effective_inter)
    t += all_gather_time(nbytes, local, topo.effective_intra)
    if wire_inter == "int8":
        t += quant_overhead_time(nbytes / max(local, 1), topo, ef=ef,
                                 fused=fused_quant)
    return t


def flat_allreduce_time(nbytes: float, nodes: int, topo: Topology, *,
                        wire: str = "fp32", ef: bool = False,
                        fused_quant: bool = True) -> float:
    """Single-level ring over all nodes*local ranks, paced end to end by the
    (effective) fabric: the topology-unaware algorithm does not exploit the
    intra-node transport, so every hop rides the fabric path (all of a
    node's ranks serialize on its NIC). The int8 wire's quantization
    overhead is charged on the full message (the gather-side dequantize
    consumes the fully-gathered volume)."""
    t = ring_allreduce_time(nbytes, topo.flat_size(nodes),
                            topo.effective_inter)
    if wire == "int8":
        t += quant_overhead_time(nbytes, topo, ef=ef, fused=fused_quant)
    return t


def latency_bound_fraction(nbytes: float, p: int, link: Link) -> float:
    """Fraction of a ring allreduce spent in per-message latency.

    The paper's first-layer gradients are 'latency bound': this is ~1 for
    small messages and ->0 for large ones.
    """
    t = ring_allreduce_time(nbytes, p, link)
    if t == 0:
        return 0.0
    return (2 * (p - 1) * link.latency) / t


def tree_depth(p: int) -> int:
    return max(1, int(math.ceil(math.log2(max(p, 2)))))
