"""Compute-to-communication (C2C) ratio analysis.

A copy of `repro/core/c2c.py` (framework-free arithmetic on the port's copy
of `core/hw.py`): the port keeps its own copy and imports nothing of the
reference. It must equal the reference exactly, ratios and choices alike
(tests/test_torch_c2c.py).

This is the paper's analytical foundation (Section "Design choices and
insights", following Das et al. 2016, arXiv:1602.06709): for every layer,
compute the number of compute operations per communicated byte under each
parallelization strategy, and pick the strategy that maximizes the ratio.

  * Under *data parallelism* the C2C ratio of a conv layer is a function of
    the output-featuremap size and the mini-batch (and overlap), and is
    INDEPENDENT of kernel size, #input/#output feature maps, and stride.
  * The ratio is proportional to the mini-batch -> strong-scaling shrinks the
    per-node batch and communication starts to dominate (motivates
    large-batch training, C3).
  * Under *model parallelism* activations are exchanged instead of weight
    gradients, flipping which layers are cheap to distribute.
  * *Hybrid parallelism* interpolates with a node-group size g: model
    parallelism inside a group of g nodes, data parallelism across p/g
    groups.

`block_layer` reads the config fields of every block kind. The port's
`ModelConfig` has only those of the kinds it runs; a kind whose field it
lacks (mla, moe, ssm, rglru) reads None there, and fails as the reference
does on a config without that field.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Sequence

from repro_torch.core import hw


class LayerKind(str, enum.Enum):
    CONV = "conv"
    FC = "fc"                  # fully-connected / generic matmul projection
    ATTENTION = "attention"    # self-attention block (proj + score/context)
    MOE = "moe"                # expert-parallel MLP
    SSM = "ssm"                # state-space (SSD) mixer
    EMBED = "embed"
    NORM = "norm"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Shape summary of one layer, enough for the C2C analysis.

    For convs: weight_elems = K*K*Cin*Cout, out_elems_per_sample = Ho*Wo*Cout.
    For matmuls: weight_elems = Din*Dout, out_elems_per_sample = S*Dout.
    flops_fwd_per_sample counts one forward pass of ONE sample.
    """

    name: str
    kind: LayerKind
    weight_elems: float
    out_elems_per_sample: float
    flops_fwd_per_sample: float
    # multiplier for backward work relative to forward (dgrad + wgrad).
    bwd_flops_factor: float = 2.0


class Strategy(str, enum.Enum):
    DATA = "data"
    MODEL = "model"
    HYBRID = "hybrid"


@dataclasses.dataclass(frozen=True)
class StrategyChoice:
    strategy: Strategy
    group_size: int            # model-parallel node-group size g (1 == data)
    ratio: float               # achieved C2C ratio (flops per byte)
    comm_bytes: float          # bytes communicated per iteration per node


def _iter_flops(layer: LayerSpec, batch: int) -> float:
    return layer.flops_fwd_per_sample * batch * (1.0 + layer.bwd_flops_factor)


def data_parallel_ratio(layer: LayerSpec, batch: int, p: int,
                        bytes_per_elem: float = 4.0) -> float:
    """FLOPs per communicated byte with pure data parallelism.

    Communication = ring allreduce of the weight gradient: each node moves
    ~2 * W * (p-1)/p bytes per iteration regardless of batch, so the ratio
    grows linearly with the batch -- the paper's large-batch argument.
    """
    if layer.weight_elems == 0:
        return math.inf
    comm = 2.0 * layer.weight_elems * bytes_per_elem * (p - 1) / max(p, 1)
    if comm == 0:
        return math.inf
    return _iter_flops(layer, batch) / comm


def model_parallel_ratio(layer: LayerSpec, batch: int, g: int,
                         bytes_per_elem: float = 4.0) -> float:
    """FLOPs per byte with the layer model-partitioned across g nodes.

    Communication = activations + activation gradients crossing the partition
    (allgather of the layer output and the reverse in backprop), which scales
    with batch * output size; weights never move.
    """
    if g <= 1:
        return math.inf
    comm = 2.0 * layer.out_elems_per_sample * batch * bytes_per_elem \
        * (g - 1) / g
    if comm == 0:
        return math.inf
    return _iter_flops(layer, batch) / comm


def hybrid_ratio(layer: LayerSpec, batch: int, p: int, g: int,
                 bytes_per_elem: float = 4.0) -> float:
    """Node groups of size g: model parallel inside, data parallel across.

    Per-node communication is the sum of (a) activation exchange inside the
    group (batch is divided across the p/g groups -> local batch b*g/p...
    actually each group processes batch/(p/g) samples) and (b) the weight-
    gradient allreduce across groups of the 1/g weight shard.
    g == 1 degenerates to pure data parallelism, g == p to pure model
    parallelism -- the paper's 'two extreme design points'.
    """
    if p % g != 0:
        return 0.0
    groups = p // g
    local_batch = batch / groups
    comm = 0.0
    if g > 1:
        comm += 2.0 * layer.out_elems_per_sample * local_batch \
            * bytes_per_elem * (g - 1) / g
    if groups > 1:
        comm += 2.0 * (layer.weight_elems / g) * bytes_per_elem \
            * (groups - 1) / groups
    if comm == 0:
        return math.inf
    return _iter_flops(layer, batch) / comm


def choose_strategy(layer: LayerSpec, batch: int, p: int,
                    group_sizes: Sequence[int] | None = None,
                    bytes_per_elem: float = 4.0) -> StrategyChoice:
    """Pick the node-group size maximizing the C2C ratio for this layer.

    This is the paper's 'choosing the right work partitioning strategy':
    evaluated per layer, because conv-like layers (small weights, large
    activations) prefer data parallelism while FC-like layers (large weights,
    small activations) prefer model/hybrid parallelism.
    """
    if group_sizes is None:
        group_sizes = [g for g in (1, 2, 4, 8, 16, 32) if g <= p and p % g == 0]
    best_g, best_r = 1, -1.0
    for g in group_sizes:
        r = hybrid_ratio(layer, batch, p, g, bytes_per_elem)
        if r > best_r:
            best_g, best_r = g, r
    if best_g == 1:
        strat = Strategy.DATA
    elif best_g == p:
        strat = Strategy.MODEL
    else:
        strat = Strategy.HYBRID
    flops = _iter_flops(layer, batch)
    comm = flops / best_r if best_r not in (0.0, math.inf) else 0.0
    return StrategyChoice(strategy=strat, group_size=best_g, ratio=best_r,
                          comm_bytes=comm)


# --- convenience constructors ------------------------------------------------

def conv_layer(name: str, cin: int, cout: int, k: int, h_out: int, w_out: int,
               stride: int = 1) -> LayerSpec:
    del stride  # the ratio does not depend on it -- kept to document the claim
    flops = 2.0 * cin * cout * k * k * h_out * w_out
    return LayerSpec(name=name, kind=LayerKind.CONV,
                     weight_elems=float(cin * cout * k * k),
                     out_elems_per_sample=float(h_out * w_out * cout),
                     flops_fwd_per_sample=flops)


def fc_layer(name: str, din: int, dout: int, seq: int = 1) -> LayerSpec:
    flops = 2.0 * din * dout * seq
    return LayerSpec(name=name, kind=LayerKind.FC,
                     weight_elems=float(din * dout),
                     out_elems_per_sample=float(dout * seq),
                     flops_fwd_per_sample=flops)


def attention_layer(name: str, d_model: int, n_heads: int, head_dim: int,
                    n_kv: int, seq: int) -> LayerSpec:
    proj_w = d_model * (n_heads * head_dim + 2 * n_kv * head_dim
                        + n_heads * head_dim)
    proj_flops = 2.0 * seq * proj_w
    score_flops = 2.0 * 2.0 * seq * seq * n_heads * head_dim * 0.5  # causal
    return LayerSpec(name=name, kind=LayerKind.ATTENTION,
                     weight_elems=float(proj_w),
                     out_elems_per_sample=float(seq * d_model),
                     flops_fwd_per_sample=proj_flops + score_flops)


def mlp_layer(name: str, d_model: int, d_ff: int, seq: int,
              gated: bool = True) -> LayerSpec:
    n_mats = 3 if gated else 2
    w = n_mats * d_model * d_ff
    return LayerSpec(name=name, kind=LayerKind.FC,
                     weight_elems=float(w),
                     out_elems_per_sample=float(seq * d_model),
                     flops_fwd_per_sample=2.0 * seq * w)


def moe_layer(name: str, d_model: int, d_ff: int, n_experts: int, top_k: int,
              seq: int, gated: bool = True) -> LayerSpec:
    n_mats = 3 if gated else 2
    w = n_experts * n_mats * d_model * d_ff
    active = top_k * n_mats * d_model * d_ff
    return LayerSpec(name=name, kind=LayerKind.MOE,
                     weight_elems=float(w),
                     out_elems_per_sample=float(seq * d_model),
                     flops_fwd_per_sample=2.0 * seq * active)


def ssm_layer(name: str, d_model: int, d_inner: int, d_state: int,
              seq: int) -> LayerSpec:
    w = d_model * 2 * d_inner + d_inner * d_model
    flops = 2.0 * seq * w + 2.0 * seq * d_inner * d_state * 2
    return LayerSpec(name=name, kind=LayerKind.SSM,
                     weight_elems=float(w),
                     out_elems_per_sample=float(seq * d_model),
                     flops_fwd_per_sample=flops)


def embed_layer(name: str, vocab: int, d_model: int, seq: int) -> LayerSpec:
    return LayerSpec(name=name, kind=LayerKind.EMBED,
                     weight_elems=float(vocab * d_model),
                     out_elems_per_sample=float(seq * d_model),
                     flops_fwd_per_sample=0.0)


# --- whole-model layer lists (the analysis→execution bridge) -----------------

def block_layer(name: str, kind: str, cfg, seq: int,
                repeats: int = 1) -> LayerSpec:
    """One LayerSpec for a whole transformer block (mixer + MLP).

    `cfg` is a ModelConfig (configs/base.py); `kind` one of its block
    kinds. out_elems_per_sample counts BOTH residual-stream outputs (the
    mixer's and the MLP's) — i.e. the two activation psums an executed
    head/feature-sharded block exchanges per forward pass. `repeats` scales
    weights/activations/flops for stacked (scanned) pattern positions; the
    C2C ratios are invariant to it (every term scales by the same factor)
    but per-iteration comm totals need it.
    """
    d = cfg.d_model
    mlp_part = None
    if kind != "ssm" and kind != "moe":
        mlp_part = mlp_layer(name, d, cfg.d_ff, seq, gated=cfg.mlp_gated)
    if kind in ("attn", "local", "enc"):
        a = cfg.attn
        mix = attention_layer(name, d, a.n_heads, a.head_dim, a.n_kv, seq)
        kindk = LayerKind.ATTENTION
    elif kind == "cross":
        # self-attention + cross-attention: two attention stacks' weights
        a = cfg.attn
        one = attention_layer(name, d, a.n_heads, a.head_dim, a.n_kv, seq)
        mix = dataclasses.replace(
            one, weight_elems=2.0 * one.weight_elems,
            out_elems_per_sample=2.0 * one.out_elems_per_sample,
            flops_fwd_per_sample=2.0 * one.flops_fwd_per_sample)
        kindk = LayerKind.ATTENTION
    elif kind == "mla":
        m = getattr(cfg, "mla", None)
        w = (d * m.q_lora_rank
             + m.q_lora_rank * m.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
             + d * (m.kv_lora_rank + m.qk_rope_dim)
             + m.kv_lora_rank * m.n_heads * (m.qk_nope_dim + m.v_head_dim)
             + m.n_heads * m.v_head_dim * d)
        score = 2.0 * 2.0 * seq * seq * m.n_heads \
            * (m.qk_nope_dim + m.qk_rope_dim) * 0.5
        mix = LayerSpec(name=name, kind=LayerKind.ATTENTION,
                        weight_elems=float(w),
                        out_elems_per_sample=float(seq * d),
                        flops_fwd_per_sample=2.0 * seq * w + score)
        kindk = LayerKind.ATTENTION
    elif kind == "moe":
        a = cfg.attn
        attn = attention_layer(name, d, a.n_heads, a.head_dim, a.n_kv, seq)
        m = getattr(cfg, "moe", None)
        moe = moe_layer(name, d, m.d_ff, m.n_experts, m.top_k, seq,
                        gated=cfg.mlp_gated)
        mix = LayerSpec(
            name=name, kind=LayerKind.MOE,
            weight_elems=attn.weight_elems + moe.weight_elems,
            out_elems_per_sample=attn.out_elems_per_sample
            + moe.out_elems_per_sample,
            flops_fwd_per_sample=attn.flops_fwd_per_sample
            + moe.flops_fwd_per_sample)
        kindk = LayerKind.MOE
    elif kind == "ssm":
        s = getattr(cfg, "ssm", None)
        mix = ssm_layer(name, d, s.expand * d, s.d_state, seq)
        kindk = LayerKind.SSM
    elif kind == "rglru":
        r = getattr(cfg, "rglru", None)
        w = 2.0 * d * r.lru_width + r.lru_width * d + 3.0 * r.lru_width
        mix = LayerSpec(name=name, kind=LayerKind.SSM,
                        weight_elems=float(w),
                        out_elems_per_sample=float(seq * d),
                        flops_fwd_per_sample=2.0 * seq * w)
        kindk = LayerKind.SSM
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    w = mix.weight_elems + (mlp_part.weight_elems if mlp_part else 0.0)
    o = mix.out_elems_per_sample \
        + (mlp_part.out_elems_per_sample if mlp_part else 0.0)
    f = mix.flops_fwd_per_sample \
        + (mlp_part.flops_fwd_per_sample if mlp_part else 0.0)
    return LayerSpec(name=name, kind=kindk, weight_elems=w * repeats,
                     out_elems_per_sample=o * repeats,
                     flops_fwd_per_sample=f * repeats)


def layers_from_model_config(cfg, seq: int) -> list[LayerSpec]:
    """Per-layer LayerSpecs for a transformer ModelConfig, named after the
    parameter-tree keys (`embed`, `p{i}_{kind}` stacked pattern positions,
    `t{i}_{kind}` tail blocks, `head`) so per-layer strategy verdicts map
    1:1 onto parameter subtrees — planner.plan_hybrid consumes this to turn
    the chooser's table into an executed sharding."""
    out = [embed_layer("embed", cfg.vocab, cfg.d_model, seq)]
    reps = cfg.pattern_repeats
    if reps > 0:
        for i, kind in enumerate(cfg.block_pattern):
            out.append(block_layer(f"p{i}_{kind}", kind, cfg, seq,
                                   repeats=reps))
    for i, kind in enumerate(cfg.tail_layers):
        out.append(block_layer(f"t{i}_{kind}", kind, cfg, seq))
    if not cfg.tie_embeddings:
        out.append(fc_layer("head", cfg.d_model, cfg.vocab, seq))
    return out


# --- iteration-level summaries (used by simulator calibration) ---------------

def exposed_comm_upper_bound(layers: Sequence[LayerSpec], batch: int, p: int,
                             link: hw.Link,
                             bytes_per_elem: float = 4.0) -> float:
    """Sum of allreduce times with zero overlap (the BLOCKING policy bound)."""
    total = 0.0
    for l in layers:
        nbytes = l.weight_elems * bytes_per_elem
        total += hw.ring_allreduce_time(nbytes, p, link)
    return total
