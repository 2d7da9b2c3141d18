"""Config system: architecture configuration dataclasses.

Ports `repro/configs/base.py` with torch dtypes. Every ported architecture
is a `ModelConfig` in repro_torch/configs/<id>.py; the registry
(repro_torch.configs.registry) resolves `--arch <id>` strings. The dry-run
(`launch/dryrun.py`) reads `supports_long_decode`, `is_native_long` and
`active_param_count_estimate`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 1e4
    rotary_frac: float = 1.0       # fraction of head_dim rotated
    window: Optional[int] = None   # native sliding window
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    rope_theta: float = 1e4


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0     # Arctic: parallel dense MLP of this width
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block."""

    lru_width: int
    conv_width: int = 4
    c_constant: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder consuming precomputed frame embeddings (the
    conv + mel frontend is a stub, as in the reference)."""

    n_layers: int
    n_frames: int = 1500
    d_input: int = 768             # frontend output dim (== d_model for whisper)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # cycled over layers: attn | mla | moe | ssm | rglru | local | cross
    block_pattern: Tuple[str, ...]
    d_ff: int = 0
    mlp_act: str = "silu"
    mlp_gated: bool = True
    attn: Optional[AttnConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vlm_img_tokens: int = 0        # >0: prepend this many projected patch embeds
    vlm_d_vision: int = 1024
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    learned_positions: int = 0     # >0 (whisper): learned abs positions
    embed_scale: bool = False      # multiply embeddings by sqrt(d)
    logit_softcap: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # long-context serving variant: full-attention archs get a sliding-window
    # attention cache of this size (Engine(long_context=True))
    long_context_window: int = 4096
    source: str = ""               # citation

    @property
    def pattern_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_layers(self) -> Tuple[str, ...]:
        r = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    @property
    def supports_long_decode(self) -> bool:
        """True if a 524k-token decode has bounded per-step state."""
        if self.encoder is not None:
            return False           # enc-dec full attention (whisper): skipped
        return True                # SSM/hybrid native; dense via SWA variant

    @property
    def is_native_long(self) -> bool:
        kinds = set(self.block_pattern)
        if kinds <= {"ssm", "rglru", "local"}:
            return True
        return (self.attn is not None and self.attn.window is not None
                and "attn" not in self.block_pattern)


def reduce_for_smoke(cfg: ModelConfig, *, d_model: int = 256,
                     n_layers: int | None = None, vocab: int = 512,
                     d_ff: int = 512, n_experts: int = 4) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 layers, d<=512),
    the reference's `reduce_for_smoke` for the ported block kinds."""
    n_layers = n_layers if n_layers is not None else min(
        2 * len(cfg.block_pattern), max(2, len(cfg.block_pattern)))
    kw = {}
    if cfg.attn is not None:
        n_heads = max(2, min(4, cfg.attn.n_heads))
        n_kv = max(1, min(cfg.attn.n_kv, n_heads))
        window = None if cfg.attn.window is None else 64
        kw["attn"] = dataclasses.replace(cfg.attn, n_heads=n_heads, n_kv=n_kv,
                                         head_dim=32, window=window)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, n_heads=4, q_lora_rank=64,
                                        kv_lora_rank=32, qk_nope_dim=16,
                                        qk_rope_dim=8, v_head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=n_experts, top_k=min(cfg.moe.top_k, 2),
            d_ff=d_ff // 2,
            dense_residual_ff=(d_ff // 2 if cfg.moe.dense_residual_ff else 0))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk=16)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=d_model)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2,
                                            n_frames=16, d_input=d_model)
    if cfg.vlm_img_tokens:
        kw["vlm_img_tokens"] = 8
        kw["vlm_d_vision"] = 64
    if cfg.learned_positions:
        kw["learned_positions"] = 4096
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", d_model=d_model, n_layers=n_layers,
        vocab=vocab, d_ff=d_ff, dtype=torch.float32, remat=False,
        long_context_window=64, **kw)


def param_count_estimate(cfg: ModelConfig) -> float:
    """Rough N for FSDP decisions and 6ND math (the exact count comes from
    the parameter definitions): the reference's terms for the ported
    kinds (its rglru term leaves out the block's MLP and its w_a/w_i, as
    the reference's does)."""
    d = cfg.d_model
    n = 2.0 * cfg.vocab * d
    for i in range(cfg.n_layers):
        k = cfg.layer_kind(i)
        if k in ("attn", "local"):
            a = cfg.attn
            n += d * (a.n_heads + 2 * a.n_kv + a.n_heads) * a.head_dim
            n += (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        elif k == "mla":
            m = cfg.mla
            n += (d * m.q_lora_rank
                  + m.q_lora_rank * m.n_heads * (m.qk_nope_dim
                                                 + m.qk_rope_dim))
            n += d * (m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * m.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += m.n_heads * m.v_head_dim * d
            n += (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        elif k == "moe":
            a = cfg.attn
            n += d * (a.n_heads + 2 * a.n_kv + a.n_heads) * a.head_dim
            n += (cfg.moe.n_experts * 3 * d * cfg.moe.d_ff
                  + d * cfg.moe.n_experts)
            n += 3 * d * cfg.moe.dense_residual_ff
        elif k == "ssm":
            s = cfg.ssm
            d_in = s.expand * d
            n += d * (2 * d_in + 2 * s.n_groups * s.d_state
                      + d_in // s.head_dim)
            n += d_in * d
        elif k == "rglru":
            r = cfg.rglru
            n += 2 * d * r.lru_width + r.lru_width * d + 3 * r.lru_width
    if cfg.encoder is not None:
        a = cfg.attn
        per = d * 4 * a.n_heads * a.head_dim + 2 * d * cfg.d_ff
        n += cfg.encoder.n_layers * per
        # decoder cross-attention
        n += cfg.n_layers * d * 4 * a.n_heads * a.head_dim
    return float(n)


def active_param_count_estimate(cfg: ModelConfig) -> float:
    """Active params per token (MoE: top_k of n_experts)."""
    if cfg.moe is None:
        return param_count_estimate(cfg)
    full = param_count_estimate(cfg)
    moe_layers = sum(1 for i in range(cfg.n_layers)
                     if cfg.layer_kind(i) == "moe")
    all_experts = (moe_layers * cfg.moe.n_experts * 3 * cfg.d_model
                   * cfg.moe.d_ff)
    active = moe_layers * cfg.moe.top_k * 3 * cfg.d_model * cfg.moe.d_ff
    return float(full - all_experts + active)
