"""Config system: architecture configuration dataclasses.

Ports `repro/configs/base.py` with torch dtypes. Every ported architecture
is a `ModelConfig` in repro_torch/configs/<id>.py; the registry
(repro_torch.configs.registry) resolves `--arch <id>` strings.
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
class ModelConfig:
    name: str
    arch_type: str                 # dense (the only ported type)
    n_layers: int
    d_model: int
    vocab: int
    block_pattern: Tuple[str, ...]  # cycled over layers: attn
    d_ff: int = 0
    mlp_act: str = "silu"
    mlp_gated: bool = True
    attn: Optional[AttnConfig] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
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


def reduce_for_smoke(cfg: ModelConfig, *, d_model: int = 256,
                     n_layers: int | None = None, vocab: int = 512,
                     d_ff: int = 512) -> ModelConfig:
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
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", d_model=d_model, n_layers=n_layers,
        vocab=vocab, d_ff=d_ff, dtype=torch.float32, remat=False,
        long_context_window=64, **kw)
