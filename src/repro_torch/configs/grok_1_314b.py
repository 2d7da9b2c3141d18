"""Grok-1 (314B): 8-expert top-2 MoE decoder [hf:xai-org/grok-1]."""

from repro_torch.configs.base import AttnConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", arch_type="moe", n_layers=64, d_model=6144,
    vocab=131072, block_pattern=("moe",), d_ff=32768, mlp_act="gelu",
    attn=AttnConfig(n_heads=48, n_kv=8, head_dim=128),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768, capacity_factor=1.25),
    embed_scale=True, logit_softcap=30.0, source="hf:xai-org/grok-1",
)
