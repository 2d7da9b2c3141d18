"""Snowflake Arctic (480B): dense-MoE hybrid -- 128-expert top-2 MoE with a
parallel dense residual MLP per layer [hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.configs.base import AttnConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe", n_layers=35, d_model=7168,
    vocab=32000, block_pattern=("moe",), d_ff=4864, mlp_act="silu",
    attn=AttnConfig(n_heads=56, n_kv=8, head_dim=128),
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, capacity_factor=1.25,
                  dense_residual_ff=4864),
    source="hf:Snowflake/snowflake-arctic-base",
)
