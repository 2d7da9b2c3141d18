"""MiniCPM3-4B: multi-head latent attention (MLA) dense decoder
[hf:openbmb/MiniCPM3-4B]."""

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", arch_type="dense", n_layers=62, d_model=2560,
    vocab=73448, block_pattern=("mla",), d_ff=6400, mlp_act="silu",
    mla=MLAConfig(n_heads=40, q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B",
)
