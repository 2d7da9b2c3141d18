"""DeepSeek-7B: llama-arch MHA dense decoder [arXiv:2401.02954]."""

from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", arch_type="dense", n_layers=30, d_model=4096,
    vocab=102400, block_pattern=("attn",), d_ff=11008, mlp_act="silu",
    attn=AttnConfig(n_heads=32, n_kv=32, head_dim=128),
    source="arXiv:2401.02954",
)
