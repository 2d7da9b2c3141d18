"""ChatGLM3-6B: GQA (kv=2) with 2D/partial RoPE (half the head dims rotated)
[arXiv:2406.12793]."""

from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", arch_type="dense", n_layers=28, d_model=4096,
    vocab=65024, block_pattern=("attn",), d_ff=13696, mlp_act="silu",
    attn=AttnConfig(n_heads=32, n_kv=2, head_dim=128, rotary_frac=0.5),
    source="arXiv:2406.12793",
)
