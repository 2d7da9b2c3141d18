"""Yi-6B: llama-arch GQA dense decoder [arXiv:2403.04652]."""

from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense", n_layers=32, d_model=4096, vocab=64000,
    block_pattern=("attn",), d_ff=11008, mlp_act="silu", mlp_gated=True,
    attn=AttnConfig(n_heads=32, n_kv=4, head_dim=128, rope_theta=5e6),
    source="arXiv:2403.04652",
)
