"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks + local attention in
a 2:1 pattern, MQA (kv=1), GeGLU MLP [arXiv:2402.19427]."""

from repro_torch.configs.base import AttnConfig, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid", n_layers=26, d_model=2560,
    vocab=256000, block_pattern=("rglru", "rglru", "local"), d_ff=7680,
    mlp_act="gelu_tanh", mlp_gated=True,
    attn=AttnConfig(n_heads=10, n_kv=1, head_dim=256, window=2048),
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    tie_embeddings=True, embed_scale=True, logit_softcap=30.0,
    source="arXiv:2402.19427",
)
