"""Whisper-small: encoder-decoder with the conv/mel frontend as a stub
[arXiv:2212.04356].

The model takes precomputed frame embeddings (B, 1500, 768), as the
reference does. The decoder uses learned positions; the table is sized to
32768 positions (the reference's choice) rather than Whisper's native 448.
"""

from repro_torch.configs.base import AttnConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", arch_type="audio", n_layers=12, d_model=768,
    vocab=51865, block_pattern=("cross",), d_ff=3072, mlp_act="gelu",
    mlp_gated=False, norm="layernorm", norm_eps=1e-5,
    attn=AttnConfig(n_heads=12, n_kv=12, head_dim=64),
    encoder=EncoderConfig(n_layers=12, n_frames=1500, d_input=768),
    learned_positions=32768, tie_embeddings=True,
    source="arXiv:2212.04356",
)
