"""Mamba2-2.7B: attention-free SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", arch_type="ssm", n_layers=64, d_model=2560,
    vocab=50280, block_pattern=("ssm",), d_ff=0,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True, source="arXiv:2405.21060",
)
