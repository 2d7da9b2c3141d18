"""LLaVA-NeXT (Mistral-7B backbone): VLM with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower (CLIP ViT-L/14-336) and the anyres tile packing are a stub,
as in the reference: the model takes precomputed patch embeddings (d 1024),
which the (real) projector maps into the LM. 576 base-tile tokens are used.
The backbone is Mistral-7B with its native 4096-token sliding window.
"""

from repro_torch.configs.base import AttnConfig, ModelConfig

N_IMG_TOKENS = 576

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", arch_type="vlm", n_layers=32, d_model=4096,
    vocab=32000, block_pattern=("attn",), d_ff=14336, mlp_act="silu",
    attn=AttnConfig(n_heads=32, n_kv=8, head_dim=128, rope_theta=1e6,
                    window=4096),
    vlm_img_tokens=N_IMG_TOKENS, vlm_d_vision=1024,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
