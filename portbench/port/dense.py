"""The program's ModelConfig of a dense decoder of the llama layout, from
the configuration's published keys as the reference reads them."""

from __future__ import annotations

import torch

from portbench.reference import dense


def model_config(cfg: dict):
    from repro_torch.configs import base

    if cfg["tie_word_embeddings"] or cfg["hidden_act"] != "silu":
        raise ValueError("the dense reference models an untied head and a "
                         "SiLU-gated MLP only")
    z = dense.sizes(cfg)
    return base.ModelConfig(
        name=cfg["name"], arch_type="dense", n_layers=z["L"], d_model=z["d"],
        vocab=z["V"], block_pattern=("attn",), d_ff=z["ff"], mlp_act="silu",
        mlp_gated=True, norm="rmsnorm", norm_eps=z["eps"],
        tie_embeddings=False, dtype=getattr(torch, cfg["torch_dtype"]),
        remat=cfg["remat"],
        attn=base.AttnConfig(n_heads=z["H"], n_kv=z["KV"], head_dim=z["hd"],
                             rope_theta=z["theta"]))
