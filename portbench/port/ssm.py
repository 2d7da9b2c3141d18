"""The program's ModelConfig of a Mamba-2 language model, from the
configuration's published keys as the reference reads them."""

from __future__ import annotations

import torch

from portbench.reference import ssm


def model_config(cfg: dict):
    from repro_torch.configs import base

    if not cfg["rms_norm"] or cfg["d_intermediate"] or \
            not cfg["tie_embeddings"]:
        raise ValueError("the SSM reference models RMS norms, no MLP and "
                         "tied embeddings only")
    z = ssm.sizes(cfg)
    return base.ModelConfig(
        name=cfg["name"], arch_type="ssm", n_layers=z["L"], d_model=z["d"],
        vocab=z["V"], block_pattern=("ssm",), d_ff=0, norm="rmsnorm",
        norm_eps=z["eps"], tie_embeddings=True,
        dtype=getattr(torch, cfg["torch_dtype"]), remat=cfg["remat"],
        ssm=base.SSMConfig(d_state=z["N"], head_dim=z["P"],
                           expand=z["di"] // z["d"], conv_width=z["W"],
                           chunk=z["Q"], n_groups=z["G"]))
