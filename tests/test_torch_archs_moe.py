"""The MoE architectures of the port against the JAX reference on the same
weights and the same numpy inputs: grok-1-314b (moe blocks: 4 experts
top-2 at the smoke size, the tanh GELU, scaled embeddings, soft-capped
logits) and arctic-480b (moe blocks with the dense residual MLP), each at
its smoke config, f32 on the CPU, through tests/torch_archs_suite.py's
per-architecture tests (their tolerances there). The losses carry the
routers' aux term; a prefill routes the prompt's B*S tokens together and a
decode step its B tokens, each at its own capacity, as the reference's
paths do.
"""

import torch_archs_ranks
from torch_archs_suite import (  # noqa: F401 (collected here for ARCHS)
    models, pytest_generate_tests, ranks8, test_decode_matches_forward,
    test_eight_gloo_ranks_match_reference_on_mesh8,
    test_forward_logits_and_loss_match_reference,
    test_greedy_tokens_through_engine_match_reference,
    test_kv_chunk_matches_dense_and_reference,
    test_one_rank_train_losses_match_reference,
    test_params_from_jax_carries_every_leaf,
    test_prefill_and_teacher_forced_decode_match_reference,
    test_serve_cli_runs_on_cpu, test_train_cli_runs_on_cpu)

ARCHS = torch_archs_ranks.MOE
