"""minicpm3-4b (multi-head latent attention) against the JAX reference on
the same weights and the same numpy inputs, at its smoke config, f32 on the
CPU, through tests/torch_archs_suite.py's per-architecture tests (their
tolerances there); and MLA's absorbed-projection decode against its full
apply.
"""

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn

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

ARCHS = torch_archs_ranks.MLA


def test_mla_absorbed_decode_matches_full_apply():
    """MLA's absorbed-projection decode on the latent cache, token by token
    from an empty cache, against `mla_apply` over the whole sequence
    (atol 1e-5, f32), also with a ring of 8 slots for a window of 8."""
    m = treg.get_smoke_config("minicpm3-4b").mla
    rng = np.random.default_rng(10)
    defs = tattn.mla_defs(64, m, torch.float32)
    p = tree_lib.tree_map(lambda pd: torch.from_numpy(
        (rng.standard_normal(pd.shape) * 0.3).astype(np.float32)), defs)
    x = torch.from_numpy(rng.standard_normal((2, 20, 64)).astype(np.float32))
    for window in (None, 8):
        full = tattn.mla_apply(p, x, m, window=window)
        cache = tattn.mla_init_cache(2, 24, m, torch.float32, window=window)
        steps = [tattn.mla_decode(p, x[:, i:i + 1], cache, i, m,
                                  window=window)[0] for i in range(20)]
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                                   rtol=0, atol=1e-5)
