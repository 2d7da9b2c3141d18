"""The slice as a whole: the port's mlsl int8 train step against the JAX
trainer on make_host_mesh(1, 1), on converted weights and the same data.

Three configurations: (a) the default planner, int8 + error feedback, two
microbatches; (b) dp_only, the same; (c) dp_only, int8 without error
feedback, one microbatch. The step-0 loss agrees within rtol 1e-5 (the same
weights, sums in another order); later losses within rtol 1e-4, because a
rounding tie can flip one int8 code, which moves one gradient element by one
scale step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import registry as jreg
from repro.core.planner import Planner as JPlanner
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt, schedules as jsched
from repro.train import trainer as jtr
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.core.planner import Planner as TPlanner
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.optim import optimizers as topt, schedules as tsched
from repro_torch.train import trainer as ttr

STEPS = 3
DATA = dict(seq_len=32, global_batch=8, seed=0)
CASES = {"a_default_ef_accum2": (False, True, 2),
         "b_dp_only_ef_accum2": (True, True, 2),
         "c_dp_only_int8_accum1": (True, False, 1)}


@pytest.fixture(scope="module")
def jax_params():
    jm = JModel(jreg.get_smoke_config("yi-6b"))
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0)))


def _jax_losses(params, dp_only, ef, accum):
    cfg = jreg.get_smoke_config("yi-6b")
    model = JModel(cfg)
    mesh = jmesh.make_host_mesh(1, 1)
    opt = jopt.adamw(jsched.warmup_cosine(3e-3, 1, STEPS))
    comm = jtr.CommConfig(mode="mlsl", wire="int8", error_feedback=ef,
                          accum_steps=accum)
    with compat.set_mesh(mesh):
        state = jtr.TrainState(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            opt_state=opt.init(jax.tree_util.tree_map(jnp.asarray, params)),
            step=jnp.zeros((), jnp.int32))
        step = jax.jit(jtr.make_train_step(
            model, opt, mesh, JPlanner(mesh=mesh, dp_only=dp_only), comm))
        losses = []
        for raw in jpipe.iterate(jpipe.DataConfig(vocab=cfg.vocab, **DATA),
                                 STEPS):
            state, m = step(state, JBatch(tokens=jnp.asarray(raw["tokens"]),
                                          labels=jnp.asarray(raw["labels"])))
            losses.append(float(m["loss"]))
    return losses


def _port_run(params, dp_only, ef, accum, overlap=False):
    cfg = treg.get_smoke_config("yi-6b")
    model = TModel(cfg)
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    opt = topt.adamw(tsched.warmup_cosine(3e-3, 1, STEPS))
    comm = ttr.CommConfig(wire="int8", error_feedback=ef, accum_steps=accum,
                          overlap=overlap)
    state = ttr.train_state_from_params(
        convert.params_from_jax(params, device="cpu"), opt)
    step = ttr.make_train_step(model, opt, mesh,
                               TPlanner(mesh=mesh, dp_only=dp_only), comm)
    losses = []
    for raw in tpipe.iterate(tpipe.DataConfig(vocab=cfg.vocab, **DATA), STEPS):
        state, m = step(state, TBatch(tokens=torch.from_numpy(raw["tokens"]),
                                      labels=torch.from_numpy(raw["labels"])))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_match_jax_trainer(jax_params, case):
    dp_only, ef, accum = CASES[case]
    want = _jax_losses(jax_params, dp_only, ef, accum)
    got, state = _port_run(jax_params, dp_only, ef, accum)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert state.step == STEPS
    assert (state.comm_residuals is not None) == ef


def test_overlap_equals_blocking_bitwise(jax_params):
    """The pipelined order reduces the same values with the same ops, so
    losses, parameters and residuals are bitwise the blocking order's."""
    l_block, s_block = _port_run(jax_params, True, True, 2, overlap=False)
    l_over, s_over = _port_run(jax_params, True, True, 2, overlap=True)
    assert l_block == l_over
    for a, b in zip(tree_lib.leaves(s_block.params),
                    tree_lib.leaves(s_over.params)):
        assert torch.equal(a, b)
    for a, b in zip(s_block.comm_residuals, s_over.comm_residuals):
        assert torch.equal(a, b)


def test_data_pipeline_copy_matches_reference():
    for kw in (dict(vocab=512, seq_len=32, global_batch=8, seed=0),
               dict(vocab=64000, seq_len=7, global_batch=4, seed=3)):
        for step in (0, 5):
            a = jpipe.batch_at(jpipe.DataConfig(**kw), step)
            b = tpipe.batch_at(tpipe.DataConfig(**kw), step)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_schedule_and_clip_match_reference():
    js = jsched.warmup_cosine(3e-3, 2, 10)
    ts = tsched.warmup_cosine(3e-3, 2, 10)
    for step in range(12):
        assert float(ts(step)) == pytest.approx(float(js(jnp.int32(step))),
                                                rel=1e-6)
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jc, jn = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                      1.0)
    tc, tn = topt.clip_by_global_norm(tree_lib.tree_map(torch.from_numpy, g),
                                      1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jc), tree_lib.leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_sgd_momentum_matches_reference():
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    g = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    jo = jopt.sgd_momentum(0.1, weight_decay=0.01, nesterov=True)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jo.init(jp)
    to = topt.sgd_momentum(0.1, weight_decay=0.01, nesterov=True)
    tp = tree_lib.tree_map(lambda a: torch.from_numpy(a.copy()), p)
    ts = to.init(tp)
    for step in range(3):
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jnp.int32(step))
        tp, ts = to.update(tree_lib.tree_map(torch.from_numpy, g), ts, tp,
                           step)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)


def test_cli_runs_on_cpu(capsys):
    rc = ttrain.main(["--arch", "yi-6b", "--comm", "mlsl", "--wire", "int8",
                      "--error-feedback", "--steps", "2", "--seq", "32",
                      "--log-every", "1", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--steps", "1"])


@pytest.mark.parametrize("flags", [["--comm", "gspmd"], ["--hier"],
                                   ["--hybrid"], ["--topo", "xeon-shm-10gbe"],
                                   ["--stats"], ["--trace", "out"],
                                   ["--telemetry", "out"]])
def test_cli_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttrain.main(flags + ["--device", "cpu", "--steps", "1"])
