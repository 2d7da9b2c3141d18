"""The port's example twins (`examples/*_torch.py`) on the CPU at their
smallest settings, against the reference's examples where both can run the
same weights:

  * `train_lm_torch.py --steps 3` on the mlsl int8 + EF wire and
    `train_lm.py` with the same arguments, in this process, the port's
    `Model.init` giving the reference's initial parameters: the presets are
    equal, the step losses agree (step 0 to the printed four decimals,
    step 2 at the int8 wire's rtol 1e-3, PERF.md section 2) and fall, and
    the two checkpoints hold the same leaves, each parameter within the
    bound AdamW's normalised step sets (`_adam_bound`), and at most 1e-4
    of all the elements more than 1e-4 apart (test_torch_mp's share rule,
    over the whole tree: a leaf of 512 cannot hold a share of 1e-4). Only
    an element at a code's edge or with a near-zero gradient moves so far
    (6 of 1.3 M here); a wrong schedule, optimizer or data moves most;
  * `serve_batched_torch.py` and `serve_batched.py` on the reference's
    weights: the same requests (prompt and token counts from the numpy
    seed) and the same greedy tokens;
  * `hybrid_parallelism_demo_torch.py --device cpu`, in a subprocess:
    parts 1-3 (the C2C tables, the prioritization simulation, the executed
    hybrid plan) print the reference demo's lines exactly; part 4 trains 3
    steps on 8 gloo ranks with the reference's specs, its loss falling
    each step as the reference's does (its 8 spawned ranks draw their own
    weights, so the values are not compared).
"""

import math
import os
import pathlib
import runpy
import subprocess
import sys

import jax
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.models.transformer import Model as TModel
from repro_torch.optim import schedules as tsched

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script: str, *args, timeout: float = 120, blocked: bool = True,
         env_extra=None) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    if blocked:
        code = ("import runpy, sys\n"
                "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
                f"sys.argv = [{script!r}, *{list(args)!r}]\n"
                f"runpy.run_path({script!r}, run_name='__main__')\n")
        cmd = [sys.executable, "-c", code]
    else:
        cmd = [sys.executable, script, *args]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.splitlines()


def _example(path: str) -> dict:
    """The example's module namespace, its `main` not run."""
    return runpy.run_path(str(ROOT / path), run_name="example")


def _init_from_reference(monkeypatch, jcfg):
    """Make the port's `Model.init` return the reference's initial
    parameters of `jcfg` (`jax.random.PRNGKey(0)`, as its examples draw)."""
    want = jax.tree_util.tree_map(
        np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(TModel, "init", lambda self, generator, device:
                        convert.params_from_jax(want, device=device))


def _run_main(monkeypatch, capsys, main, argv, *, pass_argv: bool) -> list:
    monkeypatch.setattr(sys, "argv", ["example", *argv])
    main(argv) if pass_argv else main()
    return capsys.readouterr().out.splitlines()


def _adam_bound(lrs, b1: float = 0.9, b2: float = 0.95) -> float:
    """How far apart two AdamW runs from the same parameters can leave an
    element: each step moves it by lr_t times its bias-corrected m/sqrt(v),
    whose size Cauchy-Schwarz bounds by
    (1-b1)/(1-b1^t) * sqrt((1-b2^t)/(1-b2) * sum_k<t (b1^2/b2)^k),
    1.0 at step 1 and 1.001 at step 3; two runs whose gradients differ (the
    int8 wire rounds an element at a code's edge the other way) move it at
    most twice that apart a step. Weight decay adds lr * 0.1 of the
    difference, under 1e-3 of it here."""
    total = 0.0
    for t, lr in enumerate(lrs, start=1):
        geo = sum((b1 * b1 / b2) ** k for k in range(t))
        total += lr * (1 - b1) / (1 - b1 ** t) * math.sqrt(
            (1 - b2 ** t) / (1 - b2) * geo)
    return 2 * total * 1.001


def test_train_lm_twin(monkeypatch, capsys, tmp_path):
    ref, twin = _example("examples/train_lm.py"), _example(
        "examples/train_lm_torch.py")
    assert twin["PRESETS"] == ref["PRESETS"]
    _init_from_reference(monkeypatch, ref["build_config"](ref["PRESETS"]["tiny"]))
    args = ["--steps", "3", "--comm", "mlsl", "--wire", "int8",
            "--error-feedback"]
    want = _run_main(monkeypatch, capsys, ref["main"],
                     [*args, "--ckpt", str(tmp_path / "ref")], pass_argv=False)
    got = _run_main(monkeypatch, capsys, twin["main"],
                    [*args, "--ckpt", str(tmp_path / "port"), "--device",
                     "cpu"], pass_argv=True)
    assert got[0] == want[0] + " device=cpu"
    steps = [[l.split() for l in out if l.startswith("step")]
             for out in (want, got)]
    assert [s[1] for s in steps[0]] == [s[1] for s in steps[1]] == ["0", "2"]
    (w0, w2), (g0, g2) = ([float(s[3]) for s in st] for st in steps)
    assert abs(g0 - w0) <= 1e-4 and abs(g2 - w2) <= 1e-3 * w2, (w0, w2, g0, g2)
    assert g2 < g0 and w2 < w0
    assert got[-1] == f"saved checkpoint to {tmp_path / 'port'}"
    assert ckpt.latest_step(str(tmp_path / "port")) == 3
    lr = tsched.warmup_cosine(3e-3, 0, 3)
    bound = _adam_bound([float(lr(i)) for i in range(3)])
    with np.load(tmp_path / "ref" / "payload.npz") as a, \
            np.load(tmp_path / "port" / "payload.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        diffs = {k: np.abs(a[k] - b[k]) for k in a.files}
    for k, diff in diffs.items():
        assert diff.max() <= bound, (k, float(diff.max()), bound)
    moved = sum(int((d > 1e-4).sum()) for d in diffs.values())
    size = sum(d.size for d in diffs.values())
    assert moved <= 1e-4 * size, (moved, size)


def test_serve_batched_twin(monkeypatch, capsys):
    ref, twin = _example("examples/serve_batched.py"), _example(
        "examples/serve_batched_torch.py")
    _init_from_reference(monkeypatch, jreg.get_smoke_config("mamba2-2.7b"))
    want = _run_main(monkeypatch, capsys, ref["main"], [], pass_argv=False)
    got = _run_main(monkeypatch, capsys, twin["main"], ["--device", "cpu"],
                    pass_argv=True)
    reqs = [[l for l in out if l.startswith("req")] for out in (want, got)]
    assert len(reqs[1]) == 6 and reqs[1] == reqs[0]
    assert got[-1].startswith(want[-1].split()[0] + " tokens in ")


def test_hybrid_demo_twin():
    """Parts 1-3 equal the reference demo's output line for line (the
    reference also runs its part 4, on 8 virtual devices, in seconds)."""
    ref = _run("examples/hybrid_parallelism_demo.py", blocked=False,
               env_extra={"JAX_PLATFORMS": "cpu"})
    out = _run("examples/hybrid_parallelism_demo_torch.py", "--device",
               "cpu")
    head = out.index(next(l for l in out if l.startswith("=== 4.")))
    assert head > 15 and out[:head] == ref[:head]
    assert out[head] == "=== 4. hybrid training on 8 ranks (cpu) ==="
    assert out[head + 1:head + 4] == [
        "   wq   -> (None, None, 'local')", "   wo   -> (None, 'local', None)",
        "   embed-> (None, None)"]
    steps = [l.split() for l in out if l.startswith("   step")]
    assert [int(s[1]) for s in steps] == [0, 1, 2]
    losses = [float(s[3]) for s in steps]
    assert all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2]
    assert torch.isfinite(torch.tensor([float(s[5]) for s in steps])).all()
