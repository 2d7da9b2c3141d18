"""The port stands alone: every module of repro_torch imports with JAX
blocked, and no source of the port (or chip_smoke.py, or an example twin
`examples/*_torch.py`) imports JAX or the JAX package; each example twin
runs its argument parser with both blocked."""

import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "repro_torch.kernels.quant8" in mods
    assert "repro_torch.train.trainer" in mods
    assert "repro_torch.core.api" in mods
    for m in ("launch.dryrun", "launch.roofline", "configs.shapes",
              "configs.cnn_tables"):
        assert f"repro_torch.{m}" in mods
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
            "sys.modules.items() if v is not None)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s)(?!_torch))", re.MULTILINE)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_example_twins_are_the_four():
    assert [p.name for p in EXAMPLES] == [
        "hybrid_parallelism_demo_torch.py", "quickstart_torch.py",
        "serve_batched_torch.py", "train_lm_torch.py"]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_twin_parses_its_arguments_without_jax(path):
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.argv = [{str(path)!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_path({str(path)!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
            "sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "--device" in proc.stdout


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.kernels import ops", "import repro.core.hw",
                 "    from repro import compat"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch.kernels", "from repro_torch import tree",
                 "# the reference uses jax.random"):
        assert not _FORBIDDEN.search(line), line


def test_stats_run_keeps_jax_out(tmp_path):
    """A CLI run with --stats writes its ledger through benchmarks/common.py
    (which imports JAX only inside `time_fn`) and leaves `jax` out of
    sys.modules; the reference package is blocked throughout."""
    code = ("import sys\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.launch import train\n"
            "train.main(['--device', 'cpu', '--comm', 'mlsl', '--wire', "
            "'int8', '--steps', '1', '--seq', '16', '--stats'])\n"
            "assert 'benchmarks.common' in sys.modules\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k in sys.modules)\n"
            "print('ok')\n")
    env = dict(os.environ, BENCH_DIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.rstrip().endswith("ok")
    assert os.listdir(tmp_path) == ["BENCH_torch_comm_stats.json"]
