"""Spawn a group of gloo ranks for the port's multi-rank tests.

`spawn(script, world, *args)` starts `python script RANK WORLD *args` once
per rank with PYTHONPATH on the port's sources, one thread per rank, and
waits for all of them; it fails with every rank's output if one failed.
Torch only: the rank bodies never import JAX.
"""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def spawn(script: str, world: int, *args, timeout: float = 300) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    path = str(ROOT / "tests" / script)
    procs = [subprocess.Popen(
        [sys.executable, path, str(r), str(world), *map(str, args)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {r} (rc {p.returncode})\n{log[-4000:]}"
        for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode)
