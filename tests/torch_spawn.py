"""Spawn a group of gloo ranks for the port's multi-rank tests.

`spawn(script, world, *args, timeout=)` starts `python script RANK WORLD
*args` once per rank with PYTHONPATH on the port's sources and gives the
whole group `timeout` seconds. It fails if a rank failed or was still
running then (it is killed), naming each rank's state, with the last
lines of those ranks' output: each rank writes to a file of its own, so
the output of a rank that hangs is there to read. Torch only: the rank
bodies never import JAX.
"""

import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def spawn(script: str, world: int, *args, timeout: float) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    path = str(ROOT / "tests" / script)
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, path, str(r), str(world), *map(str, args)], env=env,
        stdout=log, stderr=subprocess.STDOUT, text=True)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        running = [r for r, p in enumerate(procs) if p.poll() is None]
        for r in running:
            procs[r].kill()
            procs[r].wait()
    state = [f"running after {timeout} s" if r in running
             else f"rc {p.returncode}" for r, p in enumerate(procs)]
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-4000:])
        log.close()
    assert not any(p.returncode for p in procs), f"{script}: " + "; ".join(
        f"rank {r} {s}" for r, s in enumerate(state)) + "".join(
        f"\n--- rank {r} ({state[r]})\n{tails[r]}"
        for r, p in enumerate(procs) if p.returncode)
