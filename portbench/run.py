"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Runs the cell of `BENCHMARK.json` named
`--workload` on the chips it asks for (one process a chip) and prints one
JSON line last: correct, attempted, failed, metrics, device (and with
--trace 1 the breakdown). Exits non-zero, with no result, without CUDA,
with fewer cards than the cell asks for, or when JAX or the JAX package
was loaded.
"""

import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
