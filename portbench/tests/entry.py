"""A rank of a benchmark run on the CPU at the cells' small test sizes,
for the tests: the harness without its look for a chip. With
PORTBENCH_TEST_FAULT set (it reaches the ranks this one starts), the
timed path is broken underneath:

  unchanged   the optimizer's update returns the state as it was
  half_batch  each step is handed half of its batch's rows
  no_exchange the gradient exchange is skipped: each rank keeps its own
  unchanged_rank1  rank 1's update alone returns the state as it was
  jax_rank1   rank 1 holds a module named `repro` (the JAX package's name)
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench import harness  # noqa: E402

FAULTS = ("unchanged", "half_batch", "no_exchange", "unchanged_rank1",
          "jax_rank1")


def plant(fault, rank):
    import dataclasses
    import types

    from repro_torch.models.transformer import Batch
    from repro_torch.optim.optimizers import Optimizer

    if fault.endswith("_rank1"):
        fault = fault[:-len("_rank1")] if rank == 1 else None

    def hook(stage, obj):
        if fault == "jax" and stage == "step":
            sys.modules["repro"] = types.ModuleType("repro")
        if fault == "unchanged" and stage == "optimizer":
            return Optimizer(obj.init, lambda g, s, p, step, **kw: (p, s),
                             obj.state_bytes_per_param)
        if fault == "no_exchange" and stage == "comm":
            return dataclasses.replace(obj, skip_reduce=True)
        if fault == "half_batch" and stage == "step":
            def half(state, b):
                n = b.tokens.shape[0] // 2
                return obj(state, Batch(tokens=b.tokens[:n],
                                        labels=b.labels[:n]))
            return half
        return obj
    return hook


if __name__ == "__main__":
    fault = os.environ.get("PORTBENCH_TEST_FAULT")
    if fault is not None and fault not in FAULTS:
        raise SystemExit(f"unknown fault {fault!r}")
    rank = (int(sys.argv[sys.argv.index("--rank") + 1])
            if "--rank" in sys.argv else 0)
    sys.exit(harness.main(sys.argv[1:], device_type="cpu", cpu_sizes=True,
                          plant=plant(fault, rank) if fault else None))
