"""Readings from which a cell's limits are set, on the cell's own chips
and at its own sizes: the program's sound runs over many seeds (each
through the cell's check steps on a fresh state of the same step
function, against the reference), and on fewer seeds the reference put in
the program's place in lower precision (the control, "fp8") or broken
("half_batch", and on more than one chip "no_exchange"). One line of JSON
a reading on standard output; with --out, the same lines in that file.

    python3 portbench/calibrate.py --workload <cell> --seeds 1-12 \
        --variant-seeds 1-3 [--variants fp8,half_batch,no_exchange]
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench import cells, harness, readings  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None, *, device_type: str = "cuda", cpu_sizes: bool = False):
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--variant-seeds", type=seeds, default=[])
    p.add_argument("--variants", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--one-process", action="store_true",
                   help="only the variants, every rank's rows in this "
                        "process on one chip (no program)")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = p.parse_args(argv)
    cell = cells.load_cell(opts.workload, cpu_sizes=cpu_sizes)
    cfg = cells.load_config(cell["config"], cpu_sizes=cpu_sizes)
    world = 1 if opts.one_process else cell["chips"]
    variants = (opts.variants.split(",") if opts.variants else
                ["fp8", "half_batch"] + (["no_exchange"] if cell["chips"] > 1
                                         else []))
    for var, sub in harness.CACHE_DIRS.items():
        os.environ[var] = str(cells.ROOT / "build" / "portbench" / sub)
    out = open(opts.out, "a") if opts.out and opts.rank == 0 else None

    def emit(rec):
        if opts.rank == 0:
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

    try:
        with harness.other_ranks(argv, opts, world) as procs:
            if opts.one_process:
                return _variants_alone(cell, cfg, opts.variant_seeds,
                                       variants, device_type, emit)
            r = harness.Rank(opts, cell, cfg, device_type)
            emit({"cell": cell["name"], "setup_s": time.monotonic() - T0})
            for seed in sorted(set(opts.seeds) | set(opts.variant_seeds)):
                t = time.monotonic()
                state, prog, failed, _ = r.check_steps(seed)
                del state
                r.free()
                t_prog = time.monotonic() - t
                ref = r.reference(seed)
                t_ref = time.monotonic() - t - t_prog
                if seed in opts.seeds:
                    emit({"seed": seed, "run": "program", "failed": failed,
                          **readings.compare(prog, ref),
                          "loss": prog["loss"],
                          "worst": readings.worst_leaves(prog, ref),
                          "ref_loss": ref["loss"], "program_s": t_prog,
                          "reference_s": t_ref})
                if seed in opts.variant_seeds:
                    for v in variants:
                        t = time.monotonic()
                        alt = r.reference(seed, v)
                        emit({"seed": seed, "run": v,
                              **readings.compare(alt, ref),
                              "loss": alt["loss"],
                              "worst": readings.worst_leaves(alt, ref),
                              "seconds": time.monotonic() - t})
                r.free()
            r.close()
    finally:
        if out:
            out.close()
    return 1 if any(p.returncode for p in procs) else 0


def _variants_alone(cell, cfg, seeds, variants, device_type, emit) -> int:
    """The variants against the reference, all ranks' rows in this one
    process."""
    import torch

    from portbench.reference import train as ref_train
    dev = torch.device("cuda", 0) if device_type == "cuda" else "cpu"
    for seed in seeds:
        t = time.monotonic()
        ref = ref_train.follow(cfg, cell, seed, dev)
        emit({"seed": seed, "run": "reference", "loss": ref["loss"],
              "seconds": time.monotonic() - t})
        for v in variants:
            t = time.monotonic()
            alt = ref_train.follow(cfg, cell, seed, dev, variant=v)
            emit({"seed": seed, "run": v, **readings.compare(alt, ref),
                  "loss": alt["loss"],
                  "worst": readings.worst_leaves(alt, ref),
                  "seconds": time.monotonic() - t})
            del alt
            if device_type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
