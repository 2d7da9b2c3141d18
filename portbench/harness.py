"""One run of a benchmark cell: set-up, the timed window, the traced steps
and the correctness check, on one rank a process.

Rank 0 is the process `run.py` starts; for a cell on more chips it starts
the other ranks as processes of the same script, which rendezvous with it
through a file store in a directory under the run's TMPDIR, and waits for
each before it prints. Rank 0 prints the run's one result line last on
standard output, after the compared numbers beside their limits on
standard error.

Set-up builds the cell's model, mesh, planner, CommConfig (all as the
cell's files state them), AdamW and the step that
`repro_torch.train.trainer.make_train_step` returns, on weights made on
the device from the seed, puts the cell's batches on the device, and
drives that step through the cell's check steps (the warm-up): their
losses, the first step's gradient as the optimizer holds it and the
parameters' change over them are each rank's readings. The window then
calls the same step on the same state for `--seconds`, each step ending in
`float(loss)`. With `--trace 1` the profiler records a few more steps
after the window. Last, with the program's state freed, the reference
follows the check steps from the seed on the same rows
(`reference/train.py`), each rank compares its readings with it, and the
worst rank's numbers decide `correct`."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

from portbench import cells, data, flops, readings, trace, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "CUDA_CACHE_PATH": "nv"}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    opts = p.parse_args(argv)
    opts.seed %= 2 ** 63
    return opts


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, *, t0: float | None = None, device_type: str = "cuda",
         cpu_sizes: bool = False, plant=None) -> int:
    """Runs one rank. `device_type` "cpu", `cpu_sizes` (the configuration's
    and cell's small CPU-test sizes) and `plant` (stage, object) ->
    object, which may replace the optimizer, the CommConfig or the step,
    are for the tests; the benchmark's own runs leave them."""
    t0 = time.monotonic() if t0 is None else t0
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse(argv)
    cell = cells.load_cell(opts.workload, cpu_sizes=cpu_sizes)
    cfg = cells.load_config(cell["config"], cpu_sizes=cpu_sizes)
    world = cell["chips"]
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(cells.ROOT / "build" / "portbench" / sub)
    with other_ranks(argv, opts, world) as procs:
        if device_type == "cuda":
            import torch
            if not torch.cuda.is_available():
                log("portbench: no CUDA device")
                return 2
            if torch.cuda.device_count() < world:
                log(f"portbench: the cell needs {world} CUDA devices, "
                    f"{torch.cuda.device_count()} found")
                return 2
        result, checks, found = run_rank(opts, cell, cfg, t0, device_type,
                                         plant)
    rcs = [p.returncode for p in procs]
    found = sorted(set(found) | set(loaded_forbidden()))
    if found:
        log(f"portbench: the run loaded {found}")
        return 3
    if opts.rank != 0:
        return 0
    if any(rcs):
        log(f"portbench: ranks exited with {rcs}")
        return 1
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


@contextlib.contextmanager
def other_ranks(argv: list, opts, world: int):
    """On rank 0, starts ranks 1 .. world-1 as processes of this same
    script with the same arguments, rendezvousing through a store
    directory under TMPDIR (made here unless `opts.store` names one); they
    start first, so that their imports overlap rank 0's. Yields the
    processes; afterwards waits for each (a rank that outlives its wait is
    killed) and removes the store it made."""
    own = opts.store is None
    if own:
        opts.store = tempfile.mkdtemp(prefix="portbench-")
    procs = []
    try:
        if opts.rank == 0:
            procs = [subprocess.Popen(
                [sys.executable, sys.argv[0], *argv, "--rank", str(r),
                 "--store", opts.store], stdout=subprocess.DEVNULL)
                for r in range(1, world)]
        yield procs
    finally:
        failing = sys.exc_info()[0] is not None
        for p in procs:
            _wait(p, timeout=30.0 if failing else 3000.0)
        if own:
            shutil.rmtree(opts.store, ignore_errors=True)


def _wait(proc: subprocess.Popen, timeout: float = 300.0) -> int:
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return -9


def _check_layout(lay: dict, model) -> None:
    """The reference's parameter layout is the program's: the same leaves
    with the same shapes and dtypes."""
    from repro_torch import tree as tree_lib
    prog = {p: (tuple(d.shape), str(d.dtype).replace("torch.", ""))
            for p, d in tree_lib.leaves_with_paths(model.param_defs())}
    ref = {p: (tuple(s["shape"]), s["dtype"]) for p, s in lay.items()}
    if prog != ref:
        diff = sorted(set(prog.items()) ^ set(ref.items()))
        raise ValueError(f"reference layout differs from the program's: "
                         f"{diff[:6]}")


def _leaf(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


class Rank:
    """One rank's program under test: the cell's model, planner,
    CommConfig, AdamW and train step, its feed and its call, on its own
    device and in the run's process group (with a gloo group, `ctl`, for
    the host's own exchanges)."""

    def __init__(self, opts, cell: dict, cfg: dict, device_type: str,
                 plant=None):
        import torch
        import torch.distributed as dist

        from repro_torch.core.planner import Planner
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models.transformer import Model
        from repro_torch.optim import optimizers as opt_lib
        from repro_torch.optim import schedules
        from repro_torch.train import trainer as tr
        from portbench.reference import train as ref_train

        plant = plant or (lambda stage, obj: obj)
        self.marks = [("imports", time.monotonic())]
        self.cell, self.cfg = cell, cfg
        self.rank, self.world = opts.rank, cell["chips"]
        self.cuda = device_type == "cuda"
        self.dev = (torch.device("cuda", self.rank) if self.cuda
                    else torch.device("cpu"))
        mesh_lib.init_process_group(self.dev, rank=self.rank,
                                    world_size=self.world,
                                    store_dir=opts.store)
        self.ctl = dist.new_group(backend="gloo")
        self.marks.append(("process group", time.monotonic()))
        c, o = cell["comm"], cell["optimizer"]
        ref_train.exchange(cell)       # the settings the reference models
        kind, *shape = c["mesh"]
        if math.prod(shape) != self.world:
            raise ValueError(f"mesh {c['mesh']} is not {self.world} ranks")
        mesh = getattr(mesh_lib, f"make_{kind}_mesh")(*shape, device=self.dev)
        planner = Planner(mesh=mesh, dp_only=c["dp_only"])
        comm = plant("comm", tr.CommConfig(
            mode=c["mode"], wire=c["wire"],
            error_feedback=c["error_feedback"],
            accum_steps=c["accum_steps"]))
        self.model = Model(cells.port_config(cfg))
        self.opt = plant("optimizer", opt_lib.adamw(
            schedules.warmup_cosine(o["peak_lr"], o["warmup_steps"],
                                    o["total_steps"], o["final_frac"]),
            b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"]))
        self.lay = ref_train.family(cfg["arch_type"]).layout(cfg)
        _check_layout(self.lay, self.model)
        self.planner = planner
        self.step_fn = plant("step", tr.make_train_step(
            self.model, self.opt, mesh, planner, comm,
            grad_clip=o["grad_clip"], device=self.dev))
        self.vocab = self.lay[("embed",)]["shape"][0]
        self.host_s = [0.0, 0.0]
        self.marks.append(("step built", time.monotonic()))

    def state(self, seed: int):
        """A fresh train state on the weights of `seed`."""
        from repro_torch.train import trainer as tr
        return tr.train_state_from_params(
            weights.nested(dict(weights.draw(self.lay, seed, self.dev))),
            self.opt, model=self.model, planner=self.planner)

    def load_batches(self, seed: int) -> None:
        """Draws the global batches of steps 0 .. pool-1 of `seed` and puts
        them on the device, in set-up; step s is fed batch s % pool."""
        import numpy as np
        import torch
        d = self.cell["data"]
        self.pool = torch.from_numpy(np.stack([data.batch(
            seed, s, vocab=self.vocab, global_batch=d["global_batch"],
            seq_len=d["seq_len"], period=d["period"], noise=d["noise"])
            for s in range(d["pool"])])).to(self.dev)

    def feed(self, step: int):
        from torch.profiler import record_function

        from repro_torch.models.transformer import Batch
        with record_function("data"):
            t = self.pool[step % self.pool.shape[0]]
            return Batch(tokens=t, labels=t)

    def call(self, state, batch):
        """One step through the program's step function, ending when its
        loss reaches the host; adds the seconds the host spent issuing it
        and waiting for it to `self.host_s`."""
        from torch.profiler import record_function
        t0 = time.monotonic()
        with record_function("step call"):
            state, metrics = self.step_fn(state, batch)
        t1 = time.monotonic()
        with record_function("loss sync"):
            loss = float(metrics["loss"])          # waits for the device
        self.host_s[0] += t1 - t0
        self.host_s[1] += time.monotonic() - t1
        return state, loss

    def sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def check_steps(self, seed: int) -> tuple:
        """Drives a fresh state of `seed` through the cell's check steps
        and reads it. Returns (state, readings, non-finite losses, the
        seconds the readings took)."""
        import torch
        lay, b1 = self.lay, self.cell["optimizer"]["b1"]
        state = self.state(seed)
        self.load_batches(seed)
        self.marks.append(("weights and batches", time.monotonic()))
        prog = {"loss": [], "grad": {}, "delta": {}}
        read_s, failed = 0.0, 0
        for step in range(self.cell["check"]["steps"]):
            state, loss = self.call(state, self.feed(step))
            self.marks.append((f"check step {step}", time.monotonic()))
            prog["loss"].append(loss)
            failed += not math.isfinite(loss)
            if step == 0:
                t_r = time.monotonic()
                m1 = state.opt_state["m"]
                with torch.no_grad():
                    for p in sorted(lay):
                        prog["grad"].update(readings.leaf_norms(
                            p, _leaf(m1, p) / (1 - b1),
                            lay[p].get("stacked", False)))
                read_s += time.monotonic() - t_r
        t_r = time.monotonic()
        with torch.no_grad():
            for p, w0 in weights.draw(lay, seed, self.dev):
                prog["delta"].update(readings.leaf_norms(
                    p, _leaf(state.params, p).float() - w0.float(),
                    lay[p].get("stacked", False)))
                del w0
        read_s += time.monotonic() - t_r
        return state, prog, failed, read_s

    def reference(self, seed: int, variant=None) -> dict:
        """The reference's readings of `seed`, each rank computing its own
        rows (`variant`: a broken or lower-precision version)."""
        import torch.distributed as dist
        from portbench.reference import train as ref_train
        return ref_train.follow(
            self.cfg, self.cell, seed, self.dev, ranks=[self.rank],
            group=dist.group.WORLD if self.world > 1 else None,
            variant=variant)

    def max_over_ranks(self, value):
        import torch
        import torch.distributed as dist
        t = torch.tensor([value], dtype=torch.float64)
        if self.world > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.ctl)
        return t.item()

    def free(self):
        import torch
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def close(self):
        import torch.distributed as dist
        dist.barrier(group=self.ctl)
        dist.destroy_process_group()


def run_rank(opts, cell: dict, cfg: dict, t0: float, device_type: str,
             plant) -> tuple:
    """Returns (the result line's object, {number: {"value", "limit"}},
    the forbidden modules this process loaded); the first two are empty on
    ranks other than 0. Each rank compares its own readings with the
    reference; rank 0 reports the worst over the ranks, and a run in which
    any rank loaded a forbidden module is refused."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, schedule

    r = Rank(opts, cell, cfg, device_type, plant)
    d, seed = cell["data"], opts.seed
    state, prog, failed, read_s = r.check_steps(seed)
    # one more step before the window, and the GC's set-up objects frozen:
    # without them one window step ran 0.13-0.26 s slow on an H100
    # (mamba2-2.7b-l8 at 0.67 s a step; the check's transient tensors or a
    # GC pass over set-up's objects, not told apart)
    step = cell["check"]["steps"]
    state, loss = r.call(state, r.feed(step))
    step += 1
    failed += not math.isfinite(loss)
    r.marks.append(("settle step", time.monotonic()))
    gc.collect()
    gc.freeze()         # set-up's objects stay out of the window's GC passes
    r.sync()
    dist.barrier(group=r.ctl)

    # the window
    done = 0
    t_w = time.monotonic()
    setup_s = t_w - t0 - read_s
    if r.rank == 0:
        last = t0
        parts = []
        for name, t in r.marks + [("window", t_w)]:
            parts.append(f"{name} {t - last:.3f}")
            last = t
        log("portbench: set-up seconds: " + ", ".join(parts))
    times = []
    r.host_s = [0.0, 0.0]
    while True:
        t_s = time.monotonic()
        state, loss = r.call(state, r.feed(step))
        times.append(time.monotonic() - t_s)
        step += 1
        done += 1
        failed += not math.isfinite(loss)
        if r.max_over_ranks(int(time.monotonic() - t_w >= opts.seconds)):
            break
    window_s = time.monotonic() - t_w
    attempted = step
    slowest = max(range(len(times)), key=times.__getitem__)
    first = " ".join(f"{t:.4f}" for t in times[:3])
    times.sort()
    median = times[len(times) // 2]
    by_rank = [None] * r.world if r.rank == 0 else None
    dist.gather_object((median, *r.host_s), by_rank, dst=0, group=r.ctl)
    peak = int(r.max_over_ranks(torch.cuda.max_memory_allocated(r.dev)
                                if r.cuda else 0))

    profiled = None
    if opts.trace:
        # one step under the profiler before the recorded ones takes its
        # start-up (CUPTI's) out of them
        n_tr = cell["trace_steps"]
        path = os.path.join(opts.store, f"trace{r.rank}.json")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if r.cuda
                                         else [])
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=n_tr,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for i in range(n_tr + 1):
                state, loss = r.call(state, r.feed(step))
                step += 1
                failed += not math.isfinite(loss)
                if i == n_tr:
                    r.sync()
                prof.step()
        attempted = step
        del prof
        mine = trace.compact(trace.summarize(path, n_tr))
        os.remove(path)
        profiled = [None] * r.world if r.rank == 0 else None
        dist.gather_object(mine, profiled, dst=0, group=r.ctl)

    # the program's state goes before the reference runs
    gc.unfreeze()
    del state
    r.free()
    t_ref = time.monotonic()
    ref = r.reference(seed)
    ref_s = time.monotonic() - t_ref
    mine_nums = readings.compare(prog, ref)
    nums = {k: r.max_over_ranks(v) for k, v in mine_nums.items()}
    failed = int(r.max_over_ranks(failed))
    found = loaded_forbidden()
    if found:
        log(f"portbench: rank {r.rank} loaded {found}")
    anyone = r.max_over_ranks(int(bool(found)))
    r.close()
    if r.rank != 0:
        return {}, {}, found
    if anyone and not found:
        found = ["(another rank)"]

    limits = cell["check"]["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    log("portbench: numbers, rank 0 " + ", ".join(
        f"{k} {v!r}" for k, v in mine_nums.items()))
    log("portbench: numbers, worst rank " + ", ".join(
        f"{k} {v!r}" for k, v in nums.items()))
    tokens = done * d["global_batch"] * d["seq_len"]
    values = {"train_tokens_per_s": tokens / window_s,
              "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s}
    record = {"window": {"steps": done, "seconds": window_s},
              "flops_per_step": flops.step_flops(cfg, d["global_batch"],
                                                 d["seq_len"]),
              "chips": r.world, "profile": profiled,
              "bucket_sizes": _bucket_sizes(cell, r.lay)}
    metrics = {}
    for m in cells.metrics_for(cell["name"], bool(opts.trace)):
        v = (cells.metric_reader(m["name"])(record) if opts.trace
             else values.get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if r.cuda else "cpu",
              "kind": torch.cuda.get_device_name(r.dev) if r.cuda else "cpu",
              "count": r.world, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    log("portbench: window by rank (median step s, issuing s, waiting s): "
        + "; ".join(" ".join(f"{x:.4f}" for x in v) for v in by_rank))
    if profiled:
        device["busy_s"] = sum(p["busy_us"] for p in profiled) / len(
            profiled) / 1e6
        device["window_s"] = profiled[0]["window_us"] / 1e6
        result["breakdown"] = {"device_ops": profiled[0]["device_ops"],
                               "idle_gaps": profiled[0]["idle_gaps"]}
        q8 = profiled[0]["quant8"]
        log(f"portbench: quant8 launches {len(q8)}, outside a bucket "
            f"{sum(b is None for _, b, _ in q8)}, kernels "
            f"{sorted({n for n, _, _ in q8})}")
        log(f"portbench: traced steps {device['window_s'] / n_tr:.4f} s "
            f"a step against the window's median {median:.4f} s (the "
            f"excess: the profiler's cost, or a host slowed meanwhile)")
    log(f"portbench: window steps min {times[0]:.4f} median {median:.4f} "
        f"max {times[-1]:.4f} s (step {slowest} of the window); the first "
        f"{first} s")
    log(f"portbench: {cell['name']} seed {seed}: {done} steps in "
        f"{window_s:.3f} s, setup {setup_s:.3f} s (readings {read_s:.3f} s),"
        f" reference {ref_s:.3f} s; losses {prog['loss']} against "
        f"{ref['loss']}")
    result["checks"] = checks
    return result, checks, found


def loaded_forbidden() -> list:
    """The forbidden top-level modules that this process holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _bucket_sizes(cell: dict, lay: dict) -> dict:
    """{bucket: (a rank's shard, the padded message)} in elements, of the
    reference's bucket plan (the program's, as the tests hold it)."""
    from portbench.reference import train as ref_train
    X = ref_train.exchange(cell)
    dp = cell["chips"]
    out = {}
    for bi, b in enumerate(X.plan(lay)):
        full = X.padded(X.bucket_elems(b), dp)
        out[bi] = (full // dp, full)
    return out
