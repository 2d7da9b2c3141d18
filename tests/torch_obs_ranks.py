"""Rank body for tests/test_torch_obs_ranks.py: one gloo rank of the port's
per-bucket statistics (repro_torch.obs.stats) on a ("node"=2, "local"=4)
DeviceMesh. Imports torch and repro_torch only, so the spawned ranks never
import JAX.

    python torch_obs_ranks.py RANK WORLD STORE_DIR OUT_DIR

For every case of CASES, writes OUT_DIR/<case>/rank<RANK>.json: the
CommStats rows (legs, bytes, routes, modeled seconds), the table, the
ledger metrics, and, for the cases in TIMED, the BucketTimer's tuple, the
quantize/dequantize calls it made (counted by wrapping the kernels.ops
entry points: on the CPU no CUDA kernel launches) and whether a training
state stepped before it is unchanged after it.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core import engine as eng
from repro_torch.core.planner import Planner, make_hybrid_planner
from repro_torch.data import pipeline
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.obs import stats as obs_stats
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import trainer as tr

DATA_AXES = ("node", "local")
# the gradient tree of tests/test_obs.py
TREE = {"embed": (32, 8), "w": (64, 16), "head": (8, 32)}
# case -> (CommConfig kwargs, source: "tree" | "tree_nonfusable" | "smoke"
# | "smoke_dp_only" | "smoke_hybrid")
CASES = {
    "flat_fp32": (dict(mode="mlsl", wire="fp32"), "tree"),
    "hier_int8_ef": (dict(mode="mlsl", wire="int8", hier=True,
                          error_feedback=True), "tree"),
    "nonfusable_int8": (dict(mode="mlsl", wire="int8", hier=True),
                        "tree_nonfusable"),
    "hier_int8_topo": (dict(mode="mlsl", wire="int8", hier=True,
                            topo="xeon-shm-10gbe"), "tree"),
    "flat_int8": (dict(mode="mlsl", wire="int8"), "tree"),
    # the CLI's planner on the smoke model: 2 fusable norm buckets on the
    # two-level int8 + EF route, the rest leaf by leaf on bf16
    "smoke_cli_int8_ef": (dict(mode="mlsl", wire="int8", hier=True,
                               error_feedback=True), "smoke"),
    "smoke_dp_only_virt": (dict(mode="mlsl", wire="int8", hier=True,
                                error_feedback=True,
                                topo="cloud-virtio-sriov",
                                bucket_bytes=2 ** 16), "smoke_dp_only"),
    "skip_reduce": (dict(mode="mlsl", skip_reduce=True), "tree"),
    # the hybrid planner: model-sharded buckets reduce over "node" only on
    # the flat route, replicated ones over ("node", "local")
    "smoke_hybrid_int8": (dict(mode="mlsl", wire="int8", hier=True),
                          "smoke_hybrid"),
}
TIMED = ("hier_int8_ef", "nonfusable_int8", "flat_int8",
         "smoke_cli_int8_ef", "smoke_dp_only_virt", "skip_reduce",
         "smoke_hybrid_int8")
WARMUP, ITERS = 1, 2
COUNTED = ("quantize", "quantize_ef", "dequantize", "dequantize_accumulate")


def _engine(name, mesh):
    kw, source = CASES[name]
    comm = tr.CommConfig(**kw)
    if source == "smoke_hybrid":
        cfg = registry.get_smoke_config("yi-6b")
        planner = make_hybrid_planner(mesh, cfg, batch=8, seq=32)
        return tr.make_comm_engine(Model(cfg), mesh, planner, comm), None, \
            None, comm
    if source.startswith("smoke"):
        model = Model(registry.get_smoke_config("yi-6b"))
        planner = Planner(mesh=mesh, dp_only=source == "smoke_dp_only")
        return tr.make_comm_engine(model, mesh, planner, comm), model, \
            planner, comm
    struct = {k: torch.empty(s, device="meta") for k, s in TREE.items()}
    extra = ({"leaf_replicated": lambda path: False}
             if source == "tree_nonfusable" else {})
    return eng.CommEngine.create(struct, comm, mesh, DATA_AXES,
                                 **extra), None, None, comm


def _row(b):
    return {"index": b.index, "n_elems": b.n_elems, "route": b.route,
            "wire": b.wire, "fusable": b.fusable, "ef": b.ef,
            "axes": list(b.axes), "t_model": b.t_model,
            "intra_bytes": b.intra_bytes, "inter_bytes": b.inter_bytes,
            "scale_bytes": b.scale_bytes, "padded_elems": b.padded_elems,
            "pad_frac": b.pad_frac,
            "legs": [[lg.leg, lg.level, lg.wire, lg.elems, lg.payload_bytes,
                      lg.scale_bytes] for lg in b.legs]}


def _spy():
    """Count the calls of the kernels.ops quantize/dequantize entry points
    (what a CUDA launch count would show on the card)."""
    counts = dict.fromkeys(COUNTED, 0)
    for fn in COUNTED:
        orig = getattr(kops, fn)

        def wrapped(*a, _orig=orig, _fn=fn, **k):
            counts[_fn] += 1
            return _orig(*a, **k)
        setattr(kops, fn, wrapped)
    return counts


def _stepped_state(model, mesh, planner, comm):
    """A training state two steps in, with its EF residuals."""
    opt = opt_lib.adamw(1e-3)
    state = tr.train_state_from_params(
        model.init(torch.Generator().manual_seed(0), "cpu"), opt)
    step = tr.make_train_step(model, opt, mesh, planner, comm)
    dcfg = pipeline.DataConfig(vocab=model.cfg.vocab, seq_len=16,
                               global_batch=8, seed=0)
    for raw in pipeline.iterate(dcfg, 2):
        state, _ = step(state, Batch(tokens=torch.from_numpy(raw["tokens"]),
                                     labels=torch.from_numpy(raw["labels"])))
    return state


def _tensors(x):
    """Every tensor of a nest of dicts, lists, tuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for k in x.__dataclass_fields__
                for t in _tensors(getattr(x, k))]
    return []


def _snapshot(state):
    return [t.clone() for t in _tensors(state)]


def run_case(name, mesh, out_dir, rank, counts):
    engine, model, planner, comm = _engine(name, mesh)
    measured = tuple(1e-3 * (i + 1) for i in range(engine.plan.n_buckets))
    st = engine.stats(measured=measured)
    rec = {"buckets": [_row(b) for b in st.buckets],
           "topo_name": st.topo_name, "dp": st.dp, "n_node": st.n_node,
           "n_local": st.n_local, "wire": st.wire, "use_ef": st.use_ef,
           "total_bytes": st.total_bytes, "t_model_total": st.t_model_total,
           "t_measured_total": st.t_measured_total, "table": st.table(),
           "describe": engine.plan.describe(), "metrics": st.to_metrics(),
           "bucket_bytes": list(engine.plan.bucket_bytes_list())}
    if name in TIMED:
        state = before = None
        if model is not None:
            state = _stepped_state(model, mesh, planner, comm)
            before = _snapshot(state)
        for k in counts:
            counts[k] = 0
        timer = engine.bucket_timer(mesh, seed=7)
        rec["sampled"] = list(timer.sample(iters=ITERS, warmup=WARMUP))
        rec["calls"] = dict(counts)
        rec["measured_again"] = list(obs_stats.measure_bucket_times(
            engine, mesh, iters=1, warmup=0))
        if state is not None:
            rec["state_unchanged"] = all(
                torch.equal(a, b) for a, b in zip(before, _snapshot(state)))
    case_dir = os.path.join(out_dir, name)
    os.makedirs(case_dir, exist_ok=True)
    with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run(rank: int, world: int, store_dir: str, out_dir: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        mesh = mesh_lib.make_hier_mesh(2, 4, device="cpu")
        counts = _spy()
        for name in CASES:
            run_case(name, mesh, out_dir, rank, counts)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, out_dir = sys.argv[1:]
    run(int(r), int(w), store, out_dir)
