"""Multi-pod dry-run: every (architecture x input shape x mesh) combination
on the production mesh, rank 0's step run on `meta` tensors over a fake
process group of 256 or 512 ranks. Nothing is allocated, computed or sent;
no card is needed, and JAX is not imported.

The port's counterpart of `repro/launch/dryrun.py`, with the same CLI and
record keys. Per combination it records:
  * whether the port's real step runs at that layout (the deliverable: the
    distribution plan is coherent for the port's code),
  * `memory`: rank 0's argument and output bytes, exactly from the shapes,
    and its temporary peak, from a dispatch mode that follows every `meta`
    storage's life (the peak of the bytes allocated during the step),
  * `cost_full`: the step's FLOPs (`torch.utils.flop_counter`) and the
    bytes its ops read and write (each op's inputs and outputs; views and
    collectives move none),
  * the collectives it issued and their wire bytes (`launch/roofline.py`),
  * the roofline terms on an H100 cluster and the dominant one.

How it differs from the reference: the reference lowers and compiles one
SPMD program with `ShapeDtypeStruct`s on 512 placeholder devices, reads
XLA's memory and cost analyses and parses the collectives out of the HLO,
adding (repeats - 1) single-block programs because XLA counts a scanned
body once (`build_block_step`). Here rank 0's own step runs eagerly, so
every layer's ops and collectives pass the counters one by one: no block
step and no layerwise correction exist, and `cost_block` is absent. What
eager counters cannot see: fusion (each op's bytes count, where XLA would
fuse elementwise chains), and FLOPs of ops other than matrix products and
attention (`FlopCounterMode` counts those; XLA counts every op).
`lower_s` is the time to build the step and its state, `compile_s` the
counted run.

Training runs `trainer.make_train_step` on rank 0's shards (the planner's
specs; `sharded_state`), the global batch as the argument, rank 0 taking
its rows. Serving runs `Model.prefill` / `Model.decode_step` on rank 0's
parameter shards, its rows of the batch over the batch axes and, for a
decode, its shard of the cache under the reference's cache layout
(`serve.engine.cache_spec_tree`), under the planner's layout, FSDP splits
and moe dispatch (`serve.engine.serving_options`; `--moe-impl ep` takes
the ep dispatch's prefill). The quant8 and flash wrappers give `meta`
tensors their outputs' shapes (`kernels/ops.py`). A step that reads a value on the host (`.item()`)
cannot run on `meta`, and its record is `failed` with that reason. One
size the port takes from the data has a shape rule on `meta` instead: the
gspmd gather dispatch of a MoE model at dp > 1 sizes each rank's expert
buffers from the routed counts (`models/moe.py:most_kept`), and the dry-run
puts their upper bound in its place (`expert_slots_bound`); such a record
says so under `data_dependent`, and its FLOPs, bytes and peak are upper
bounds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  ... [--comm gspmd|mlsl] [--wire fp32|bf16|int8] [--moe-impl gather|ep]
      [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.configs.base import (ModelConfig, active_param_count_estimate,
                                      param_count_estimate)
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.core.planner import Planner, make_planner, mesh_shape
from repro_torch.kernels import flashattn
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rf
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.serve.engine import cache_spec_tree, serving_options
from repro_torch.train import trainer as tr

META = torch.device("meta")


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------

def start_fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of `n` ranks: every
    collective returns at once and moves nothing. Replaces a fake world of
    another size; refuses to touch a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up; the dry-run "
                               "runs in a process of its own")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(*, multi_pod: bool = False, minipod: bool = False):
    """(mesh, name): the production mesh, or the reference's 64-rank (8, 8)
    analysis mesh, over a fake world of its size."""
    if minipod:
        start_fake_world(64)
        return (init_device_mesh("cpu", (8, 8),
                                 mesh_dim_names=("data", "model")),
                "minipod8x8")
    start_fake_world(512 if multi_pod else 256)
    return (mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu"),
            "pod2x16x16" if multi_pod else "pod16x16")


# --------------------------------------------------------------------------
# input / state specs (meta tensors in rank 0's shard shapes)
# --------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, mesh) -> tuple:
    """Rank 0's shard of a tensor of `shape` laid out by `spec` on `mesh`
    (a DeviceMesh or a name -> size dict)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in _axes(entry):
            out[d] //= sizes.get(ax, 1)
    return tuple(out)


def param_specs_meta(model: Model, planner: Planner):
    """Rank 0's parameters as `meta` tensors: the planner's shards where
    the port's train step holds shards (`trainer.sharded_state`), else the
    whole tensors."""
    sharded = tr.sharded_state(planner)

    def one(_, pd, spec):
        shape = shard_shape(pd.shape, spec, planner.mesh) if sharded \
            else pd.shape
        return torch.empty(shape, dtype=pd.dtype, device=META)
    return tree_lib.map_with_path(one, model.param_defs(),
                                  tr.param_specs(model, planner))


def train_state_meta(model: Model, optimizer, mesh, planner: Planner,
                     comm: tr.CommConfig) -> tr.TrainState:
    """Rank 0's train state on `meta`: its parameter shards, the optimizer
    state made for them, and the error-feedback residuals the step keeps
    after its first call."""
    params = param_specs_meta(model, planner)
    residuals = None
    if comm.mode == "mlsl":
        engine = tr.make_comm_engine(model, mesh, planner, comm, device=META)
        if engine.plan.use_ef:
            residuals = engine.init_residuals(META)
    return tr.TrainState(params=params, opt_state=optimizer.init(params),
                         step=0, comm_residuals=residuals)


def batch_specs(cfg: ModelConfig, shape: InputShape, *, with_labels: bool,
                rows: Optional[int] = None) -> Batch:
    """A batch of `rows` rows (default: the global batch) on `meta`."""
    B = rows if rows is not None else shape.global_batch
    S = shape.seq_len
    if cfg.vlm_img_tokens:
        S = S - cfg.vlm_img_tokens

    def t(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=META)
    return Batch(
        tokens=t(B, S), labels=t(B, S) if with_labels else None,
        img_embeds=(t(B, cfg.vlm_img_tokens, cfg.vlm_d_vision,
                      dtype=torch.bfloat16) if cfg.vlm_img_tokens else None),
        frame_embeds=(t(B, cfg.encoder.n_frames, cfg.encoder.d_input,
                        dtype=torch.bfloat16)
                      if cfg.encoder is not None else None))


# --------------------------------------------------------------------------
# counters
# --------------------------------------------------------------------------

def _tensors(x) -> list:
    """The tensors under `x`, looking into dataclasses (a TrainState)."""
    out = []
    for t in tree_leaves(x):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            out += _tensors([getattr(t, f.name)
                             for f in dataclasses.fields(t)])
    return out


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _storage_bytes(x) -> int:
    """Bytes of the distinct storages under `x`."""
    seen, n = set(), 0
    for t in _tensors(x):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops under it allocated and that are
    still alive (`live`), and their most at any moment (`peak`). An output
    that shares a storage with one of the op's inputs (a view, an in-place
    or `out=` op) allocated nothing, whether the storage was made under the
    mode or before it (an argument's). `peak_ops`: the PEAK_OPS ops whose
    live outputs held the most bytes at the peak, and `peak_op` the op
    whose output set it: [op name, bytes] pairs."""

    PEAK_OPS = 6

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: dict = {}
        self.peak_ops: list = []
        self.peak_op = None

    def _track(self, t: torch.Tensor, name: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = (n, name)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            self._snapshot(name, n)
        weakref.finalize(st, self._free, key, n)

    def _snapshot(self, name: str, n: int) -> None:
        held: dict = {}
        for b, op in self._seen.values():
            held[op] = held.get(op, 0) + b
        self.peak_ops = sorted(held.items(), key=lambda kv: -kv[1])[
            :self.PEAK_OPS]
        self.peak_op = [name, n]

    def _free(self, key, n) -> None:
        self.live -= n
        self._seen.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and \
                    id(t.untyped_storage()) not in inputs:
                self._track(t, str(func))
        return out


_NO_ACCESS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
              torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
              torch.ops.aten.detach, torch.ops.aten.alias,
              torch.ops.aten.lift_fresh}


class BytesAccessed(TorchDispatchMode):
    """Each op's input and output bytes, summed (`total`): what the ops
    would read and write unfused. Views, allocations without a write and
    collectives (the wire's, `roofline.CollectiveLog`) count nothing."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func._overloadpacket in _NO_ACCESS
                or func.namespace in ("c10d", "_c10d_functional",
                                      "profiler")):
            self.total += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


@dataclasses.dataclass
class Counted:
    out: object
    flops: float
    bytes_accessed: float
    temp_bytes: int
    collectives: list
    seconds: float
    bounded: bool       # sized a buffer from `expert_slots_bound`
    peak_ops: list      # LiveBytes.peak_ops
    peak_op: object     # LiveBytes.peak_op


@contextlib.contextmanager
def expert_slots_bound():
    """Put a shape rule in place of `models/moe.py:most_kept`, which reads
    the routed counts on the host: meta tensors hold none. A rank keeps at
    most min(capacity, its tokens) choices of one expert, since each token
    chooses an expert once; that is never more than the reference's static
    buffer of `capacity` slots an expert. Yields a list that holds True
    once the rule sized a buffer."""
    fired = []

    def bound(kept, cap, n_rank_tokens):
        fired.append(True)
        return min(cap, n_rank_tokens)
    host = moe_lib.most_kept
    moe_lib.most_kept = bound
    try:
        yield fired
    finally:
        moe_lib.most_kept = host


def run_counted(fn, *args) -> Counted:
    """Run fn(*args) under the FLOP counter, the bytes counter, the live
    storage tracker and the collective log, the MoE expert buffers at
    their upper bound."""
    flashattn.meta_shape_op()       # its FLOP formula, before the counter
    flops = FlopCounterMode(display=False)
    nbytes, live, log = BytesAccessed(), LiveBytes(), rf.CollectiveLog()
    t0 = time.time()
    with expert_slots_bound() as fired, flops, nbytes, live, log:
        out = fn(*args)
    return Counted(out=out, flops=float(flops.get_total_flops()),
                   bytes_accessed=float(nbytes.total), temp_bytes=live.peak,
                   collectives=log.records, seconds=time.time() - t0,
                   bounded=bool(fired), peak_ops=live.peak_ops,
                   peak_op=live.peak_op)


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def _opt_for(cfg: ModelConfig):
    big = param_count_estimate(cfg) > 100e9
    return opt_lib.adamw(1e-4, state_dtype=torch.bfloat16 if big else
                         torch.float32)


def _ctx_kw(cfg: ModelConfig, shape: InputShape,
            comm: tr.CommConfig) -> dict:
    """The serving options of a combination beside the model-parallel ones
    (`serve.engine.serving_options`, which carry the reference's ep mesh
    options)."""
    kw = {}
    if shape.name == "long_500k" and not cfg.is_native_long:
        kw["window_override"] = cfg.long_context_window
    if comm.kv_chunk and shape.kind != "decode":
        kw["kv_chunk"] = comm.kv_chunk
    if comm.kv_dtype != "native" and shape.kind in ("decode", "prefill"):
        kw["kv_dtype"] = comm.kv_dtype
    return kw


def _rows(shape: InputShape, planner: Planner) -> int:
    """Rank 0's rows of the global batch over the planner's batch axes."""
    axes = planner.batch_spec_axes(shape.global_batch)
    sizes = mesh_shape(planner.mesh)
    return shape.global_batch // math.prod(sizes[a] for a in axes)


def build_train(cfg, shape, mesh, planner, comm):
    """(step, args, the state's bytes by part, rank 0's batch bytes)."""
    model = Model(cfg)
    optimizer = _opt_for(cfg)
    step_fn = tr.make_train_step(model, optimizer, mesh, planner, comm,
                                 device=META)
    state = train_state_meta(model, optimizer, mesh, planner, comm)
    batch = batch_specs(cfg, shape, with_labels=True)
    parts = {"params": _nbytes(state.params),
             "opt_state": _nbytes(state.opt_state),
             # the step's gradients: one tensor of each shard's shape and
             # dtype at its end
             "grads": _nbytes(state.params),
             "residuals": _nbytes(state.comm_residuals)}
    dp = math.prod(mesh_shape(mesh)[a] for a in planner.batch_axes)
    return step_fn, (state, batch), parts, _nbytes(batch) // dp


def build_prefill(cfg, shape, mesh, planner, comm, *,
                  force_model_parallel: bool = False):
    """(step, args, the state's bytes by part, rank 0's batch bytes): the
    prefill on rank 0's parameter shards and rows."""
    model = Model(cfg)
    kw = {**serving_options(model, mesh, planner, comm,
                            force_model_parallel=force_model_parallel),
          **_ctx_kw(cfg, shape, comm)}

    def fn(params, batch):
        logits, cache, _ = model.prefill(params, batch, shape.seq_len, **kw)
        return logits, cache

    batch = batch_specs(cfg, shape, with_labels=False,
                        rows=_rows(shape, planner))
    params = param_specs_meta(model, planner)
    return fn, (params, batch), {"params": _nbytes(params)}, _nbytes(batch)


def build_decode(cfg, shape, mesh, planner, comm, *,
                 force_model_parallel: bool = False):
    """The decode step on rank 0's parameter shards, rows and cache
    shard."""
    model = Model(cfg)
    ctx_kw = _ctx_kw(cfg, shape, comm)
    kw = {**serving_options(model, mesh, planner, comm,
                            force_model_parallel=force_model_parallel),
          **ctx_kw}
    if "tp_axis" in kw:
        kw["max_seq"] = shape.seq_len
    rows = _rows(shape, planner)

    def fn(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos, **kw)

    params = param_specs_meta(model, planner)
    cache, _ = cache_spec_tree(
        model.init_cache(shape.global_batch, shape.seq_len, device=META,
                         **ctx_kw), planner, shape.global_batch, mesh)
    token = torch.empty((rows, 1), dtype=torch.int32, device=META)
    args = (params, cache, token, shape.seq_len - 1)
    return fn, args, {"params": _nbytes(params),
                      "cache": _nbytes(cache)}, _nbytes(token)


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


def should_skip(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return ("enc-dec full attention (no windowed variant in the family); "
                "see DESIGN.md §5")
    return None


def model_flops_for(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = active_param_count_estimate(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 token


def _bucket_bytes(collectives, stats) -> list:
    """Per bucket of the plan: the message bytes the collectives in its
    range ("bucket <i>") carried on rank 0, beside CommStats' count."""
    counted: dict = {}
    for c in collectives:
        if c.tag and c.tag.startswith("bucket "):
            i = int(c.tag.split()[1])
            counted[i] = counted.get(i, 0) + c.message_bytes
    return [{"bucket": b.index, "fusable": b.fusable,
             "counted": counted.get(b.index, 0), "stats": b.total_bytes}
            for b in stats.buckets]


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               comm: tr.CommConfig | None = None,
               parallelism: str = "hybrid",
               minipod: bool = False,
               comm_stats: bool = False,
               telemetry_path: Optional[str] = None,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[InputShape] = None,
               mesh=None, mesh_name: Optional[str] = None,
               planner: Optional[Planner] = None,
               force_model_parallel: bool = False) -> dict:
    """One combination's record. `cfg`, `shape`, `mesh` (with
    `mesh_name`) and `planner` override the registry's config,
    `SHAPES[shape_name]`, the production mesh and `make_planner`'s choice
    (e.g. a train cell's configuration at world size 1);
    `force_model_parallel` serves model-parallel over a model axis of one
    rank too. The record's "peak_ops" names the ops holding the most at
    the temporaries' peak (`LiveBytes`)."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or SHAPES[shape_name]
    comm = comm or tr.CommConfig()
    if mesh is None:
        mesh, mesh_name = make_mesh(multi_pod=multi_pod, minipod=minipod)
    chips = mesh_lib.n_chips(mesh)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips, "comm": dataclasses.asdict(comm)}

    skip = should_skip(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    train = shape.kind == "train"
    bpp = (2.0 + 2.0 * (2.0 if param_count_estimate(cfg) > 100e9 else 4.0)
           if train else 2.0)
    if planner is None:
        planner = make_planner(mesh, param_count_estimate(cfg), train=train,
                               bytes_per_param_state=bpp)
    if parallelism == "dp":
        # paper C2: node-group size 1 -- pure data parallelism with
        # ZeRO-sharded parameters/optimizer over every mesh axis
        planner = Planner(mesh=mesh, fsdp=True, dp_only=True)
    rec["fsdp"] = planner.fsdp
    rec["parallelism"] = parallelism
    rec["n_params"] = Model(cfg).n_params()

    stats = None
    if (comm_stats or telemetry_path) and comm.mode == "mlsl" and train:
        # the bucket plan is pure host math: the MLSL-style per-bucket wire
        # stats beside the roofline, and below the bytes the step's own
        # collectives carried, bucket by bucket
        stats = tr.make_comm_engine(Model(cfg), mesh, planner, comm,
                                    device=META).stats()
        if comm_stats:
            rec["comm_stats"] = {
                "n_buckets": len(stats.buckets),
                "topo": stats.topo_name,
                "total_bytes": stats.total_bytes,
                "intra_bytes": stats.intra_bytes,
                "inter_bytes": stats.inter_bytes,
                "t_model_total_s": stats.t_model_total,
            }
            print(stats.table())
        if telemetry_path:
            # healthy modeled baseline card in the telemetry schema
            from repro_torch.obs import telemetry as obs_telemetry
            with obs_telemetry.TelemetryWriter(
                    telemetry_path,
                    run_info={"source": "dryrun", "arch": arch,
                              "shape": shape_name, "mesh": mesh_name,
                              "topo": stats.topo_name,
                              "n_buckets": len(stats.buckets)},
                    sample_every=0) as tel:
                tel.bucket_times(
                    0, modeled=[b.t_model or 0.0 for b in stats.buckets])
            rec["telemetry"] = telemetry_path

    t0 = time.time()
    extra = {} if train else {"force_model_parallel": force_model_parallel}
    fn, args, parts, batch_bytes = BUILDERS[shape.kind](cfg, shape, mesh,
                                                        planner, comm,
                                                        **extra)
    rec["lower_s"] = time.time() - t0
    run = run_counted(fn, *args)
    rec["compile_s"] = run.seconds
    rec["peak_ops"] = {"set_by": run.peak_op, "held_by": run.peak_ops}

    arg_bytes = sum(v for k, v in parts.items() if k != "grads") \
        + batch_bytes
    rec["memory"] = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(_storage_bytes(run.out)),
        "temp_bytes": int(run.temp_bytes),
        "generated_code_bytes": 0,
    }
    rec["state_bytes"] = parts
    if run.bounded:
        rec["data_dependent"] = (
            "the moe blocks' expert buffers at their upper bound, min("
            "capacity, rank 0's tokens) slots an expert: the step sizes them "
            "from the routed counts, which meta tensors do not hold; FLOPs, "
            "bytes and temp_bytes are upper bounds")
    rec["cost_full"] = {"flops": run.flops,
                        "bytes accessed": run.bytes_accessed}
    if stats is not None:
        rec["bucket_bytes"] = _bucket_bytes(run.collectives, stats)
    roof = rf.analyze(arch=arch, shape=shape_name, mesh_name=mesh_name,
                      chips=chips, cost_full=rec["cost_full"],
                      collectives=run.collectives,
                      model_flops=model_flops_for(cfg, shape))
    rec["roofline"] = roof.as_dict()
    rec["status"] = "ok"
    return rec


def failure_reason(e: Exception) -> str:
    """A failed record's reason. An op whose output depends on the values
    (a host read such as `.item()`, or `bincount`, whose length does) has
    no meaning on `meta`: the step reads a value on the host there."""
    msg = f"{type(e).__name__}: {e}"
    if "meta" in str(e).lower() and isinstance(e, (NotImplementedError,
                                                   RuntimeError)):
        return ("host read: the step needs a value computed from the data, "
                "which meta tensors do not hold (" + msg[:300] + ")")
    return msg


def _tag(arch, shape, mesh_tag, comm: tr.CommConfig, args) -> str:
    tag = f"{arch}__{shape}__{mesh_tag}"
    if args.tag:
        tag += f"__{args.tag}"
    elif comm.mode != "gspmd" or comm.moe_impl != "gather" \
            or comm.wire != "fp32" or comm.accum_steps != 1 \
            or comm.kv_chunk or args.parallelism != "hybrid":
        tag += (f"__{comm.mode}-{comm.wire}-{comm.moe_impl}"
                f"-a{comm.accum_steps}{'-ov' if comm.overlap else ''}"
                f"-kc{comm.kv_chunk}-{args.parallelism}")
    return tag


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--minipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--comm", default="gspmd", choices=["gspmd", "mlsl"])
    ap.add_argument("--wire", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--moe-impl", default="gather", choices=["gather", "ep"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--overlap", action="store_true",
                    help="pipeline microbatch reduction (mlsl, --accum > 1)")
    ap.add_argument("--wgather-wire", default="bf16",
                    choices=["bf16", "int8"])
    ap.add_argument("--kv-dtype", default="native",
                    choices=["native", "int8"])
    ap.add_argument("--kv-chunk", type=int, default=0)
    ap.add_argument("--parallelism", default="hybrid",
                    choices=["hybrid", "dp"])
    # with --comm mlsl: print and record the per-bucket CommStats table and
    # the bytes the step's collectives carried per bucket; --telemetry DIR
    # writes DIR/<tag>.telemetry.jsonl, the modeled bucket_times card
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--telemetry", default=None, metavar="DIR")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-prioritize", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    comm = tr.CommConfig(mode=args.comm, wire=args.wire,
                         prioritize=not args.no_prioritize,
                         moe_impl=args.moe_impl, accum_steps=args.accum,
                         overlap=args.overlap, kv_chunk=args.kv_chunk,
                         wgather_wire=args.wgather_wire,
                         kv_dtype=args.kv_dtype)
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if args.all:
        # by mesh, so that the fake world is rebuilt once a mesh
        combos = [(arch, shape, mp) for mp in meshes
                  for arch in registry.ARCH_IDS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape, mp) for mp in meshes]

    os.makedirs(args.out, exist_ok=True)
    if args.telemetry:
        os.makedirs(args.telemetry, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch, shape, mp in combos:
        mesh_tag = ("minipod8x8" if args.minipod
                    else ("pod2x16x16" if mp else "pod16x16"))
        tag = _tag(arch, shape, mesh_tag, comm, args)
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip-existing] {tag}")
            continue
        t0 = time.time()
        try:
            rec = dryrun_one(arch, shape, multi_pod=mp, comm=comm,
                             parallelism=args.parallelism,
                             minipod=args.minipod, comm_stats=args.stats,
                             telemetry_path=(os.path.join(
                                 args.telemetry, tag + ".telemetry.jsonl")
                                 if args.telemetry else None))
        except Exception as e:      # noqa: BLE001 -- record and continue
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "status": "failed", "error": failure_reason(e),
                   "traceback": traceback.format_exc()[-4000:]}
        rec["wall_s"] = time.time() - t0
        st = rec["status"]
        # a failed record has no roofline: it is written as <tag>__failed,
        # which scripts/roofline_table.py does not load (it reads a roofline
        # in every record it loads) and --skip-existing retries
        failed_path = os.path.join(args.out, tag + "__failed.json")
        keep, stale = ((failed_path, path) if st == "failed"
                       else (path, failed_path))
        if os.path.exists(stale):
            os.remove(stale)
        with open(keep, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_fail += st == "failed"
        extra = ""
        if st == "ok":
            r = rec["roofline"]
            op, held = rec["peak_ops"]["held_by"][0]
            extra = (f" dom={r['dominant']} tc={r['t_compute']:.3e}"
                     f" tm={r['t_memory']:.3e} tx={r['t_collective']:.3e}"
                     f" peak held most by {op} ({held / 1e9:.2f} GB)")
        elif st == "failed":
            extra = " " + rec["error"][:160]
        print(f"[{st}] {tag} ({rec['wall_s']:.1f}s){extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
