"""Serving engine: batched prefill + greedy/temperature decode loops.

Ports `EngineConfig`, `Engine`, `Request` and `serve_requests` of
`repro/serve/engine.py`, with the same numpy-in, numpy-out API and the
same observability hooks (`meter`, `tracer`, `telemetry`, `monitor`). The
engine runs on the device its parameters lie on.

Greedy decoding takes the first maximum (`torch.argmax`, as `jnp.argmax`).
Temperature sampling draws from a `torch.Generator` on the engine's device
seeded by `seed`: it is repeatable from one seed, but it cannot reproduce
`jax.random`'s bits, so sampled tokens differ from the reference's.

With a mesh and a planner the engine serves model-parallel: its
parameters are this rank's shards (`convert.shard_params` with
`trainer.param_specs`), each data group serves its rows of the batch (the
planner's batch axes), the model's prefill and decode run under the
planner's layout, FSDP splits and moe dispatch, and every cache leaf is
this rank's shard under the reference's cache layout (`cache_spec_tree`
gives the whole tree's). `generate` returns the whole batch's tokens on
every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import collectives as cl
from repro_torch.core.planner import Planner, mesh_shape
from repro_torch.models.transformer import Batch, Model, cache_model_dim


@dataclasses.dataclass
class EngineConfig:
    max_seq: int = 1024
    temperature: float = 0.0          # 0 => greedy
    long_context: bool = False        # use the SWA long-context variant
    kv_dtype: str = "native"          # "int8": quantized KV cache


class Engine:
    def __init__(self, model: Model, params: dict,
                 cfg: EngineConfig | None = None, *, mesh=None,
                 planner: Planner | None = None, comm=None,
                 force_model_parallel: bool = False, meter=None, tracer=None,
                 telemetry=None, monitor=None):
        """`mesh` and `planner` (together): serve model-parallel, `params`
        being this rank's shards under the planner's specs; `comm` (a
        `trainer.CommConfig`, default gspmd on the gather dispatch) gives
        the moe blocks' dispatch, `moe_impl` and `wgather_wire`.
        `force_model_parallel` runs the model-parallel path over the
        planner's model axis even when it has one rank.

        `meter` (obs.meter.StepMeter) / `tracer` (obs.trace.TraceWriter)
        optionally instrument the host loop: a "prefill" span plus one span
        and one meter step per decode step. `telemetry`
        (obs.telemetry.TelemetryWriter) streams one step record per decode
        step, and `monitor` (obs.detect.HealthMonitor) watches the decode
        step times for sustained drift (only the generic step_time_drift
        alarm is reachable: the decode path has no bucket model).
        `telemetry` and `monitor` need `meter`. With any of them the loop
        synchronizes the device after the prefill and every decode step, to
        time it; leave them all None on the fast path."""
        if meter is None and (telemetry is not None or monitor is not None):
            raise ValueError("telemetry and monitor need a meter")
        if (mesh is None) != (planner is None):
            raise ValueError("a model-parallel engine needs both a mesh and "
                             "a planner")
        self.model = model
        self.params = params
        self.cfg = cfg or EngineConfig()
        self.meter = meter
        self.tracer = tracer
        self.telemetry = telemetry
        self.monitor = monitor
        self.device = tree_lib.leaves(params)[0].device
        ctx_kw = {}
        if self.cfg.long_context and model.cfg.arch_type in ("dense", "moe",
                                                             "vlm"):
            ctx_kw["window_override"] = model.cfg.long_context_window
        if self.cfg.kv_dtype != "native":
            ctx_kw["kv_dtype"] = self.cfg.kv_dtype
        self.ctx_kw = ctx_kw
        self.mp_kw: dict = {}
        self.data_groups: list = []
        if mesh is not None:
            self._model_parallel(mesh, planner, comm, force_model_parallel)

    def _model_parallel(self, mesh, planner: Planner, comm,
                        force: bool) -> None:
        """The model-parallel options, made once: the model group and
        layout, the FSDP splits, the moe dispatch and the data groups."""
        from repro_torch.train import trainer as tr
        self.data_groups = [mesh.get_group(a) for a in planner.batch_axes]
        self.mp_kw = serving_options(self.model, mesh, planner, comm,
                                     force_model_parallel=force)
        self.dp = math.prod(mesh_shape(mesh)[a] for a in planner.batch_axes)
        self.data_rank = tr.data_rank(mesh, planner.batch_axes)

    def rows(self, a):
        """This data rank's rows of a whole-batch array (all of it without
        a mesh)."""
        if a is None or not self.data_groups:
            return a
        n = a.shape[0]
        if n % self.dp:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.dp} data ranks")
        m = n // self.dp
        return a[self.data_rank * m:(self.data_rank + 1) * m]

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of t, in rank order (row-major over the
        batch axes)."""
        for g in reversed(self.data_groups):     # innermost axis first
            t = cl._all_gather(t, g)
        return t

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        """This data rank's rows' next tokens. Sampling draws for the whole
        batch (every data rank's logits gathered) from the same seeded
        generator on every rank, so the ranks agree and the draws are a
        one-card run's."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(self.whole(logits).to(torch.float32)
                              / self.cfg.temperature, dim=-1)
        return self.rows(torch.multinomial(probs, 1, generator=gen)[:, 0])

    def _tensor(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(np.asarray(a),
                                                      device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span(self, name: str):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, cat="serve")

    def _observe_decode(self, i: int, batch: int) -> None:
        """Decode step `i` (already timed by the meter) into the rates
        counter, the telemetry stream and the monitor."""
        self.meter.update(tokens=batch)
        if self.telemetry is not None:
            self.telemetry.step(step=i, t_step_s=self.meter.last_dt,
                                tok_s=self.meter.tokens_per_sec)
        if self.tracer is not None:
            self.tracer.counter("rates", self.tracer.now_us(),
                                {"tokens_per_sec": self.meter.tokens_per_sec})
        if self.monitor is not None:
            for a in self.monitor.observe_step(i, self.meter.last_dt):
                if self.telemetry is not None:
                    self.telemetry.alarm(step=a.step, kind=a.kind,
                                         factor=a.factor, level=a.level,
                                         rank=a.rank, detail=a.detail)

    def generate(self, prompts: np.ndarray, n_new: int, *,
                 img_embeds=None, frame_embeds=None, seed: int = 0,
                 timings: Optional[dict] = None) -> np.ndarray:
        """prompts (B, S) int32 -> (B, n_new) generated int32 tokens: the
        prefill's token, then n_new decode steps (the last step's token is
        not returned, as in the reference). `img_embeds` (B, n_img,
        d_vision) go before a VLM's prompt (the decode positions count
        them); `frame_embeds` (B, n_frames, d_input) feed an
        encoder-decoder's encoder, which raises without them.

        `timings`, when given, receives host-clock seconds, each read after
        the device has finished: `prefill_s` (the call to the prefill's
        logits), `first_token_s` (the call to the first token on the host)
        and `decode_s` (one entry per decode step, from the previous token
        on the host to this step's sampled token)."""
        sync = (timings is not None or self.meter is not None
                or self.tracer is not None)
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self.rows(np.asarray(prompts, np.int32)),
                                 device=self.device)
        batch = Batch(tokens=tokens,
                      img_embeds=self._tensor(self.rows(img_embeds)),
                      frame_embeds=self._tensor(self.rows(frame_embeds)))
        with self._span("prefill"):
            logits, cache, pos = self.model.prefill(
                self.params, batch, self.cfg.max_seq, **self.mp_kw,
                **self.ctx_kw)
            if sync:
                self._sync()
        if timings is not None:
            timings["prefill_s"] = time.perf_counter() - t0
            timings["decode_s"] = []
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = self._sample(logits, gen)
        decode_kw = dict(self.mp_kw)
        if "tp_axis" in decode_kw:
            decode_kw["max_seq"] = self.cfg.max_seq
        for i in range(n_new):
            out.append(tok.to(torch.int32).cpu())
            t_step = time.perf_counter()
            if timings is not None and i == 0:
                timings["first_token_s"] = t_step - t0
            if self.meter is not None:
                self.meter.start()
            with self._span(f"decode/{i}"):
                logits, cache = self.model.decode_step(
                    self.params, cache, tok[:, None], pos + i, **decode_kw,
                    **self.ctx_kw)
                tok = self._sample(logits, gen)
                if sync:
                    self._sync()
            if timings is not None:
                timings["decode_s"].append(time.perf_counter() - t_step)
            if self.meter is not None:
                self._observe_decode(i, tokens.shape[0])
        if not out:
            return np.zeros((len(prompts), 0), np.int32)
        toks = torch.stack(out, dim=1)
        if self.data_groups:
            toks = self.whole(toks.to(self.device)).cpu()
        return toks.numpy()


def serving_options(model: Model, mesh, planner: Planner, comm=None, *,
                    force_model_parallel: bool = False) -> dict:
    """`Model.prefill`'s and `decode_step`'s model-parallel options under
    `planner` on `mesh`: the moe dispatch (`comm.moe_impl`, default the
    gather dispatch, which routes the whole batch over the data ranks as
    the reference's serving does), the model group and layout under model
    parallelism (`force_model_parallel`: also over a model axis of one
    rank), and the FSDP splits."""
    from repro_torch.train import trainer as tr
    comm = comm or tr.CommConfig()
    groups = [mesh.get_group(a) for a in planner.batch_axes]
    kw: dict = {"moe": tr.moe_options(
        dataclasses.replace(comm, mode="gspmd"), planner, mesh, groups)}
    if force_model_parallel or tr.model_parallel(planner):
        kw["tp_axis"] = mesh.get_group(planner.model_axis)
        kw["layout"] = model.mp_layout(planner)
    if planner.fsdp:
        kw["fsdp"] = tr.fsdp_splits(model, planner, mesh)
    return kw


def cache_spec_tree(cache, planner: Planner, batch: int, mesh):
    """Rank 0's shard of a decode-cache tree under the reference's cache
    layout (`repro/launch/dryrun.py:cache_spec_tree`), by leaf name: the
    batch over the batch axes, then the model axis where
    `transformer.cache_model_dim` puts it (the KV heads, or else the
    slots, MLA's latent slots, the SSM's heads, the conv channels, the
    RG-LRU width). Returns (the shard `meta` tensors, the spec tree)."""
    sizes = mesh_shape(mesh)
    baxes = planner.batch_spec_axes(batch)
    lead = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)

    def spec_of(path, t):
        off = 1 if "blocks" in path else 0
        dims = [None] * t.dim()
        if t.dim() > off:
            dims[off] = lead
        d = cache_model_dim(path[-1], tuple(t.shape[off:]),
                            planner.model_size)
        if d is not None:
            dims[off + d] = planner.model_axis
        return tuple(dims)

    specs = tree_lib.map_with_path(spec_of, cache)

    def shard(_, t, spec):
        shape = [n // math.prod(sizes[a] for a in (
            () if e is None else e if isinstance(e, tuple) else (e,)))
            for n, e in zip(t.shape, spec)]
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return tree_lib.map_with_path(shard, cache, specs), specs


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new: int
    out: Optional[np.ndarray] = None


def serve_requests(engine: Engine, requests: list, *, pad_id: int = 0):
    """Minimal batched serving: left-pad prompts to a common length, decode
    max(max_new) steps, slice per-request outputs. As in the reference, the
    pads are attended to (there is no pad mask)."""
    S = max(len(r.prompt) for r in requests)
    n_new = max(r.max_new for r in requests)
    B = len(requests)
    toks = np.full((B, S), pad_id, np.int32)
    for i, r in enumerate(requests):
        toks[i, S - len(r.prompt):] = r.prompt
    gen = engine.generate(toks, n_new)
    for i, r in enumerate(requests):
        r.out = gen[i, : r.max_new]
    return requests
