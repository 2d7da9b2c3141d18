"""Serving engine: batched prefill + greedy/temperature decode loops.

Ports `EngineConfig`, `Engine`, `Request` and `serve_requests` of
`repro/serve/engine.py`, with the same numpy-in, numpy-out API and the
same observability hooks (`meter`, `tracer`, `telemetry`, `monitor`). The
engine runs on the device its parameters lie on.

Greedy decoding takes the first maximum (`torch.argmax`, as `jnp.argmax`).
Temperature sampling draws from a `torch.Generator` on the engine's device
seeded by `seed`: it is repeatable from one seed, but it cannot reproduce
`jax.random`'s bits, so sampled tokens differ from the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.models.transformer import Batch, Model


@dataclasses.dataclass
class EngineConfig:
    max_seq: int = 1024
    temperature: float = 0.0          # 0 => greedy
    long_context: bool = False        # use the SWA long-context variant
    kv_dtype: str = "native"          # "int8": quantized KV cache


class Engine:
    def __init__(self, model: Model, params: dict,
                 cfg: EngineConfig | None = None, *, meter=None, tracer=None,
                 telemetry=None, monitor=None):
        """`meter` (obs.meter.StepMeter) / `tracer` (obs.trace.TraceWriter)
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

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32)
                              / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

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
        tokens = torch.as_tensor(np.asarray(prompts, np.int32),
                                 device=self.device)
        batch = Batch(tokens=tokens,
                      img_embeds=self._tensor(img_embeds),
                      frame_embeds=self._tensor(frame_embeds))
        with self._span("prefill"):
            logits, cache, pos = self.model.prefill(
                self.params, batch, self.cfg.max_seq, **self.ctx_kw)
            if sync:
                self._sync()
        if timings is not None:
            timings["prefill_s"] = time.perf_counter() - t0
            timings["decode_s"] = []
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = self._sample(logits, gen)
        for i in range(n_new):
            out.append(tok.to(torch.int32).cpu().numpy())
            t_step = time.perf_counter()
            if timings is not None and i == 0:
                timings["first_token_s"] = t_step - t0
            if self.meter is not None:
                self.meter.start()
            with self._span(f"decode/{i}"):
                logits, cache = self.model.decode_step(
                    self.params, cache, tok[:, None], pos + i, **self.ctx_kw)
                tok = self._sample(logits, gen)
                if sync:
                    self._sync()
            if timings is not None:
                timings["decode_s"].append(time.perf_counter() - t_step)
            if self.meter is not None:
                self._observe_decode(i, tokens.shape[0])
        return np.stack(out, axis=1)


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
