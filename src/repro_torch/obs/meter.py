"""StepMeter: step-time / throughput / loss accounting for the drivers.

A tiny host-side meter the train and serve loops feed once per step
(``--stats``): bias-corrected EMA of step wall time, tokens/sec, running
loss / grad-norm, and — when given a modeled exposed-comm estimate for the
config — the share of the measured step the model attributes to exposed
communication (Keuper & Pfreundt's compute-vs-comm decomposition as a
single per-step number).

A copy of `repro/obs/meter.py`: pure host code that works on floats the
caller has already pulled off the device (do not pass live device tensors
from inside a step: that forces a synchronize the caller did not ask
for).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class StepMeter:
    """EMA step meter. Call ``start()`` before each step's dispatch and
    ``update(...)`` after blocking on its result (or pass ``dt`` directly)."""

    ema_decay: float = 0.9
    tokens_per_step: float = 0.0          # constant per-step token count
    exposed_comm_model: Optional[float] = None   # modeled exposed s/step

    steps: int = 0
    _ema: float = 0.0                      # biased EMA accumulator
    _t_start: Optional[float] = None
    _t_total: float = 0.0
    _tokens_total: float = 0.0
    last_dt: float = 0.0
    last_loss: Optional[float] = None
    last_grad_norm: Optional[float] = None

    def start(self) -> None:
        self._t_start = time.perf_counter()

    def update(self, *, dt: Optional[float] = None,
               loss: Optional[float] = None,
               grad_norm: Optional[float] = None,
               tokens: Optional[float] = None) -> None:
        """Record one finished step; `dt` defaults to time since `start()`."""
        if dt is None:
            if self._t_start is None:
                raise ValueError("update() without dt needs a prior start()")
            dt = time.perf_counter() - self._t_start
        self._t_start = None
        self.steps += 1
        self.last_dt = dt
        self._t_total += dt
        self._tokens_total += (tokens if tokens is not None
                               else self.tokens_per_step)
        self._ema = self.ema_decay * self._ema + (1 - self.ema_decay) * dt
        if loss is not None:
            self.last_loss = float(loss)
        if grad_norm is not None:
            self.last_grad_norm = float(grad_norm)

    # -- derived ------------------------------------------------------------

    @property
    def step_time(self) -> float:
        """Bias-corrected EMA of step wall time (seconds)."""
        if self.steps == 0:
            return 0.0
        return self._ema / (1 - self.ema_decay ** self.steps)

    @property
    def tokens_per_sec(self) -> float:
        return self._tokens_total / self._t_total if self._t_total else 0.0

    @property
    def exposed_comm_frac(self) -> Optional[float]:
        """Modeled exposed-comm share of the measured step (None without a
        model estimate; capped at 1 — a faster-than-modeled step means the
        model overestimates, not >100% communication)."""
        if self.exposed_comm_model is None or self.step_time <= 0:
            return None
        return min(self.exposed_comm_model / self.step_time, 1.0)

    def summary(self) -> str:
        """One status line for the driver's log."""
        parts = [f"step {self.steps}",
                 f"step_time {self.step_time * 1e3:.1f}ms"]
        if self._tokens_total:
            parts.append(f"tok/s {self.tokens_per_sec:.0f}")
        if self.exposed_comm_frac is not None:
            parts.append(f"exposed_comm ~{self.exposed_comm_frac:.0%}")
        if self.last_loss is not None:
            parts.append(f"loss {self.last_loss:.4f}")
        if self.last_grad_norm is not None:
            parts.append(f"gnorm {self.last_grad_norm:.3f}")
        return "  ".join(parts)

    def to_metrics(self, prefix: str = "meter") -> list:
        """Ledger entries (benchmarks.common.Metric dicts) — all wall-clock,
        hence unstable/warn-only."""
        out = [{"name": f"{prefix}/step_time_us",
                "value": self.step_time * 1e6, "unit": "us",
                "better": "lower", "stable": False}]
        if self._tokens_total:
            out.append({"name": f"{prefix}/tokens_per_sec",
                        "value": self.tokens_per_sec, "unit": "",
                        "better": "higher", "stable": False})
        if self.exposed_comm_frac is not None:
            out.append({"name": f"{prefix}/exposed_comm_frac",
                        "value": self.exposed_comm_frac, "unit": "",
                        "better": "lower", "stable": False})
        return out
