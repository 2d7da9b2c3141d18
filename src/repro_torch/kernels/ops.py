"""Shape-polymorphic wrappers over the quantization kernels.

`quantize`/`quantize_ef`/`dequantize`/`dequantize_accumulate` take tensors of
any shape: they flatten, zero-pad to the kernels' (TILE_ROWS x block)
tiling, and restore the shape on the way back. The wire cast is folded into
the kernels, so a bf16 wire buffer is quantized without an f32 copy.

Every call goes through the `quant8` wrappers, which dispatch by the
tensor's device: a CUDA tensor launches the hand-written kernel (or raises),
a CPU tensor takes the plain version in `ref`. `wire_backend` names that
choice ("cuda" | "torch"; "auto" resolves by device) and rejects a request
that disagrees with the device, such as "torch" for a CUDA tensor; the
CommEngine records the resolved name in its EnginePlan.

A `meta` tensor (the dry-run, `launch/dryrun.py`, which runs the step on
shapes alone) gets outputs of the shapes and dtypes the kernels and their
plain versions return, and nothing is computed or launched: a shape
computation, not a fallback. `wire_backend` names it "meta".
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import quant8

BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class QuantMeta:
    """Static metadata needed to invert `quantize`."""

    shape: tuple
    dtype: Any
    n: int                # true element count before padding
    block: int


@dataclasses.dataclass(frozen=True)
class PadInfo:
    """Padding a flat buffer pays to reach the (TILE_ROWS x block) tiling.

    `waste_frac` is large only for tiny buckets (n < TILE_ROWS * block); the
    engine records it per bucket (EnginePlan.quant_pad)."""

    n: int
    padded: int
    waste_elems: int

    @property
    def waste_frac(self) -> float:
        return self.waste_elems / max(self.padded, 1)


def pad_info(n: int, block: int = quant8.DEFAULT_BLOCK) -> PadInfo:
    row_quantum = block * quant8.TILE_ROWS
    padded = ((n + row_quantum - 1) // row_quantum) * row_quantum
    return PadInfo(n=n, padded=padded, waste_elems=padded - n)


def wire_backend(requested: str = "auto",
                 device: torch.device | str | None = None) -> str:
    """Resolve a requested backend for tensors on `device` (None: the CPU).

    "auto" resolves by device; an explicit request must agree with it."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "meta" or requested == "meta":
        if dev.type != "meta":
            raise ValueError(f"backend 'meta' (the dry-run's shape "
                             f"computation) needs meta tensors, not {dev}")
        return "meta"
    if requested not in ("auto",) + BACKENDS:
        raise ValueError(
            f"unknown quantization backend {requested!r}; expected "
            f"'auto', 'cuda' or 'torch'")
    if dev.type == "cuda":
        if requested == "torch":
            raise ValueError(
                "backend 'torch' was requested for CUDA tensors; on the card "
                "the int8 wire runs the CUDA kernels")
        return "cuda"
    if dev.type != "cpu":
        raise ValueError(f"no quantization backend for device {dev}")
    if requested == "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, not {dev}")
    return "torch"


def _to_blocks(x: torch.Tensor, block: int, *, pad_to: int | None = None):
    """Flatten + zero-pad to (n_blocks, block) with n_blocks % TILE_ROWS == 0.

    Keeps the input dtype (the kernels cast in registers). `pad_to`
    overrides the padded length when the buffer must match a mate padded to
    a larger collective quantum. Returns (blocks, true element count)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    padded = pad_to if pad_to is not None else pad_info(n, block).padded
    if padded != n:
        flat = F.pad(flat, (0, padded - n))
    return flat.reshape(-1, block), n


def quantize(x: torch.Tensor, *, block: int = quant8.DEFAULT_BLOCK,
             backend: str = "auto"):
    """x (any shape, f32 or bf16) -> (q int8 (n_blocks, block), scales f32,
    QuantMeta). The cast to f32 happens inside the kernel."""
    wire_backend(backend, x.device)
    x2d, n = _to_blocks(x, block)
    q, s = quant8.quantize_cast_blocks(x2d)
    return q, s, QuantMeta(shape=tuple(x.shape), dtype=x.dtype, n=n,
                           block=block)


def quantize_ef(x: torch.Tensor, residual: torch.Tensor, *,
                block: int = quant8.DEFAULT_BLOCK, backend: str = "auto"):
    """Fused error-feedback quantize, one pass:

        y = f32(x) + residual;  (q, s) = quantize(y);  new_res = y - q * s

    `residual` has x's element count (any shape). Returns (q, scales,
    QuantMeta, new_residual) with new_residual in residual's shape."""
    wire_backend(backend, x.device)
    x2d, n = _to_blocks(x, block)
    r2d, rn = _to_blocks(residual.to(torch.float32), block,
                         pad_to=x2d.numel())
    if rn != n:
        raise ValueError(f"residual has {rn} elements but the input has {n}")
    q, s, nr = quant8.quantize_ef_blocks(x2d, r2d)
    meta = QuantMeta(shape=tuple(x.shape), dtype=x.dtype, n=n, block=block)
    return q, s, meta, nr.reshape(-1)[:n].reshape(residual.shape)


def dequantize(q: torch.Tensor, scales: torch.Tensor, meta: QuantMeta, *,
               backend: str = "auto") -> torch.Tensor:
    wire_backend(backend, q.device)
    x2d = quant8.dequantize_blocks(q, scales, out_dtype=torch.float32)
    return x2d.reshape(-1)[: meta.n].reshape(meta.shape).to(meta.dtype)


def dequantize_accumulate(q: torch.Tensor, scales: torch.Tensor,
                          acc: torch.Tensor, meta: QuantMeta, *,
                          backend: str = "auto") -> torch.Tensor:
    """acc (the original tensor's element count) + dequant(q), one fused
    pass. `acc` is padded to q's blocked size; the result keeps ACC's dtype,
    reshaped to meta.shape."""
    wire_backend(backend, q.device)
    acc2d, _ = _to_blocks(acc, meta.block, pad_to=q.numel())
    x2d = quant8.dequantize_accumulate_blocks(q, scales, acc2d,
                                         out_dtype=torch.float32)
    return x2d.reshape(-1)[: meta.n].reshape(meta.shape).to(acc.dtype)


def quantization_rmse(x: torch.Tensor, *, block: int = quant8.DEFAULT_BLOCK,
                      backend: str = "auto") -> torch.Tensor:
    """RMS error of a quantize/dequantize round trip."""
    q, s, meta = quantize(x, block=block, backend=backend)
    xr = dequantize(q, s, meta, backend=backend)
    return torch.sqrt(torch.mean(
        (x.to(torch.float32) - xr.to(torch.float32)) ** 2))
