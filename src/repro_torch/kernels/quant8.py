"""Block-wise symmetric int8 quantization: the wire format of the int8
gradient exchange, as four hand-written CUDA kernels for Hopper.

Ports `repro/kernels/quant8.py`, whose four Pallas TPU kernels become the
kernels of `csrc/quant8.cu`:

  * ``quantize_blocks``              (``quantize_cast_blocks`` is an alias)
  * ``quantize_ef_blocks``           (error feedback fused in one pass)
  * ``dequantize_blocks``
  * ``dequantize_accumulate_blocks`` (gather-side accumulate)

A buffer is viewed as (n_blocks, block) rows with one f32 scale per row;
`block` is a multiple of LANE and `n_blocks` of TILE_ROWS (callers pad, see
`repro_torch.kernels.ops`). Each wrapper takes the plain version in
`ref.py` for a tensor that lies on the CPU; for a CUDA tensor it launches
its kernel or raises; for a `meta` tensor (the dry-run) it returns empty
outputs of the kernel's shapes and dtypes, a shape computation. It
launches on the current stream, does not synchronize, and adds one to its
entry of `LAUNCHES` per launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LANE = 128
DEFAULT_BLOCK = 512          # elements per quantization block
TILE_ROWS = 8                # quantization rows per CTA (per Pallas grid step)

# kernel launches per wrapper since the last reset (a run can show that its
# main path went through the kernels)
LAUNCHES = {"quantize_blocks": 0, "quantize_ef_blocks": 0,
            "dequantize_blocks": 0, "dequantize_accumulate_blocks": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "quant8_quantize": (_P, ctypes.c_int, _P, _P, _I64, _I64, _P),
    "quant8_quantize_ef": (_P, ctypes.c_int, _P, _P, _P, _P, _I64, _I64, _P),
    "quant8_dequantize": (_P, _P, _P, _I64, _I64, _P),
    "quant8_dequantize_accumulate": (_P, _P, _P, _P, _I64, _I64, _P),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _grid(n_blocks: int) -> tuple:
    if n_blocks % TILE_ROWS != 0:
        raise ValueError(
            f"n_blocks={n_blocks} is not a multiple of the row-tile quantum "
            f"TILE_ROWS={TILE_ROWS}; pad the flat buffer to a multiple of "
            f"TILE_ROWS * block elements (see repro_torch.kernels.ops._to_blocks)")
    return (n_blocks // TILE_ROWS,)


def _check_block(shape: tuple) -> None:
    n_blocks, block = shape
    if block % LANE != 0:
        raise ValueError(
            f"block size {block} of a ({n_blocks}, {block}) buffer is not a "
            f"multiple of the lane width LANE={LANE}; quantization "
            f"blocks must tile the 128-element warp chunks")


def _check_shape(x2d: torch.Tensor) -> tuple:
    if x2d.dim() != 2:
        raise ValueError(f"expected a (n_blocks, block) buffer, got shape "
                         f"{tuple(x2d.shape)}")
    _check_block(tuple(x2d.shape))
    _grid(x2d.shape[0])
    return tuple(x2d.shape)


def _check_cuda(name: str, t: torch.Tensor, dtypes: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected a CUDA tensor "
                         f"like the other operands")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                         f"{', '.join(str(d) for d in dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for vector loads")


def _meta(shape: tuple, dtype=torch.float32) -> torch.Tensor:
    """An output of the dry-run's shape computation."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _lib() -> ctypes.CDLL:
    lib = _build.load("quant8", _SIGNATURES)
    lib.quant8_error_string.argtypes = [ctypes.c_int]
    lib.quant8_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn: str, key: str, args: tuple, device: torch.device) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: "
                           f"{lib.quant8_error_string(err).decode()} "
                           f"(cudaError {err})")
    LAUNCHES[key] += 1


def quantize_blocks(x2d: torch.Tensor):
    """x2d (n_blocks, block) f32 or bf16 -> (int8 (n_blocks, block), f32
    (n_blocks,)). The cast to f32 happens in registers."""
    n_blocks, block = _check_shape(x2d)
    if x2d.device.type == "cpu":
        return ref.quantize_blocks(x2d)
    if x2d.device.type == "meta":
        return _meta((n_blocks, block), torch.int8), _meta((n_blocks,))
    _check_cuda("x2d", x2d, (torch.float32, torch.bfloat16))
    q = torch.empty((n_blocks, block), dtype=torch.int8, device=x2d.device)
    s = torch.empty((n_blocks,), dtype=torch.float32, device=x2d.device)
    if n_blocks:
        _launch("quant8_quantize", "quantize_blocks",
                (x2d.data_ptr(), int(x2d.dtype == torch.bfloat16),
                 q.data_ptr(), s.data_ptr(), n_blocks, block), x2d.device)
    return q, s


# The wire cast is folded into the quantize kernel, so a bf16 wire buffer is
# quantized without a materialized f32 copy; the name documents that contract.
quantize_cast_blocks = quantize_blocks


def quantize_ef_blocks(x2d: torch.Tensor, res2d: torch.Tensor):
    """Fused error-feedback quantize: (q, scales, new_residual) of
    y = f32(x) + res, with new_residual = y - q * s, in one pass."""
    n_blocks, block = _check_shape(x2d)
    if tuple(res2d.shape) != (n_blocks, block):
        raise ValueError(
            f"residual shape {tuple(res2d.shape)} must match the blocked "
            f"input shape {(n_blocks, block)}")
    if x2d.device.type == "cpu":
        return ref.quantize_ef_blocks(x2d, res2d)
    if x2d.device.type == "meta":
        return (_meta((n_blocks, block), torch.int8), _meta((n_blocks,)),
                _meta((n_blocks, block)))
    _check_cuda("x2d", x2d, (torch.float32, torch.bfloat16))
    _check_cuda("res2d", res2d, (torch.float32,))
    q = torch.empty((n_blocks, block), dtype=torch.int8, device=x2d.device)
    s = torch.empty((n_blocks,), dtype=torch.float32, device=x2d.device)
    nr = torch.empty((n_blocks, block), dtype=torch.float32, device=x2d.device)
    if n_blocks:
        _launch("quant8_quantize_ef", "quantize_ef_blocks",
                (x2d.data_ptr(), int(x2d.dtype == torch.bfloat16),
                 res2d.data_ptr(), q.data_ptr(), s.data_ptr(), nr.data_ptr(),
                 n_blocks, block), x2d.device)
    return q, s, nr


def _check_dequant(q2d: torch.Tensor, scales: torch.Tensor, out_dtype):
    shape = _check_shape(q2d)
    if tuple(scales.shape) != shape[:1]:
        raise ValueError(f"scales shape {tuple(scales.shape)} must be "
                         f"{shape[:1]} for a {shape} buffer")
    if q2d.device.type in ("cpu", "meta"):
        return shape
    _check_cuda("q2d", q2d, (torch.int8,))
    _check_cuda("scales", scales, (torch.float32,))
    if out_dtype != torch.float32:
        raise ValueError(f"the dequantize kernels write float32, not "
                         f"{out_dtype}")
    return shape


def dequantize_blocks(q2d: torch.Tensor, scales: torch.Tensor, *,
                      out_dtype=torch.float32) -> torch.Tensor:
    """q * s[:, None] -> out_dtype (f32 on the card)."""
    n_blocks, block = _check_dequant(q2d, scales, out_dtype)
    if q2d.device.type == "cpu":
        return ref.dequantize_blocks(q2d, scales, out_dtype=out_dtype)
    if q2d.device.type == "meta":
        return _meta((n_blocks, block), out_dtype)
    out = torch.empty((n_blocks, block), dtype=torch.float32,
                      device=q2d.device)
    if n_blocks:
        _launch("quant8_dequantize", "dequantize_blocks",
                (q2d.data_ptr(), scales.data_ptr(), out.data_ptr(), n_blocks,
                 block), q2d.device)
    return out


def dequantize_accumulate_blocks(q2d: torch.Tensor, scales: torch.Tensor,
                                 acc: torch.Tensor, *,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """acc + q * s[:, None] -> out_dtype (f32 on the card), one pass."""
    n_blocks, block = _check_dequant(q2d, scales, out_dtype)
    if tuple(acc.shape) != (n_blocks, block):
        raise ValueError(f"accumulator shape {tuple(acc.shape)} must match "
                         f"the blocked shape {(n_blocks, block)}")
    if q2d.device.type == "cpu":
        return ref.dequantize_accumulate_blocks(q2d, scales, acc,
                                                out_dtype=out_dtype)
    if q2d.device.type == "meta":
        return _meta((n_blocks, block), out_dtype)
    _check_cuda("acc", acc, (torch.float32,))
    out = torch.empty((n_blocks, block), dtype=torch.float32,
                      device=q2d.device)
    if n_blocks:
        _launch("quant8_dequantize_accumulate", "dequantize_accumulate_blocks",
                (q2d.data_ptr(), scales.data_ptr(), acc.data_ptr(),
                 out.data_ptr(), n_blocks, block), q2d.device)
    return out
