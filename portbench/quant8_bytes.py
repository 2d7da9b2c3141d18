"""Bytes that the int8 wire's kernels must move, read once and written
once, for a message of n elements (the frozen formula the roofline share
is taken against). quantize_rows reads its input (bf16 or f32) and, with
error feedback, the f32 residual, and writes int8 q, one f32 scale a
block and, with error feedback, the new f32 residual; dequantize_rows
reads q and the scales and, accumulating, the f32 accumulator, and
writes f32."""

from __future__ import annotations

BLOCK = 512


def quantize(n: int, *, in_bytes: int = 2, ef: bool = True) -> float:
    return n * (in_bytes + 1 + (8 if ef else 0)) + 4 * n / BLOCK


def dequantize(n: int, *, acc: bool = True) -> float:
    return n * (1 + 4 + (4 if acc else 0)) + 4 * n / BLOCK


def kernel_bytes(kernel: str, n_shard: int, n_full: int) -> float | None:
    """Bytes of one launch of the kernel named `kernel` (as the profiler
    names it) on a bucket padded to `n_full` elements, of which a rank's
    shard is `n_shard`; None for another kernel."""
    if "dequantize_rows" in kernel:
        return dequantize(n_full, acc="<true>" in kernel)
    if "quantize_rows" in kernel:
        in_bytes = 2 if "bfloat16" in kernel else 4
        ef = ", true," in kernel
        return quantize(n_shard, in_bytes=in_bytes, ef=ef)
    return None
