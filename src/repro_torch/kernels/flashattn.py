"""Flash attention (forward), a hand-written CUDA kernel for Hopper.

Ports `repro/kernels/flashattn.py`, whose Pallas TPU kernel becomes
`csrc/flashattn.cu`: online-softmax attention with f32 running max,
denominator and accumulator, causal and sliding-window masks from absolute
positions starting at 0, and the output in the input dtype.

  * ``flash_attention(q, k, v)``      -- the reference's signature and layout:
                                         (B, H, S, D), heads already repeated
  * ``gqa_flash_attention(q, k, v)``  -- the model's layout: q (B, S, H, D),
                                         k/v (B, S, KV, D); the kernel reads the
                                         KV head of each query head through
                                         strides, with no repeated copy

Both take the plain version in `ref.py` for tensors that lie on the CPU; for
CUDA tensors they launch the kernel or raise. They launch on the current
stream, do not synchronize, and add one to `LAUNCHES["flash_attention"]` per
launch. The kernel is forward-only, as the reference's is. For `meta`
tensors (the dry-run) they return the output's shape through the operator
`repro_torch::flash_attention_shape`, whose FLOP formula (4 D a visible
(query, key) pair, the kernel's work) `torch.utils.flop_counter` counts:
a shape computation, which neither materializes the scores as the plain
version does nor launches anything.

Each (dtype, D) runs one CUDA kernel: bf16 at D 64, 128 and 256
(whisper-small's encoder, decoder and cross-attention; yi-6b's and llava's
prefill; recurrentgemma-2b's local attention) the Hopper kernel
(`wgmma_bf16`: TMA, wgmma, warp specialization; 64-key KV tiles at D 256);
bf16 at D 32, which no served model has, the mma.sync kernel (`mma_bf16`);
f32 at D 32, 64 and 128 the FMA kernel (`fma_f32`). The library reports
which kernel it launched, and `VARIANT_LAUNCHES` counts launches per
kernel.

Bounds on the card (`csrc/flashattn.cu`): 4 * D tensor-core flops per
visible (query, key) pair at 989 TFLOP/s, and one exp2 per pair at 16 a
clock per SM, which at D 64 takes as long as the flops. The Hopper kernel
runs one warpgroup's softmax under other products in flight: at D 128 its
own P V, at D 64 the other two warpgroups' products, issued in turns.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

# head dims the CUDA kernels are built for, per dtype
HEAD_DIMS = {torch.bfloat16: (32, 64, 128, 256), torch.float32: (32, 64, 128)}
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset
LAUNCHES = {"flash_attention": 0}
# the CUDA kernels, in the order of csrc/flashattn.cu's `enum Variant`
VARIANTS = ("fma_f32", "mma_bf16", "wgmma_bf16")
# the same launches, per kernel
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "flash_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I)
    + (_I64,) * 12 + (_I, _I, ctypes.c_float, _P, ctypes.POINTER(_I)),
}


def visible_pairs(sq: int, sk: int, *, causal: bool, window) -> int:
    """The (query, key) pairs the masks leave visible, queries and keys at
    absolute positions from 0: query i sees keys i - window < j <= i when
    causal, every key otherwise."""
    if not causal:
        return sq * sk
    w = min(window or sk, sk)
    head = min(sq, w)
    return head * (head + 1) // 2 + (sq - head) * w


_SHAPE_OP = None


def meta_shape_op():
    """`repro_torch::flash_attention_shape(q, k, v, heads_dim, causal,
    window)`: the output's shape on `meta`, with its FLOP formula
    registered with `torch.utils.flop_counter`. Defined at first use; a
    `FlopCounterMode` copies the formulas when it is made, so the dry-run
    calls this first."""
    global _SHAPE_OP
    if _SHAPE_OP is None:
        from torch.utils.flop_counter import register_flop_formula
        lib = torch.library.Library("repro_torch", "FRAGMENT")
        lib.define("flash_attention_shape(Tensor q, Tensor k, Tensor v, "
                   "int heads_dim, bool causal, int window) -> Tensor")
        lib.impl("flash_attention_shape",
                 lambda q, k, v, heads_dim, causal, window: torch.empty(
                     q.shape, dtype=q.dtype, device=q.device), "Meta")
        op = torch.ops.repro_torch.flash_attention_shape

        @register_flop_formula(op)
        def _flops(q_shape, k_shape, v_shape, heads_dim, causal, window, *,
                   out_shape=None, **kw):
            seq = 3 - heads_dim
            B, H, D = q_shape[0], q_shape[heads_dim], q_shape[-1]
            return 4 * B * H * D * visible_pairs(
                q_shape[seq], k_shape[seq], causal=causal,
                window=window or None)

        _SHAPE_OP = (lib, op)         # the op lives as long as its library
    return _SHAPE_OP[1]


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _check(q, k, v, *, heads_dim: int, window) -> None:
    """Checks shared by both layouts; `heads_dim` is the index of the head
    axis (1 for (B, H, S, D), 2 for (B, S, H, D))."""
    seq_dim = 3 - heads_dim
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must have rank 4, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; flash_attention "
                             f"takes {', '.join(str(d) for d in DTYPES)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    h, hkv = q.shape[heads_dim], k.shape[heads_dim]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV "
                         f"heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    sq, sk = q.shape[seq_dim], k.shape[seq_dim]
    if sk == 0 or (window is not None and sq >= sk + window):
        raise ValueError(
            f"Sq={sq}, Sk={sk}, window={window}: some query rows would see "
            f"no key")


def _check_cuda(q, k, v) -> None:
    d = q.shape[3]
    if d not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dim {d}: the CUDA kernels for {q.dtype} are "
                         f"built for {HEAD_DIMS[q.dtype]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        # the bf16 kernels move rows in 16-byte vectors or TMA boxes
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flashattn", _SIGNATURES)
    lib.flashattn_error_string.argtypes = [ctypes.c_int]
    lib.flashattn_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, o, *, heads_dim: int, causal: bool, window) -> None:
    """q/o and k/v hold (b, h, s, d) through their strides, with the head
    axis at `heads_dim`."""
    seq_dim = 3 - heads_dim
    B, H, D = q.shape[0], q.shape[heads_dim], q.shape[3]
    Sq, Sk = q.shape[seq_dim], k.shape[seq_dim]
    if B * H * Sq == 0:
        return

    def bhs(t):
        return t.stride(0), t.stride(heads_dim), t.stride(seq_dim)

    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), B, H, H // k.shape[heads_dim],
            Sq, Sk, D, *bhs(q), *bhs(k), *bhs(v), *bhs(o), int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(D), stream,
            ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd failed to launch: "
                           f"{lib.flashattn_error_string(err).decode()} "
                           f"(cudaError {err})")
    LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[VARIANTS[variant.value]] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q (B, H, Sq, D); k/v (B, H, Sk, D) (heads already repeated) ->
    (B, H, Sq, D) in q's dtype. On the card the tensors must be contiguous
    and D one of HEAD_DIMS[dtype]."""
    _check(q, k, v, heads_dim=1, window=window)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"q has {q.shape[1]} heads and k {k.shape[1]}; "
                         f"repeat the KV heads first")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        return meta_shape_op()(q, k, v, 1, causal, window or 0)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    _launch(q, k, v, o, heads_dim=1, causal=causal, window=window)
    return o


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """The same attention in the model's layout: q (B, S, H, D), k/v
    (B, S, KV, D) with H a multiple of KV (query head h reads KV head
    h // (H / KV)) -> (B, S, H, D) in q's dtype. On the card each operand
    must be contiguous in its last dim."""
    _check(q, k, v, heads_dim=2, window=window)
    if q.device.type == "cpu":
        g = q.shape[2] // k.shape[2]
        o = ref.flash_attention(
            q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
            v.repeat_interleave(g, dim=2).transpose(1, 2), causal=causal,
            window=window)
        return o.transpose(1, 2)
    if q.device.type == "meta":
        return meta_shape_op()(q, k, v, 2, causal, window or 0)
    _check_cuda(q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, o, heads_dim=2, causal=causal, window=window)
    return o
