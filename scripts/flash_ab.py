#!/usr/bin/env python3
"""Compare versions of the flash-attention CUDA source on one GPU.

    python3 scripts/flash_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of `src/repro_torch/kernels/csrc/flashattn.cu`
with the same C interface. The script builds every version with the port's
nvcc flags (all at once, into `build/flash_ab/`), prints ptxas's registers
and spills for the Hopper kernel, and checks each version's
`gqa_flash_attention` against the plain version (`kernels/ref.py`) on
ragged, windowed, cross-length and GQA shapes and at the prefill shapes of
serve cells S-A and S-B, with `chip_smoke.FLASH_TOL`'s bf16 tolerance. Then
it times every version with CUDA events at S-A (batch 8, 2048 tokens, 32
query heads on 4 KV heads, D 128, causal), S-B (1, 8192, window 4096) and
S-A in the reference's (B, H, S, D) layout with the KV heads repeated, in
two passes, the second in the opposite order, and
`scaled_dot_product_attention` at S-A once. A version that does not build
or launch, or that differs from the plain version, is reported and left
out of the timing. Exits non-zero without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, flashattn, ref  # noqa: E402

OUT = ROOT / "build" / "flash_ab"
TOL = (1.6e-2, 2e-2)   # chip_smoke.FLASH_TOL["bfloat16"]
# (B, Sq, Sk, H, KV, window, causal); the last two are S-A and S-B
CASES = [(1, 200, 200, 2, 2, None, True), (1, 129, 383, 2, 1, 130, True),
         (2, 300, 300, 3, 3, 24, True), (2, 130, 70, 2, 2, 70, False),
         (2, 200, 200, 32, 4, None, True), (3, 1000, 1000, 8, 2, 300, True),
         (8, 2048, 2048, 32, 4, None, True),
         (1, 8192, 8192, 32, 4, 4096, True)]


def build(src: pathlib.Path):
    lib = OUT / f"lib{src.stem}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.flags("flashattn"),
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True, check=False)
    return src.stem, lib, proc.returncode, proc.stdout + proc.stderr


def load(lib: pathlib.Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in flashattn._SIGNATURES.items():
        getattr(dll, fn).argtypes = list(argtypes)
        getattr(dll, fn).restype = ctypes.c_int
    dll.flashattn_error_string.argtypes = [ctypes.c_int]
    dll.flashattn_error_string.restype = ctypes.c_char_p
    return dll


def use(dll: ctypes.CDLL) -> None:
    """Route the wrapper's launches to this version's library."""
    _build._loaded["flashattn"] = dll


def excess(out, plain) -> float:
    plain = plain.float()
    rms = plain.square().mean(-1, keepdim=True).sqrt()
    return float(((out.float() - plain).abs()
                  / (TOL[0] * plain.abs() + TOL[1] * rms)).max())


def time_ms(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 1
    srcs = [pathlib.Path(a).resolve() for a in argv]
    if len(srcs) < 2 or len({s.stem for s in srcs}) != len(srcs):
        print("flash_ab: give two or more sources with distinct names",
              file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(build, srcs))
    libs = {}
    for name, lib, rc, log in built:
        m = re.search(r"flash_fwd_wgmma\w*' for 'sm_90a'.*?\n\s*(\d+ bytes "
                      r"stack frame.*?)\n.*?Used (\d+) registers", log, re.S)
        print(f"{name}: nvcc rc {rc}; flash_fwd_wgmma "
              + (f"{m.group(2)} registers, {m.group(1).strip()}" if m
                 else "not found"), flush=True)
        if rc == 0:
            libs[name] = load(lib)
        else:
            print(log[-4000:])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    data = []
    for B, sq, sk, H, KV, window, causal in CASES:
        q = torch.randn((B, sq, H, 128), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, sk, KV, 128), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        heads = min(H, 4)  # the plain version's scores for 32 heads at S-B
        sub = (q.transpose(1, 2)[:, :heads].contiguous(),
               *(t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                 [:, :heads].contiguous() for t in (k, v)))
        plain = ref.flash_attention(*sub, causal=causal, window=window)
        data.append((q, k, v, dict(causal=causal, window=window), heads,
                     plain))
    for name in list(libs):
        use(libs[name])
        try:
            ex = []
            for q, k, v, kw, heads, plain in data:
                out = flashattn.gqa_flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                ex.append(excess(out.transpose(1, 2)[:, :heads], plain))
        except RuntimeError as e:
            print(f"{name}: {e}")
            del libs[name]
            continue
        ok = max(ex) <= 1
        print(f"{name}: share of the tolerance "
              + " ".join(f"{e:.3f}" for e in ex) + ("" if ok else "  FAIL"),
              flush=True)
        if not ok:
            del libs[name]
    sa, sb = data[-2], data[-1]
    qt = sa[0].transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(8, dim=2).transpose(1, 2).contiguous()
              for t in sa[1:3])
    times = {n: {"S-A": [], "S-B": [], "S-A (B, H, S, D)": []} for n in libs}
    for name in list(libs) + list(reversed(list(libs))):
        use(libs[name])
        for label, (q, k, v, kw, _, _) in (("S-A", sa), ("S-B", sb)):
            times[name][label].append(time_ms(
                lambda: flashattn.gqa_flash_attention(q, k, v, **kw)))
        times[name]["S-A (B, H, S, D)"].append(time_ms(
            lambda: flashattn.flash_attention(qt, kt, vt, causal=True)))
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    for name, t in times.items():
        print(f"{name}: " + "  ".join(
            f"{label} " + " / ".join(f"{x:.4f}" for x in xs) + " ms"
            for label, xs in t.items()), flush=True)
    print(f"scaled_dot_product_attention S-A {sdpa:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
