#!/usr/bin/env python3
"""Compare versions of the flash-attention CUDA source on one GPU.

    python3 scripts/flash_ab.py [--passes N] [--keep-failing] OLD.cu NEW.cu
                                [MORE.cu ...]

Each argument is a version of `src/repro_torch/kernels/csrc/flashattn.cu`
with the same C interface. The script builds every version with the port's
nvcc flags (all at once, into `build/flash_ab/`), prints ptxas's registers
and spills for each instance of the Hopper kernel, and checks each
version's `gqa_flash_attention` against the plain version
(`kernels/ref.py`) on ragged, windowed, cross-length and GQA shapes at head
dims 64 and 128 and at the timed shapes, with `chip_smoke.FLASH_TOL`'s bf16
tolerance. Then it times every version with CUDA events at S-A (batch 8,
2048 tokens, 32 query heads on 4 KV heads, D 128, causal), S-B (1, 8192,
window 4096), S-A in the reference's (B, H, S, D) layout with the KV heads
repeated, and whisper-small's prefill shapes (12 heads of 64, batch 16):
W-enc (1500 frames, non-causal), W-dec (32 causal queries) and W-cross
(those 32 queries on the 1500 frames, non-causal), in N passes (default
2), every other one in the opposite order, and
`scaled_dot_product_attention` at S-A and the three whisper shapes once.
Then whisper-small's whole prefill at serve cell W-A's shape (full width,
seeded random weights, 16 x 1500 standard-normal frames, a 32-token
decoder prompt) through `Engine.generate`, its prefill seconds per version
in the same turns. A version that does not build or launch is reported
and left out of the timing, and so is one that differs from the plain
version unless --keep-failing is given (a diagnostic copy, such as one
with a step of the kernel taken out, is timed all the same). Exits
non-zero without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, flashattn, ref  # noqa: E402

OUT = ROOT / "build" / "flash_ab"
TOL = (1.6e-2, 2e-2)   # chip_smoke.FLASH_TOL["bfloat16"]
# (B, Sq, Sk, H, KV, D, window, causal), checked only
CASES = [(1, 200, 200, 2, 2, 128, None, True),
         (1, 129, 383, 2, 1, 128, 130, True),
         (2, 300, 300, 3, 3, 128, 24, True),
         (2, 130, 70, 2, 2, 128, 70, False),
         (2, 200, 200, 32, 4, 128, None, True),
         (3, 1000, 1000, 8, 2, 128, 300, True),
         (2, 32, 300, 3, 3, 64, None, False),
         (1, 300, 300, 4, 4, 64, 100, True),
         (2, 65, 65, 2, 2, 64, None, False),
         (2, 190, 190, 3, 3, 64, None, False),
         (2, 200, 200, 8, 2, 64, 64, True)]
# checked and timed
TIMED = {"S-A": (8, 2048, 2048, 32, 4, 128, None, True),
         "S-B": (1, 8192, 8192, 32, 4, 128, 4096, True),
         "W-enc": (16, 1500, 1500, 12, 12, 64, None, False),
         "W-dec": (16, 32, 32, 12, 12, 64, None, True),
         "W-cross": (16, 32, 1500, 12, 12, 64, None, False)}


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


def turns(names, passes):
    """The versions' order in each pass: forward, then backward, ..."""
    for i in range(passes):
        yield from (names if i % 2 == 0 else list(reversed(names)))


def prefill_times(libs, passes) -> dict:
    """Serve cell W-A's prefill seconds (Engine.generate's `prefill_s`)
    per version, in turns after one warm-up call per version."""
    from repro_torch.configs import registry
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Engine, EngineConfig
    model = Model(registry.get_config("whisper-small"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    batch, prompt_len, enc = 16, 32, model.cfg.encoder
    eng = Engine(model, params, EngineConfig(max_seq=prompt_len + 9))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, model.cfg.vocab, (batch, prompt_len))
    frames = rng.standard_normal((batch, enc.n_frames, enc.d_input),
                                 dtype=np.float32)
    times = {n: [] for n in libs}
    for warm, names in ((True, list(libs)),
                        (False, list(turns(list(libs), passes)))):
        for name in names:
            use(libs[name])
            t = {}
            eng.generate(prompts.astype(np.int32), 1, frame_embeds=frames,
                         timings=t)
            if not warm:
                times[name].append(t["prefill_s"])
    return times


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 1
    passes, keep_failing = 2, False
    while argv[:1] in (["--passes"], ["--keep-failing"]):
        if argv[0] == "--passes":
            passes, argv = int(argv[1]), argv[2:]
        else:
            keep_failing, argv = True, argv[1:]
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
        found = _build.ptxas_usage(log, "flash_fwd_wgmma")
        print(f"{name}: nvcc rc {rc}; " + ("; ".join(
            f"flash_fwd_wgmma<{d or 128}> {regs} registers, {spill}"
            for d, regs, spill in found) or "flash_fwd_wgmma not found"),
            flush=True)
        if rc == 0:
            libs[name] = load(lib)
        else:
            print(log[-4000:])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    data = []
    for B, sq, sk, H, KV, D, window, causal in CASES + list(TIMED.values()):
        q = torch.randn((B, sq, H, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, sk, KV, D), generator=gen, device=dev)
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
        if not ok and not keep_failing:
            del libs[name]
    timed = dict(zip(TIMED, data[len(CASES):]))
    del data
    # the reference's layout: (B, H, S, D) with the KV heads repeated
    bhsd = {label: (timed[label][0].transpose(1, 2).contiguous(),
                    *(t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                      .contiguous() for t in timed[label][1:3]))
            for label, (_, _, _, H, KV, *_) in TIMED.items()
            if label != "S-B"}
    times = {n: {**{label: [] for label in TIMED}, "S-A (B, H, S, D)": []}
             for n in libs}
    for name in turns(list(libs), passes):
        use(libs[name])
        for label, (q, k, v, kw, _, _) in timed.items():
            times[name][label].append(time_ms(
                lambda: flashattn.gqa_flash_attention(q, k, v, **kw),
                iters=20 if q.shape[1] > 1000 else 100))
        times[name]["S-A (B, H, S, D)"].append(time_ms(
            lambda: flashattn.flash_attention(*bhsd["S-A"], causal=True)))
    sdpa = {label: time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            *t, is_causal=timed[label][3]["causal"]), iters=50)
        for label, t in bhsd.items()}
    for name, t in times.items():
        print(f"{name}: " + "  ".join(
            f"{label} " + " / ".join(f"{x:.4f}" for x in xs) + " ms"
            for label, xs in t.items()), flush=True)
    print("scaled_dot_product_attention " + "  ".join(
        f"{label} {ms:.4f} ms" for label, ms in sdpa.items()), flush=True)
    del timed, bhsd
    torch.cuda.empty_cache()
    for name, t in prefill_times(libs, passes).items():
        print(f"{name}: W-A prefill " + " / ".join(f"{x:.5f}" for x in t)
              + " s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
