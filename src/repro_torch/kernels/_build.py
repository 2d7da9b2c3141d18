"""Build and load the hand-written CUDA kernels.

`nvcc` compiles each source under `csrc/` into a shared library with a plain
C interface, loaded with `ctypes`. The build happens at first use, into
`build/repro_torch/` at the root of the checkout, and the library's file name
carries a hash of the source and the flags, so a stale library is never
reused. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# Division stays IEEE for every source (nvcc's default -prec-div=true;
# never --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source only. quant8: -fmad=false, no FMA contraction, so
# y - q*s and acc + q*s round like the two separate PyTorch ops of the plain
# versions (bitwise contract). flashattn is held to a tolerance and keeps
# nvcc's default contraction.
SOURCE_FLAGS = {"quant8": ("-fmad=false",), "flashattn": ()}

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else PATH, else
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def flags(name: str) -> tuple:
    """nvcc's flags for csrc/<name>.cu."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def library_path(name: str) -> pathlib.Path:
    """The library's file name hashes the source and its own flags, so a
    change to one source's flags rebuilds that source only."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/<name>.cu unless its library already exists.

    Returns (library path, compiler log). The log holds ptxas's register,
    shared-memory and spill lines when this call compiled, else ""."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)         # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def ptxas_usage(log: str, kernel: str) -> list[tuple[str, int, str]]:
    """(template arguments, registers, stack and spill line) of each entry
    function whose name holds `kernel`, from ptxas's -v lines in a build
    log; "" for a function that is not a template instance."""
    found = re.findall(r"Compiling entry function '(\w*" + re.escape(kernel)
                       + r"\w*)' for 'sm_\w+'.*?\n\s*(\d+ bytes stack "
                       r"frame[^\n]*)\n[^\n]*?Used (\d+) registers", log,
                       re.S)
    return [(",".join(re.findall(r"Li(\d+)E", name)), int(regs), spill.strip())
            for name, spill, regs in found]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process.

    `signatures` maps each exported function to its ctypes argtypes; every
    function returns a cudaError_t (int)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib
