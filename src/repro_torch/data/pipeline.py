"""Data pipeline: deterministic synthetic LM streams + memory-mapped corpora,
sharded per host.

A copy of `repro/data/pipeline.py` (numpy only, seeded): synthetic mode
generates a structured (learnable) token stream, a noisy periodic
progression, so training can be seen to REDUCE loss. Memmap mode reads a
flat uint16 token file (the packed-corpus format). The batches are numpy
arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"        # synthetic | memmap
    path: Optional[str] = None     # memmap token file
    period: int = 17               # synthetic structure period
    noise: float = 0.05


def host_slice(global_batch: int, n_hosts: int, host_id: int) -> slice:
    if global_batch % n_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n_hosts} hosts")
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


def _synthetic_batch(cfg: DataConfig, step: int, rows: slice) -> np.ndarray:
    """Deterministic learnable stream: tokens follow a periodic progression
    with occasional uniform noise."""
    n = rows.stop - rows.start
    rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
    base = rng.integers(0, cfg.vocab, size=(n, 1), dtype=np.int64)
    t = np.arange(cfg.seq_len, dtype=np.int64)[None, :]
    tokens = (base + t * (1 + (base % cfg.period))) % cfg.vocab
    noise_mask = rng.random((n, cfg.seq_len)) < cfg.noise
    noise = rng.integers(0, cfg.vocab, size=(n, cfg.seq_len), dtype=np.int64)
    tokens = np.where(noise_mask, noise, tokens)
    return tokens.astype(np.int32)


def _memmap_batch(cfg: DataConfig, step: int, rows: slice) -> np.ndarray:
    data = np.memmap(cfg.path, dtype=np.uint16, mode="r")
    n = rows.stop - rows.start
    need = n * (cfg.seq_len + 1)
    start = (step * cfg.global_batch + rows.start) * (cfg.seq_len + 1)
    start = start % max(len(data) - need, 1)
    chunk = np.asarray(data[start: start + need], dtype=np.int32)
    return chunk.reshape(n, cfg.seq_len + 1)[:, : cfg.seq_len] % cfg.vocab


def batch_at(cfg: DataConfig, step: int, *, n_hosts: int = 1,
             host_id: int = 0) -> dict:
    """The (host-local) training batch for a global step: tokens + labels."""
    rows = host_slice(cfg.global_batch, n_hosts, host_id)
    fn = _synthetic_batch if cfg.kind == "synthetic" else _memmap_batch
    tokens = fn(cfg, step, rows)
    return {"tokens": tokens, "labels": tokens}


def iterate(cfg: DataConfig, steps: int, **kw) -> Iterator[dict]:
    for s in range(steps):
        yield batch_at(cfg, s, **kw)
