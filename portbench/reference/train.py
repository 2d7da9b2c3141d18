"""Follows a training cell's first steps in plain PyTorch, from the seed:
the same weights and batches as the program, each data rank's microbatch
gradients in float32 (TF32 off) from the family's reference, the exchange
that the cell's "comm" group names (`exchange_<reference>.py`, which
refuses settings it does not model), the global-norm clip, and AdamW
under the warmup-cosine schedule, with each parameter stored in its
configured dtype after every update as the configuration states (bf16
matrices, f32 SSM vectors).
Returns the readings that `readings.compare` compares.

`variant` puts a lower-precision or broken version in the program's place:
"fp8" (every product with weights rounded to float8 e4m3, the control),
"half_batch" (each microbatch's rows halved, the mean over the rest),
"no_exchange" (each rank keeps its own gradient: no wire, no mean)."""

from __future__ import annotations

import importlib
import math

import torch
import torch.distributed as dist

from portbench import data as data_lib
from portbench import readings, weights
from portbench.reference import common as C

VARIANTS = (None, "fp8", "half_batch", "no_exchange")
COMM_KEYS = {"mode", "wire", "error_feedback", "accum_steps", "dp_only",
             "mesh", "reference"}


def family(arch_type: str):
    return importlib.import_module(f"portbench.reference.{arch_type}")


def exchange(cell: dict):
    """The exchange reference that the cell's "comm" group names; raises
    where the group holds a key or a setting that it does not model."""
    comm = cell["comm"]
    unknown = set(comm) - COMM_KEYS
    if unknown:
        raise ValueError(f"unknown comm keys {sorted(unknown)}")
    mod = importlib.import_module(
        f"portbench.reference.exchange_{comm['reference']}")
    off = mod.unmodelled(comm, cell["chips"])
    if off:
        raise ValueError(f"exchange_{comm['reference']} does not model "
                         f"{', '.join(off)}")
    return mod


def lr_at(o: dict, step: int) -> torch.Tensor:
    """Warmup to the peak, then a cosine to `final_frac` of it, in f32."""
    peak, w, total = o["peak_lr"], o["warmup_steps"], o["total_steps"]
    t = torch.tensor(step, dtype=torch.float32)
    if step < w:
        return peak * (t + 1) / max(w, 1)
    frac = torch.clamp((t - w) / max(total - w, 1), 0.0, 1.0)
    ff = o["final_frac"]
    return peak * (ff + (1 - ff) * 0.5 * (1 + torch.cos(math.pi * frac)))


def _stored(t: torch.Tensor, dtype: str) -> torch.Tensor:
    """t rounded to the dtype it is stored in, back in f32."""
    return t.to(weights.DTYPES[dtype]).float()


def _grads(fam, params: dict, rows: torch.Tensor, cfg: dict, mm,
           row_block: int):
    """(loss, {path: f32 gradient}) of the mean loss over `rows`,
    computed `row_block` rows at a time."""
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    tracked = dict(zip(keys, leaves))
    blocks = torch.split(rows, row_block)
    total, gsum = 0.0, None
    for b in blocks:
        with torch.enable_grad():
            lv = fam.loss(tracked, b, cfg, mm) / len(blocks)
            g = torch.autograd.grad(lv, leaves)
        total += float(lv)
        gsum = list(g) if gsum is None else [a + c for a, c in zip(gsum, g)]
    return total, dict(zip(keys, gsum))


def _norms(tensors: dict, lay: dict) -> dict:
    out = {}
    for p in sorted(tensors):
        out.update(readings.leaf_norms(p, tensors[p],
                                       lay[p].get("stacked", False)))
    return out


@torch.no_grad()
def follow(cfg: dict, cell: dict, seed: int, device, *, ranks=None,
           group=None, variant=None, steps=None) -> dict:
    """Readings of the cell's first `steps` steps (the cell's check
    steps). This process computes the data ranks `ranks` (default: all);
    where other processes compute the others, `group` sums the messages
    and losses over them."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    fam = family(cfg["arch_type"])
    X = exchange(cell)
    lay = fam.layout(cfg)
    mm = C.MATMULS["fp8" if variant == "fp8" else "f32"]
    dp = cell["chips"]
    ranks = list(range(dp)) if ranks is None else list(ranks)
    n_mb, o, d = cell["comm"]["accum_steps"], cell["optimizer"], cell["data"]
    steps = steps or cell["check"]["steps"]
    vocab = lay[("embed",)]["shape"][0]
    plan = X.plan(lay)
    n_pad = [X.padded(X.bucket_elems(b), dp) for b in plan]
    params = {p: t.float() for p, t in weights.draw(lay, seed, device)}
    m = {p: torch.zeros_like(t) for p, t in params.items()}
    v = {p: torch.zeros_like(t) for p, t in params.items()}
    residual = [torch.zeros(n, device=device) for n in n_pad]
    out = {"loss": [], "grad": None, "delta": None}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for s in range(steps):
            tokens = torch.from_numpy(data_lib.batch(
                seed, s, vocab=vocab, global_batch=d["global_batch"],
                seq_len=d["seq_len"], period=d["period"],
                noise=d["noise"])).to(device)
            per = tokens.shape[0] // dp
            mb = per // n_mb
            acc = [torch.zeros(n, device=device) for n in n_pad]
            loss_sum = 0.0
            for k in range(n_mb):
                sums = [None] * len(plan)
                for r in ranks:
                    rows = tokens[r * per:(r + 1) * per][k * mb:(k + 1) * mb]
                    if variant == "half_batch":
                        rows = rows[:max(1, mb // 2)]
                    lv, g = _grads(fam, params, rows, cfg, mm,
                                   cell["check"]["row_block"])
                    loss_sum += lv
                    g = {p: _stored(t, lay[p]["dtype"]) for p, t in g.items()}
                    for bi, b in enumerate(plan):
                        flat = X.fuse(g, b, n_pad[bi])
                        if variant == "no_exchange":
                            if r == ranks[0]:
                                acc[bi] = acc[bi] + flat
                        else:
                            sums[bi] = X.add_message(sums[bi], flat)
                    del g
                if variant != "no_exchange":
                    for bi in range(len(plan)):
                        acc[bi], residual[bi] = X.reduce_microbatch(
                            sums[bi], residual[bi], acc[bi], dp, group)
                del sums
            if group is not None:
                lt = torch.tensor(loss_sum, dtype=torch.float64,
                                  device=device)
                dist.all_reduce(lt, group=group)
                loss_sum = float(lt)
            out["loss"].append(loss_sum / (dp * n_mb))
            grads = {}
            for bi, b in enumerate(plan):
                for p, t in X.unfuse(acc[bi], b).items():
                    grads[p] = _stored(t / n_mb, lay[p]["dtype"])
            del acc
            gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(o["grad_clip"] / torch.clamp(gn, min=1e-9),
                                max=1.0)
            grads = {p: _stored(g * scale, lay[p]["dtype"])
                     for p, g in grads.items()}
            if s == 0:
                out["grad"] = _norms(grads, lay)
            lr = lr_at(o, s).to(device)
            t = torch.tensor(s + 1, dtype=torch.float32, device=device)
            c1, c2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
            for p, g in grads.items():
                m[p] = o["b1"] * m[p] + (1 - o["b1"]) * g
                v[p] = o["b2"] * v[p] + (1 - o["b2"]) * g * g
                upd = (m[p] / c1) / (torch.sqrt(v[p] / c2) + o["eps"]) \
                    + o["weight_decay"] * params[p]
                params[p] = _stored(params[p] - lr * upd, lay[p]["dtype"])
            del grads
        out["delta"] = {}
        for p, t in weights.draw(lay, seed, device):
            out["delta"].update(_norms({p: params[p] - t.float()}, lay))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out
