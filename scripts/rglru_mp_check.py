#!/usr/bin/env python3
"""recurrentgemma-2b's gradients under the one-rank model-parallel layout
against its gradients without one, on one card, with the RG-LRU gates in
their present order and as they stood before it was fixed.

    python3 scripts/rglru_mp_check.py [--device cuda] [--layers 3]
                                      [--seq 2048]

`chip_smoke.py`'s families mp phase holds `Model.loss`'s gradients with
the layout of `Planner(mesh)` over a one-rank NCCL model group bitwise to
those without one. This script shows what the fix changed:
  * the model, each side twice: whether a side is bitwise its own on a
    second run (a nondeterministic kernel would differ), and the sides'
    worst relative error (of the largest element);
  * the gates (`rglru._gates`) on the first rglru block's conv output,
    forward and backward against a fixed cotangent, under the layout and
    without, and the same with the gates as before the fix
    (`_gates_slice_first`: the gathered x sliced for the gated input
    before the two products, so the backward adds x's cotangents in
    another order than the dense path's).
Prints one JSON object a line. Runs on the CPU too (`--device cpu`, small
shapes: `--layers 3 --seq 64`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _rel(a, b) -> float:
    top = float(b.float().abs().max())
    return float((a.float() - b.float()).abs().max()) / (top or 1.0)


def _compare(name: str, runs: dict, names: list) -> dict:
    """runs: side -> list of (output, grads) runs; the record of a
    comparison: each side's bitwise repeatability, the sides' bitwise
    agreement and worst relative error (of the largest element), and
    where it is."""
    def flat(run):
        out, grads = run
        return [out, *grads]
    (d1, d2), (l1, l2) = runs["dense"], runs["layout"]
    errs = [_rel(a, b) for a, b in zip(flat(l1), flat(d1))]
    worst = max(errs)
    import torch
    return {"part": name,
            "dense_repeats_bitwise": all(torch.equal(a, b) for a, b in
                                         zip(flat(d1), flat(d2))),
            "layout_repeats_bitwise": all(torch.equal(a, b) for a, b in
                                          zip(flat(l1), flat(l2))),
            "layout_vs_dense_bitwise": all(torch.equal(a, b) for a, b in
                                           zip(flat(l1), flat(d1))),
            "worst_rel_err": worst,
            "worst_at": (["output"] + names)[errs.index(worst)],
            "dense_repeat_worst_rel_err": max(
                _rel(a, b) for a, b in zip(flat(d2), flat(d1)))}


def _gates_slice_first(p, x, r, group):
    """`rglru._gates` under a model group as it stood before the fix: the
    gathered x's slice for the gated input taken before the two gate
    products, so the backward adds x's three cotangents in another order
    than the dense path's."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.core import collectives as cl
    n = x.shape[-1]
    c0 = dist.get_rank(group) * n
    xa = cl.tp_replicate(cl.tp_all_gather(x.to(torch.float32), group), group)
    w_a, w_i = (cl.tp_replicate(w, group)[:, c0:c0 + n]
                for w in (p["w_a"], p["w_i"]))
    xl = xa[..., c0:c0 + n]
    rt = torch.sigmoid(xa @ w_a.to(torch.float32) + p["b_a"])
    it = torch.sigmoid(xa @ w_i.to(torch.float32) + p["b_i"])
    log_a = -r.c_constant * F.softplus(p["lam"]) * rt
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (it * xl)
    return torch.exp(log_a), b


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import blocks, rglru
    from repro_torch.models.transformer import Batch, Model, _slice_tree
    dev = mesh_lib.resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.make_host_mesh(1, 1, device=dev)
    group = mesh.get_group("model")
    cfg = registry.get_config("recurrentgemma-2b") if dev.type == "cuda" \
        else registry.get_smoke_config("recurrentgemma-2b")
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(8), dev)
    layout = {**model.mp_layout(pl.Planner(mesh=mesh)), "embed": None}
    gen = torch.Generator(device=dev).manual_seed(9)
    tok = torch.randint(0, cfg.vocab, (2, args.seq), generator=gen,
                        device=dev)
    batch = Batch(tokens=tok, labels=tok)
    leaves = tree_lib.leaves(params)
    paths = ["/".join(p) for p in tree_lib.paths(params)]
    out = []

    def model_run(kw):
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, batch, **kw)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return loss.detach(), grads

    runs = {"dense": [model_run({}) for _ in range(2)],
            "layout": [model_run({"tp_axis": group, "layout": layout})
                       for _ in range(2)]}
    out.append(_compare(f"model ({cfg.n_layers} layers, 2 x {args.seq})",
                        runs, paths))
    del runs
    # the gates on the first rglru block's conv output
    p = _slice_tree(params["blocks"]["p0_rglru"], 0)
    with torch.no_grad():
        h = model._embed(params, batch)
        x = blocks.norm_apply(p["ln1"], h, cfg)
        u = rglru._causal_conv(x @ p["rec"]["w_in"], p["rec"]["conv"])
    r = cfg.rglru

    def sub(name, fn, tp_fn, inputs, weights):
        """fn(*inputs, weights) and tp_fn likewise, forward and backward
        against a fixed cotangent, twice each."""
        def once(f):
            ins = [t.detach().requires_grad_(True) for t in inputs]
            wl = [t.detach().requires_grad_(True)
                  for t in tree_lib.leaves(weights)]
            y = f(*ins, tree_lib.unflatten(tree_lib.paths(weights), wl))
            y = y if isinstance(y, torch.Tensor) else torch.cat(
                [t.reshape(-1) for t in y])
            ct = torch.randn(y.shape, generator=torch.Generator(
                device=dev).manual_seed(11), device=dev).to(y.dtype)
            grads = torch.autograd.grad(y, [*ins, *wl], ct)
            return y.detach(), grads
        runs = {"dense": [once(fn) for _ in range(2)],
                "layout": [once(tp_fn) for _ in range(2)]}
        out.append(_compare(name, runs, [f"d{i}" for i in range(
            len(inputs))] + ["d" + "/".join(k) for k in tree_lib.paths(
                weights)]))

    rec = p["rec"]
    gates = {k: rec[k] for k in ("w_a", "w_i", "b_a", "b_i", "lam")}
    sub("gates", lambda uu, w: rglru._gates(w, uu, r),
        lambda uu, w: rglru._gates(w, uu, r, group), [u], gates)
    sub("gates, slice before the products (the order before the fix)",
        lambda uu, w: rglru._gates(w, uu, r),
        lambda uu, w: _gates_slice_first(w, uu, r, group), [u], gates)
    for rec_ in out:
        print(json.dumps(rec_), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"}), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
