"""Render the port's dry-run records (artifacts/dryrun_torch, written by
`python -m repro_torch.launch.dryrun --all --both-meshes`) as the PERF.md
table: one row per arch, each column joining its shapes' cells in the
order train_4k; prefill_32k; decode_32k; long_500k, each cell "pod16x16 /
pod2x16x16".

Per combination: status; rank 0's argument and predicted peak bytes
(arguments + the temporary peak) in GB, marked "OVER" past one H100's 80 GB;
the counted FLOPs; the wire bytes a rank sends; the three roofline terms of
`repro_torch.launch.roofline` (H100 datasheet constants, model data) and the
dominant one. With --before DIR (an earlier run's records), a peak that
moved by 0.1 GB or more shows the earlier one beside it ("was ...").
Standard library only.

  python3 scripts/dryrun_torch_table.py [artifacts/dryrun_torch] \
      [--before DIR]
"""

from __future__ import annotations

import glob
import json
import os
import sys

HBM = 80e9                      # one H100's device memory
MESHES = ("pod16x16", "pod2x16x16")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(art: str) -> dict:
    recs = {}
    for f in glob.glob(os.path.join(art, "*.json")):
        parts = os.path.basename(f)[:-5].split("__")
        if len(parts) == 3 or (len(parts) == 4 and parts[3] == "failed"):
            with open(f) as fh:
                recs[tuple(parts[:3])] = json.load(fh)
    return recs


def _g(v: float) -> str:
    return f"{v / 1e9:.1f}"


def _peak(r) -> float:
    return r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]


def cells(r, before=None) -> dict:
    if r is None:
        return dict.fromkeys(("st", "mem", "fl", "wire", "t", "dom"), "-")
    if r["status"] != "ok":
        why = r.get("reason") or r.get("error", "")
        return {"st": f"{r['status']} ({why[:48]})", "mem": "", "fl": "",
                "wire": "", "t": "", "dom": ""}
    m, rf = r["memory"], r["roofline"]
    peak = _peak(r)
    st = "ok" + (" (bound)" if r.get("data_dependent") else "")
    was = ""
    if before is not None and before["status"] == "ok" and \
            _g(_peak(before)) != _g(peak):
        was = f" (was {_g(_peak(before))})"
    return {"st": st,
            "mem": f"{_g(m['argument_bytes'])}, {_g(peak)}"
                   + (" OVER" if peak > HBM else "") + was,
            "fl": f"{rf['hlo_flops']:.2e}", "wire": _g(rf["wire_bytes"]),
            "t": f"{rf['t_compute']:.3g}, {rf['t_memory']:.3g}, "
                 f"{rf['t_collective']:.3g}",
            "dom": rf["dominant"]}


def _row(c: list) -> list:
    """A (arch, shape)'s columns over the two meshes: a value the two
    share is printed once."""
    return [c[0][k] if c[0][k] == c[1][k] else f"{c[0][k]} / {c[1][k]}"
            for k in ("st", "mem", "fl", "wire", "t", "dom")]


def table(recs: dict, before: dict | None = None) -> str:
    archs = sorted({a for a, _, _ in recs}, key=lambda a: (
        min(r.get("n_params", 0) for k, r in recs.items() if k[0] == a), a))
    rows = ["| arch | " + "; ".join(SHAPES) + ": status | args, peak GB "
            "(80 GB) | FLOPs | wire GB | t_compute, t_memory, t_collective "
            "s | dominant |", "|---|---|---|---|---|---|---|"]
    for arch in archs:
        per_shape = []
        for shape in SHAPES:
            c = [cells(recs.get((arch, shape, m)),
                       (before or {}).get((arch, shape, m))) for m in MESHES]
            if c[0]["st"] != "-" or c[1]["st"] != "-":
                per_shape.append(_row(c))
        if per_shape:
            rows.append(f"| {arch} | " + " | ".join(
                "; ".join(col) for col in zip(*per_shape)) + " |")
    return "\n".join(rows)


if __name__ == "__main__":
    argv = sys.argv[1:]
    before = None
    if "--before" in argv:
        i = argv.index("--before")
        before = load(argv[i + 1])
        del argv[i:i + 2]
    art = argv[0] if argv else "artifacts/dryrun_torch"
    recs = load(art)
    n = {s: sum(r["status"] == s for r in recs.values())
         for s in ("ok", "skipped", "failed")}
    over = sum(r["status"] == "ok" and r["memory"]["argument_bytes"]
               + r["memory"]["temp_bytes"] > HBM for r in recs.values())
    print(f"records {len(recs)}: {n}; predicted peak past 80 GB: {over}\n")
    print(table(recs, before))
