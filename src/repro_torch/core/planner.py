"""The DL Layer API, parameter half: per-parameter partition specs.

Ports the parameter half of `repro/core/planner.py`. Models declare their
parameters as `ParamDef`s with a *kind*; the planner owns the kind ->
sharding rules. A spec is a tuple with one entry per dimension: a mesh axis
name, a tuple of names, or None (replicated along that dimension).

The data-parallel step of this port reads the specs for one thing: which
gradient buckets may travel fused (only fully replicated leaves may). The
rules are the reference's exactly, including one of its quirks: outside
`dp_only`, every matrix kind gets the model axis when its dimension divides
the model size, even when that size is 1 or the mesh has no model axis at
all. Under the default planner only norm scales are replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import tree as tree_lib

# Parameter kinds understood by the planner.
K_EMBED = "embed"            # (vocab, d)
K_HEAD = "head"              # (d, vocab)
K_PROJ_IN = "proj_in"        # (d_in, d_out): output dim model-sharded
K_PROJ_OUT = "proj_out"      # (d_in, d_out): input dim model-sharded
K_EXPERT_IN = "expert_in"    # (E, d, ff)
K_EXPERT_OUT = "expert_out"  # (E, ff, d)
K_VEC_MODEL = "vec_model"    # (n,): per-channel param of a model-sharded dim
K_CONV_MODEL = "conv_model"  # (channels, kwidth): channels model-sharded
K_NORM = "norm"              # replicated small vectors
K_SCALAR = "scalar"
K_REPLICATED = "replicated"  # explicitly replicated projections

# flat vs two-level collective (the two-level path is a later slice)
ALGO_FLAT = "flat"
ALGO_HIER = "hier"


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + dtype + planner kind + init style."""

    shape: tuple
    kind: str
    dtype: torch.dtype = torch.float32
    init: str = "normal"       # normal | zeros | ones | scaled
    init_scale: float | None = None   # overrides 1/sqrt(fan_in)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (or of a plain name->size dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass
class Planner:
    """Maps ParamDefs to partition specs on a mesh."""

    mesh: object
    model_axis: str = "model"
    fsdp: bool = False
    # node-group size 1 (paper C2): pure data parallelism over EVERY mesh
    # axis; the model axis joins the batch axes
    dp_only: bool = False

    def __post_init__(self):
        if self.fsdp:
            raise ValueError(
                "Planner(fsdp=True) is not supported: the mlsl step manages "
                "gradient communication explicitly and needs parameters "
                "replicated over the batch axes")
        shape = mesh_shape(self.mesh)
        names = tuple(shape)
        if self.dp_only:
            self.batch_axes = names
            self.model_size = 1
        else:
            self.batch_axes = tuple(a for a in names if a != self.model_axis)
            self.model_size = shape.get(self.model_axis, 1)

    def spec_for(self, pd: ParamDef, *, stacked: bool = False) -> tuple:
        """Partition spec of a parameter (optionally with a leading,
        replicated scan dimension)."""
        dims = [None] * len(pd.shape)
        offset = 1 if stacked else 0
        shape = pd.shape[offset:]

        def try_model(cands):
            if self.dp_only:
                return
            for d in cands:
                if _divides(shape[d], self.model_size):
                    dims[d + offset] = self.model_axis
                    return

        kind = pd.kind
        if kind in (K_NORM, K_SCALAR, K_REPLICATED):
            pass
        elif kind == K_EMBED:
            try_model([0, 1])
        elif kind == K_HEAD:
            try_model([1, 0])
        elif kind == K_PROJ_IN:
            try_model([len(shape) - 1])
        elif kind == K_PROJ_OUT:
            try_model([0])
        elif kind == K_EXPERT_IN:
            try_model([0, 2])
        elif kind == K_EXPERT_OUT:
            try_model([0, 1])
        elif kind in (K_VEC_MODEL, K_CONV_MODEL):
            try_model([0])
        else:
            raise ValueError(f"unknown param kind {kind!r}")
        return tuple(dims)

    def tree_specs(self, defs_tree,
                   *, stacked_paths: Callable[[tuple], bool] | None = None):
        """ParamDef tree -> spec tree. `stacked_paths(path)` marks leaves
        with a leading (L,) scan dimension."""
        return tree_lib.map_with_path(
            lambda path, pd: self.spec_for(
                pd, stacked=stacked_paths(path) if stacked_paths else False),
            defs_tree)
