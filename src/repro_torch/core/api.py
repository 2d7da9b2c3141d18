"""MLSL-style Session facade (the paper's two framework interfaces, C7).

Ports `repro/core/api.py`. One object ties the library together the way
MLSL's `Session`/`Distribution` did for Caffe/TF/nGraph:

  * the *collectives* interface  -> `session.comm` (core.collectives.Comm,
    two-level when the mesh has "node" and "local" axes)
  * the *engine* interface       -> `session.comm_engine(model)` builds the
    CommEngine (core.engine) that owns the model's whole bucket-reduction
    data path: bucket plan, flat-vs-two-level routing, wire precision,
    error feedback, priority order, overlap.
  * the *DL Layer* interface     -> `session.planner` picks per-parameter
    partitioning (FSDP over the batch axes when the replicated train state
    would not fit, `planner.make_planner`) and `session.make_train_step()`
    wires the engine into the training step.

A mesh is a `torch.distributed` DeviceMesh. The port has no
`NamedSharding`: `param_shardings` returns the planner's spec tree, and a
rank's state holds its shards (`trainer.make_train_state(...,
planner=session.planner)`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import collectives, hier
from repro_torch.core.engine import CommEngine
from repro_torch.core.planner import Planner, make_planner, plan_report
from repro_torch.models.transformer import Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import trainer as tr


@dataclasses.dataclass
class Session:
    mesh: object                      # torch.distributed DeviceMesh
    planner: Planner
    comm_cfg: tr.CommConfig

    @classmethod
    def create(cls, mesh, *, n_params: float = 0.0, train: bool = True,
               comm: Optional[tr.CommConfig] = None,
               hbm_budget: float = 16e9) -> "Session":
        """`hbm_budget` is the bytes a device may hold (the reference's
        default is a 16 GB chip; pass the card's memory to plan for it)."""
        planner = make_planner(mesh, n_params, train=train,
                               hbm_budget=hbm_budget)
        return cls(mesh=mesh, planner=planner,
                   comm_cfg=comm or tr.CommConfig())

    # --- collectives interface ------------------------------------------------

    @property
    def comm(self) -> collectives.Comm:
        # a ("node", "local")-factored data dimension makes the communicator
        # hierarchy-aware: Comm.allreduce routes through core.hier
        batch = self.planner.batch_axes
        node = hier.NODE_AXIS if hier.NODE_AXIS in batch else None
        local = hier.LOCAL_AXIS if hier.LOCAL_AXIS in batch else None
        return collectives.Comm(mesh=self.mesh, data_axes=batch,
                                model_axis=self.planner.model_axis,
                                node_axis=node, local_axis=local)

    # --- engine interface -----------------------------------------------------

    def comm_engine(self, model: Model) -> CommEngine:
        """The CommEngine the mlsl train step runs: the model's bucket plan,
        per-bucket flat-vs-two-level routes, and wire/EF/overlap
        configuration, inspectable before the first step."""
        return tr.make_comm_engine(model, self.mesh, self.planner,
                                   self.comm_cfg)

    # --- DL layer interface ---------------------------------------------------

    def param_shardings(self, model: Model):
        """The planner's partition spec of every parameter (a tree of
        tuples: per dimension a mesh axis, a tuple of axes or None)."""
        return self.planner.tree_specs(model.param_defs(),
                                       stacked_paths=Model.stacked_path)

    def layer_strategies(self, layers, batch: int):
        """The per-layer data/model/hybrid decision table (paper C1/C2)."""
        p = self.planner.batch_size_total * self.planner.model_size
        return plan_report(layers, batch, p)

    def make_train_step(self, model: Model, optimizer: opt_lib.Optimizer,
                        **kw):
        """The planner's train step (`trainer.make_train_step`). Under FSDP
        or model parallelism it hands LARS and LAMB the groups of each
        split leaf, so their norms are the whole tensors' as in the
        reference."""
        return tr.make_train_step(model, optimizer, self.mesh, self.planner,
                                  self.comm_cfg, **kw)

    def wire_savings(self) -> float:
        """Wire-bytes multiplier of the configured precision vs fp32 (C6)."""
        return (collectives.wire_bytes_per_elem(collectives.WIRE_FP32)
                / collectives.wire_bytes_per_elem(self.comm_cfg.wire))
