"""`repro_torch.dist` — distributed execution on `torch.distributed`,
counterpart of `repro.dist`.

  dist.mesh      — mesh construction: a `DeviceMesh` over the default
                   group's ranks (importing this package initialises no
                   process group and touches no CUDA state).
  dist.sharding  — named sharding rules over the FactoredLinear logical
                   namespace, laid out on DTensor, and `make_constraint`,
                   the one entry point that produces the `cs` callable
                   the models thread through their forward and decode
                   functions.
  dist.hlo_cost  — the cost ledger of a walked program (FLOPs, HBM
                   bytes, collective bytes, roofline terms at the
                   H100's peaks), from `analysis.op_walk`'s op records.
"""
from repro_torch.dist import hlo_cost, mesh, sharding
from repro_torch.dist.mesh import (dp_axes, dp_size, make_host_mesh,
                                   make_mesh, make_production_mesh,
                                   model_size)
from repro_torch.dist.sharding import (batch_shardings, identity_constraint,
                                       make_constraint, param_shardings,
                                       replicated, state_shardings)

__all__ = [
    "hlo_cost", "mesh", "sharding",
    "dp_axes", "dp_size", "make_host_mesh", "make_mesh",
    "make_production_mesh", "model_size",
    "batch_shardings", "identity_constraint", "make_constraint",
    "param_shardings", "replicated", "state_shardings",
]
