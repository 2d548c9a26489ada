"""Production mesh entry point (a FUNCTION: importing this module
initialises no process group), counterpart of `repro.launch.mesh`."""
from __future__ import annotations

from repro_torch.dist.mesh import (dp_axes, dp_size, make_host_mesh,
                                   make_mesh, model_size)
from repro_torch.dist.mesh import make_production_mesh  # re-export

__all__ = ["make_production_mesh", "make_mesh", "make_host_mesh",
           "dp_axes", "dp_size", "model_size"]
