"""Mesh construction — a `torch.distributed` `DeviceMesh` over the ranks
of the default process group.

Counterpart of `repro.dist.mesh`. Importing this module initialises no
process group and touches no CUDA state: both happen only inside
`make_mesh`, when a caller asks for a mesh.

A world of one in a single process: `make_mesh((1, 1), ("data",
"model"))` with no process group yet initialises one itself, rank 0 of
a world of 1 through an in-memory `HashStore` (backend NCCL on `cuda`,
gloo on `cpu`). A larger world is initialised by its launcher
(`torch.distributed.init_process_group` with a store, a world size and a
rank) before the first `make_mesh`; `mesh.init_world` does it from a
`FileStore` path.

`device_type` defaults to "cuda" and raises without a GPU, as
`device.resolve_device` does; pass "cpu" for the gloo runs of the tests.
The backend follows the device type: NCCL on "cuda", gloo on "cpu".
Gloo on CUDA tensors (say, two ranks sharing one card) is not offered:
DTensor's all-gather dies there with SIGSEGV (`chip_gloo_probe.py`), and
NCCL refuses two ranks on one GPU.

Axis-name conventions (shared with dist.sharding):
  "pod"   — outer data-parallel axis across pods (slow links),
  "data"  — data-parallel axis within a pod,
  "model" — tensor/expert-parallel axis.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.device import resolve_device

# Data-parallel axes, outermost first. Everything else is model-parallel.
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


def _device_type(device_type: Optional[str]) -> str:
  return resolve_device(device_type or "cuda").type


def _backend(device_type: str) -> str:
  return "nccl" if device_type == "cuda" else "gloo"


def init_world(store_path: str, rank: int, world_size: int, *,
               device_type: str = "cuda") -> None:
  """Join a world of `world_size` processes through a `FileStore` at
  `store_path` (no TCP port, so concurrent worlds on one host cannot
  collide). On "cuda" (NCCL) every rank uses device `rank`, so the world
  needs a card per rank; on "cpu" the backend is gloo."""
  import torch.distributed as dist
  device_type = _device_type(device_type)
  if device_type == "cuda":
    torch.cuda.set_device(rank)
  store = dist.FileStore(store_path, world_size)
  dist.init_process_group(_backend(device_type), store=store, rank=rank,
                          world_size=world_size)


def _world_ranks(n: int, device_type: str) -> list:
  import torch.distributed as dist
  if not dist.is_initialized():
    if n != 1:
      raise ValueError(f"mesh needs {n} ranks, got 1 (no process group; "
                       "initialise one with init_world first)")
    if device_type == "cuda":
      torch.cuda.set_device(0)
    dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)
  return list(range(dist.get_world_size()))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
  """Reshape `devices` (ranks; default: every rank of the default group)
  into a named `DeviceMesh`.

  Extra ranks beyond prod(shape) are ignored, so callers can carve a
  sub-mesh (every rank of the world must still call this, as every
  `DeviceMesh` constructor is collective)."""
  from torch.distributed.device_mesh import DeviceMesh
  device_type = _device_type(device_type)
  n = math.prod(shape)
  ranks = list(_world_ranks(n, device_type) if devices is None
               else devices)
  if len(ranks) < n:
    raise ValueError(f"mesh {tuple(shape)} needs {n} devices, "
                     f"got {len(ranks)}")
  if len(shape) != len(axis_names):
    raise ValueError(f"shape {tuple(shape)} / axis_names {tuple(axis_names)}"
                     " rank mismatch")
  grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(tuple(shape))
  return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def make_host_mesh(axis_names: Sequence[str] = ("data", "model"), *,
                   model: int = 1, devices: Optional[Sequence[int]] = None,
                   device_type: Optional[str] = None):
  """Every rank as a (data, model) mesh with `model`-way TP:
  `make_host_mesh()` is pure DP over the world; `make_host_mesh(model=2)`
  folds the trailing factor into a model axis."""
  import torch.distributed as dist
  if devices is None:
    n = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(range(n))
  devices = list(devices)
  n = len(devices)
  if len(axis_names) == 1:
    return make_mesh((n,), axis_names, devices=devices,
                     device_type=device_type)
  if n % model:
    raise ValueError(f"{n} devices not divisible by model={model}")
  return make_mesh((n // model, model), tuple(axis_names)[:2],
                   devices=devices, device_type=device_type)


def make_production_mesh(multi_pod: bool = False, *,
                         devices: Optional[Sequence[int]] = None,
                         device_type: Optional[str] = None):
  """The two production topologies of the reference's dry-run:

  single-pod  (16, 16)      ("data", "model")         256 ranks
  multi-pod   (2, 16, 16)   ("pod", "data", "model")  512 ranks
  """
  if multi_pod:
    return make_mesh((2, 16, 16), ("pod", "data", "model"),
                     devices=None if devices is None else devices[:512],
                     device_type=device_type)
  return make_mesh((16, 16), ("data", "model"),
                   devices=None if devices is None else devices[:256],
                   device_type=device_type)


def axis_sizes(mesh) -> dict:
  """{axis name: size} of a `DeviceMesh` or a `sharding.RuleMesh`."""
  if isinstance(getattr(mesh, "shape", None), dict):
    return dict(mesh.shape)
  names = mesh.mesh_dim_names
  return {a: int(mesh.size(i)) for i, a in enumerate(names)}


def axis_names(mesh) -> tuple:
  return tuple(axis_sizes(mesh))


def dp_axes(mesh) -> tuple[str, ...]:
  """The mesh's data-parallel axis names, outermost first."""
  names = axis_names(mesh)
  return tuple(a for a in DATA_AXES if a in names)


def dp_size(mesh) -> int:
  """Total data-parallel degree (product over dp_axes)."""
  sizes = axis_sizes(mesh)
  return math.prod(sizes[a] for a in dp_axes(mesh))


def model_size(mesh) -> int:
  """Model-parallel degree (1 when the mesh has no model axis)."""
  return int(axis_sizes(mesh).get(MODEL_AXIS, 1))
