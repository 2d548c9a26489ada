#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, two ranks sharing one card.

    python3 chip_gloo_probe.py                  # every probe
    python3 chip_gloo_probe.py funcol_all_gather_tensor ...

NCCL refuses two ranks on one GPU, so two ranks of a DTensor mesh can
share the card only through gloo. Each probe starts its own two-rank gloo
world (a `FileStore` in a temp dir), runs one collective on CUDA tensors
and prints one JSON line `{probe: true}` (the result checked), or
`{probe: "failed: ..."}` when a rank dies (a segfault included: each
probe is its own pair of processes). The probes: the c10d collectives,
the functional collectives DTensor redistributes through, and DTensor's
Shard -> Replicate (an all-gather) and Partial -> Replicate (an
all-reduce). Needs one CUDA device; imports neither JAX nor the repo.
"""
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PROBES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
          "reduce_scatter_tensor", "all_to_all_single", "funcol_all_reduce",
          "funcol_all_gather_tensor", "funcol_reduce_scatter_tensor",
          "dtensor_partial_to_replicate", "dtensor_shard_to_replicate")


def probe(rank: int, store: str, op: str) -> None:
  torch.cuda.set_device(0)
  dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                          world_size=2)
  x = torch.full((4, 8), float(rank + 1), device="cuda")
  if op == "all_reduce":
    dist.all_reduce(x)
    ok = float(x[0, 0]) == 3.0
  elif op == "broadcast":
    dist.broadcast(x, 0)
    ok = float(x[0, 0]) == 1.0
  elif op == "all_gather":
    outs = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(outs, x)
    ok = float(outs[1][0, 0]) == 2.0
  elif op == "all_gather_into_tensor":
    out = torch.empty((8, 8), device="cuda")
    dist.all_gather_into_tensor(out, x)
    ok = float(out[4, 0]) == 2.0
  elif op == "reduce_scatter_tensor":
    out = torch.empty((2, 8), device="cuda")
    dist.reduce_scatter_tensor(out, x)
    ok = float(out[0, 0]) == 3.0
  elif op == "all_to_all_single":
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    ok = float(out[2, 0]) == 2.0
  elif op.startswith("funcol_"):
    import torch.distributed._functional_collectives as fc
    g = dist.group.WORLD
    if op == "funcol_all_reduce":
      ok = float(fc.all_reduce(x, "sum", g)[0, 0]) == 3.0
    elif op == "funcol_all_gather_tensor":
      ok = float(fc.all_gather_tensor(x, 0, g)[4, 0]) == 2.0
    else:
      ok = float(fc.reduce_scatter_tensor(x, "sum", 0, g)[0, 0]) == 3.0
  else:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = DeviceMesh("cuda", [0, 1])
    if op == "dtensor_partial_to_replicate":
      d = DTensor.from_local(x, mesh, [Partial()])
      ok = float(d.redistribute(mesh, [Replicate()]).to_local()[0, 0]) == 3.0
    else:
      d = DTensor.from_local(x, mesh, [Shard(0)])
      ok = float(d.full_tensor()[4, 0]) == 2.0
  torch.cuda.synchronize()
  dist.destroy_process_group()
  if rank == 0:
    print(json.dumps({op: bool(ok)}), flush=True)


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_gloo_probe: no CUDA device", file=sys.stderr)
    return 2
  print(json.dumps({"torch": torch.__version__,
                    "card": torch.cuda.get_device_name(0)}), flush=True)
  for op in sys.argv[1:] or PROBES:
    store = os.path.join(tempfile.mkdtemp(), "store")
    try:
      mp.spawn(probe, args=(store, op), nprocs=2, join=True)
    except Exception as e:    # a dead rank is the probe's answer
      last = str(e).splitlines()[-1][:200]
      print(json.dumps({op: f"failed: {type(e).__name__}: {last}"}),
            flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
