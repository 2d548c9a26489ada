"""Multi-pod dry run: every (arch x shape x mesh) cell's real step on fake
tensors, with per-device cost and memory ledgers.

Counterpart of `repro/launch/dryrun.py`, function for function. The
reference lowers and compiles each cell for 512 virtual devices; the
port has no compiler to ask, so it runs the REAL step program —
train_step = forward + backward of every microbatch (a plain loop, which
the walk counts k times) + the optimizer's update; prefill = the
full-sequence forward (last-token logits); decode = one cached serve
step — with the production layouts (`dist.sharding.param_shardings`,
`state_shardings`, `batch_shardings`) on a (16, 16) ("data", "model") or
(2, 16, 16) ("pod", "data", "model") `DeviceMesh` over a fake process
group of 512 ranks (`torch.testing._internal.distributed.fake_pg`:
every collective returns at once), once, on fake tensors
(`FakeTensorMode`: shapes and dtypes, no storage, no arithmetic), under
the op walk. (The fakes are "cpu" tensors where the torch build has no
CUDA: indexing a fake "cuda" tensor there asks for the CUDA runtime.
No count depends on the device.) From that one run come, per device:

  the cost ledger     `dist.hlo_cost`: FLOPs, HBM bytes, the collectives
                      DTensor issued (payload and wire bytes), the
                      roofline terms under the H100's peaks;
  the memory ledger   `analysis.liveness`: argument bytes (this rank's
                      blocks of the parameters, moments, state and
                      batch) and the peak of live storages, in place of
                      XLA's `memory_analysis()`.

Every cell runs with no kernel policy (the plain path), as the
reference's dry run traces its plain path: the CUDA wrappers cannot
launch on fake tensors. The fake world is initialised by `main` (and
`fake_world`) and torn down after; importing this module initialises
nothing. A failure (a sharding mismatch, an op no DTensor rule covers)
is a bug in the port's distribution. Results land in
experiments/dryrun_torch/*.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape decode_32k --mesh single          # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
from torch import nn

from repro_torch import configs
from repro_torch.analysis import liveness
from repro_torch.analysis.op_walk import OpWalk
from repro_torch.core.factored import trainable
from repro_torch.dist import hlo_cost
from repro_torch.dist import sharding as shd
from repro_torch.dist.mesh import dp_size, model_size
from repro_torch.layers.common import ModelConfig, ShapeConfig
from repro_torch.models import deepspeech
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.training.trainer import TrainConfig, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the card the layouts are sized for: one H100 80GB HBM3
CARD_BYTES = 80e9
#: weights served model-parallel only must fit in this share of a card,
#: else they are laid out 2-D too (FSDP serving)
SERVE_SHARE = 0.1
#: parameters trained TP-resident ("zero1") must fit in this share of a
#: card, else they are laid out 2-D ("fsdp")
TRAIN_SHARE = 0.075

#: the fake world of the production meshes
WORLD = 512
#: the ops (by name and operand shapes) a result lists as taking the
#: most bytes and the most FLOPs
TOP_OPS = 5


@contextlib.contextmanager
def fake_world(world_size: int = WORLD):
  """A fake default process group of `world_size` ranks (this process is
  rank 0; every collective returns at once), torn down on exit."""
  import torch.distributed as dist
  from torch.testing._internal.distributed.fake_pg import FakeStore
  if dist.is_initialized():
    raise RuntimeError("dry run: a process group is already initialised")
  dist.init_process_group("fake", store=FakeStore(), rank=0,
                          world_size=world_size)
  try:
    yield
  finally:
    dist.destroy_process_group()


def fake_device() -> str:
  """The fake tensors' device type: "cuda" on a CUDA build of torch (no
  card is touched), "cpu" on a CPU-only one."""
  return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_mesh(shape, axis_names, devices=None):
  """A `DeviceMesh` of `shape` over the fake world's ranks, of the fake
  tensors' device type (the fake group has no device)."""
  from torch.distributed.device_mesh import DeviceMesh
  n = math.prod(shape)
  ranks = list(range(n)) if devices is None else list(devices)[:n]
  return DeviceMesh(fake_device(), torch.tensor(ranks).reshape(tuple(shape)),
                    mesh_dim_names=tuple(axis_names))


@contextlib.contextmanager
def _strided_offsets_unfaked():
  """DTensor finds a strided shard's offsets (`_StridedShard`: a reshape
  that merges a split dim into another) by `.tolist()` of an index
  tensor it makes, which a fake tensor cannot give; inside the context
  that computation runs with no dispatch mode, on a real index tensor of
  the dimension's size."""
  from torch.distributed.tensor.placement_types import _StridedShard
  from torch.utils._python_dispatch import _disable_current_modes
  orig = _StridedShard.local_shard_size_and_offset

  def unfaked(self, *args, **kwargs):
    with _disable_current_modes():
      return orig(self, *args, **kwargs)
  _StridedShard.local_shard_size_and_offset = unfaked
  try:
    yield
  finally:
    _StridedShard.local_shard_size_and_offset = orig


def production_meshes(multi_pod: Optional[bool] = None) -> dict:
  """The single-pod (16, 16) and multi-pod (2, 16, 16) meshes over the
  fake world's ranks (`fake_world` must be open)."""
  import torch.distributed as dist
  assert dist.is_initialized() and dist.get_world_size() >= WORLD, \
      "dry run: open fake_world() first"
  meshes = {}
  if multi_pod is not True:
    meshes["single"] = fake_mesh((16, 16), ("data", "model"))
  if multi_pod is not False:
    meshes["multi"] = fake_mesh((2, 16, 16), ("pod", "data", "model"))
  return meshes


def pick_optimizer(arch: str) -> str:
  # int8-state Adam is the fit strategy for the 671B config
  return "q_adam" if arch == "deepseek-v3-671b" else "adamw"


def _param_bytes(params: nn.Module) -> int:
  return sum(t.numel() * t.element_size()
             for t in params.state_dict().values())


def needs_fsdp_serving(cfg: ModelConfig, params: nn.Module, mesh) -> bool:
  """Model-parallel-only weights must fit `SERVE_SHARE` of a card; else
  2-D shard them."""
  return _param_bytes(params) / model_size(mesh) > SERVE_SHARE * CARD_BYTES


def _with_groups(cfg: ModelConfig, mesh) -> ModelConfig:
  if cfg.moe is None or cfg.moe.dispatch_groups != 1:
    return cfg          # an explicit group choice wins
  return cfg.with_(moe=dataclasses.replace(
      cfg.moe, dispatch_groups=dp_size(mesh)))


def train_param_policy(cfg: ModelConfig, mesh) -> str:
  """'zero1': parameters TP-resident, gradients and moments 2-D (each
  microbatch's gradients reduce-scattered, no per-layer weight gather).
  Chosen whenever the TP-resident parameters fit `TRAIN_SHARE` of a card
  — every config but deepseek-v3-671b, which keeps full FSDP."""
  total = _param_bytes(configs.param_specs(cfg))
  return "zero1" if total / model_size(mesh) < TRAIN_SHARE * CARD_BYTES \
      else "fsdp"


# ---------------------------------------------------------------------------
# Fake tensors, laid out.
# ---------------------------------------------------------------------------

def _fake(t: torch.Tensor, dtype=None) -> torch.Tensor:
  """A fake tensor like the `meta` spec `t` (FakeTensorMode on)."""
  return torch.empty(tuple(t.shape), dtype=dtype or t.dtype,
                     device=fake_device())


def fake_params(cfg: ModelConfig) -> nn.Module:
  """The model's parameters as whole fake tensors (FakeTensorMode on)."""
  params = configs.param_specs(cfg)
  mods = dict(params.named_modules())
  for key, t in params.state_dict(keep_vars=True).items():
    prefix, _, attr = key.rpartition(".")
    mod = mods[prefix]
    if isinstance(t, nn.Parameter):
      mod._parameters[attr] = nn.Parameter(_fake(t), requires_grad=False)
    else:
      mod._buffers[attr] = _fake(t)
  return params


def _fake_tree(tree):
  if isinstance(tree, dict):
    return {k: _fake_tree(v) for k, v in tree.items()}
  return _fake(tree)


def fake_batch(cfg: ModelConfig, shape: ShapeConfig) -> dict:
  """The step's inputs as whole fake tensors: token ids int64 and
  Whisper's frames f32, as the trainer and the engine put them."""
  spec = configs.input_specs(cfg, shape)
  out = {}
  for k, s in spec.items():
    dtype = s.dtype
    if k in ("tokens", "targets", "token", "positions"):
      dtype = torch.int64
    elif k == "frames" and shape.kind == "train":
      dtype = torch.float32
    out[k] = _fake(s, dtype)
  return out


def fake_state(cfg: ModelConfig, shape: ShapeConfig) -> dict:
  """The decode state as whole fake tensors."""
  if cfg.family == "deepspeech":
    return deepspeech.init_decode_state(cfg, shape.global_batch,
                                        device=fake_device())
  return _fake_tree(configs.decode_state_specs(cfg, shape))


def _lay_out_params(params: nn.Module, mesh, **layout) -> nn.Module:
  return shd.distribute_params(params, shd.param_shardings(params, mesh,
                                                           **layout))


def _lay_out_batch(batch: dict, mesh, shape: ShapeConfig) -> dict:
  """The inputs' rows on the data axes."""
  return shd.distribute_tree(batch, shd.batch_shardings(batch, mesh, shape))


# ---------------------------------------------------------------------------
# Step builders: (fn, inputs, donated) — fn() runs the step once. Each
# takes whole `params` (a module), `batch` and `state` (tensors) where
# given, else fakes of the cell's shapes, and lays them out on `mesh`.
# ---------------------------------------------------------------------------

def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, optimizer: str,
                microbatches: int = 8, *, params: Optional[nn.Module] = None,
                batch: Optional[dict] = None):
  """The train step: parameters laid out by `train_param_policy`,
  gradients and moments 2-D (ZeRO: each microbatch's gradients arrive
  reduce-scattered). `fn.grads_of()` gives the step's loss, metrics and
  gradients without the update."""
  api = get_model(cfg)
  cs = shd.make_constraint(mesh, cfg, shape.global_batch)
  k = microbatches
  while shape.global_batch % (k * dp_size(mesh)) and k > 1:
    k //= 2
  policy = train_param_policy(cfg, mesh)
  params = trainable(_lay_out_params(
      fake_params(cfg) if params is None else params, mesh,
      fsdp=policy == "fsdp"))
  gshard = shd.param_shardings(params, mesh, fsdp=True)   # 2-D (ZeRO)
  tc = TrainConfig(lr=1e-3, optimizer=optimizer, microbatches=k,
                   adam=AdamWConfig(max_grad_norm=1.0))
  opt_init, step_fn = make_train_step(cfg, tc, api, cs,
                                      grad_shardings=gshard)
  opt_state = opt_init(params)
  batch = _lay_out_batch(fake_batch(cfg, shape) if batch is None else batch,
                         mesh, shape)

  def train_step():
    return step_fn(params, opt_state, batch, 0)
  train_step.grads_of = lambda: step_fn.grads_of(params, batch)
  return train_step, (params, opt_state, batch), (params, opt_state)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp: bool, *,
                  params: Optional[nn.Module] = None,
                  batch: Optional[dict] = None):
  api = get_model(cfg)
  cs = shd.make_constraint(mesh, cfg, shape.global_batch)
  params = _lay_out_params(fake_params(cfg) if params is None else params,
                           mesh, fsdp=fsdp)
  batch = _lay_out_batch(fake_batch(cfg, shape) if batch is None else batch,
                         mesh, shape)
  if cfg.family == "whisper":
    def prefill():
      return api.encode(params, batch["frames"], cfg, cs=cs)
  elif cfg.family == "deepspeech":
    def prefill():
      return deepspeech.forward(params, batch["feats"], cfg, cs=cs)
  else:
    def prefill():
      return api.forward(params, batch["tokens"], cfg, last_only=True,
                         cs=cs)
  return prefill, (params, batch), None


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp: bool, *,
                 params: Optional[nn.Module] = None,
                 state: Optional[dict] = None, batch: Optional[dict] = None):
  """One serve step, expert stacks 2-D. The step writes the laid-out
  state in place; `batch` is read at each call, so a caller may write
  the next token and positions into it between calls."""
  api = get_model(cfg)
  cs = shd.make_constraint(mesh, cfg, shape.global_batch, decode=True)
  params = _lay_out_params(fake_params(cfg) if params is None else params,
                           mesh, fsdp=fsdp, expert_2d=True)
  batch = _lay_out_batch(fake_batch(cfg, shape) if batch is None else batch,
                         mesh, shape)
  state = fake_state(cfg, shape) if state is None else state
  state = shd.distribute_tree(state, shd.state_shardings(state, mesh, shape))
  if cfg.family == "deepspeech":
    def step():
      return deepspeech.decode_step(params, state, batch["x_t"], cfg)
  else:
    def step():
      return api.decode_step(params, state, batch["token"],
                             batch["positions"], cfg, cs=cs)
  return step, (params, state, batch), state


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, optimizer: str):
  if shape.kind == "train":
    return build_train(cfg, shape, mesh, optimizer)
  fsdp = needs_fsdp_serving(cfg, configs.param_specs(cfg), mesh)
  if shape.kind == "prefill":
    return build_prefill(cfg, shape, mesh, fsdp)
  return build_decode(cfg, shape, mesh, fsdp)


# ---------------------------------------------------------------------------
# Model-FLOPs estimate (6ND / 2ND with MoE-active correction).
# ---------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> tuple[float, float]:
  """(total, active) parameter counts from the `meta` spec tree."""
  total = active = 0.0
  for key, leaf in configs.param_specs(cfg).state_dict().items():
    toks = key.split(".")
    n = float(math.prod(leaf.shape))
    total += n
    if (cfg.moe and "moe" in "".join(toks) and
        any(t in ("w_gate", "w_up", "w_down") for t in toks) and
        cfg.moe.num_experts in leaf.shape):
      active += n * cfg.moe.top_k / cfg.moe.num_experts
    else:
      active += n
  return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
  total, active = param_counts(cfg)
  if shape.kind == "train":
    tokens = shape.global_batch * shape.seq_len
    if cfg.family == "whisper":
      tokens = shape.global_batch * (shape.seq_len + shape.seq_len // 4)
    return 6.0 * active * tokens
  if shape.kind == "prefill":
    return 2.0 * active * shape.global_batch * shape.seq_len
  return 2.0 * active * shape.global_batch          # one token / sequence


# ---------------------------------------------------------------------------
# Runner.
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: ShapeConfig, mesh_name: str, mesh,
             optimizer: Optional[str] = None, *, save: bool = True,
             verbose: bool = True, cfg_override=None) -> dict:
  """Build and run one cell on fake tensors under the op walk; its
  per-device ledgers and roofline."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  cfg = cfg_override or configs.get_config(arch)
  cfg = _with_groups(cfg, mesh)
  opt = optimizer or pick_optimizer(arch)
  t0 = time.time()
  with FakeTensorMode(allow_non_fake_inputs=True):
    fn, inputs, donated = build_cell(cfg, shape, mesh, opt)
    build_s = time.time() - t0
    walk = OpWalk(keep_trace=True)
    with shd.replicated_plain(), _strided_offsets_unfaked(), walk:
      out = fn()
    live = liveness.estimate(walk.result, walk, outputs=out, inputs=inputs,
                             donated=donated)
  run_s = time.time() - t0 - build_s

  n_dev = math.prod(mesh.shape)
  # where the bytes and FLOPs go: by op and operand shapes
  rep = hlo_cost.CostReport()
  by_bytes, by_flops = collections.Counter(), collections.Counter()
  for rec in walk.result.trace:
    cost = hlo_cost.op_cost(rec)
    rep.add(cost)
    key = f"{rec.op} {[shape for shape, _ in rec.ins[:3]]}"
    by_bytes[key] += cost.hbm_bytes
    by_flops[key] += cost.flops
  mf = model_flops(cfg, shape) / n_dev        # per-device share
  roof = hlo_cost.roofline_from_report(rep, model_flops=mf)
  result = {
      "arch": arch, "shape": shape.name, "mesh": mesh_name,
      "devices": n_dev, "optimizer": opt if shape.kind == "train" else None,
      "build_s": round(build_s, 1), "run_s": round(run_s, 1),
      "flops": rep.flops, "dot_flops": rep.dot_flops,
      "hbm_bytes": rep.hbm_bytes,
      "collective_bytes": rep.collective_bytes,
      "collective_wire_bytes": rep.collective_wire_bytes,
      "collective_by_kind": rep.collective_by_kind,
      "n_collectives": rep.n_collectives,
      "unknown_ops": rep.unknown_ops,
      "compute_s": roof.compute_s, "memory_s": roof.memory_s,
      "collective_s": roof.collective_s,
      "dominant": roof.dominant,
      "model_flops_per_dev": mf,
      "useful_flop_fraction": roof.useful_flop_fraction,
      "roofline_fraction": roof.roofline_fraction,
      "memory": dataclasses.asdict(live),
      "n_ops": walk.result.n_ops,
      "top_hbm_ops": by_bytes.most_common(TOP_OPS),
      "top_flop_ops": by_flops.most_common(TOP_OPS),
  }
  if verbose:
    print(f"[{arch} x {shape.name} x {mesh_name}] build {build_s:.0f}s "
          f"run {run_s:.0f}s dominant={roof.dominant} "
          f"compute={roof.compute_s:.4f}s memory={roof.memory_s:.4f}s "
          f"coll={roof.collective_s:.4f}s "
          f"useful={roof.useful_flop_fraction:.2f} "
          f"arg={live.input_bytes / 1e9:.2f}GB "
          f"peak={live.peak_bytes / 1e9:.2f}GB", flush=True)
  if save:
    os.makedirs(OUT_DIR, exist_ok=True)
    fname = f"{arch}__{shape.name}__{mesh_name}.json"
    with open(os.path.join(OUT_DIR, fname), "w") as f:
      json.dump(result, f, indent=1)
  return result


def main(argv=None) -> None:
  ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
  ap.add_argument("--arch", default=None)
  ap.add_argument("--shape", default=None)
  ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
  ap.add_argument("--all", action="store_true")
  ap.add_argument("--optimizer", default=None)
  args = ap.parse_args(argv)

  archs = configs.ARCH_NAMES if (args.all or not args.arch) else [args.arch]
  failures = []
  with fake_world():
    meshes = production_meshes()
    if args.mesh:
      meshes = {args.mesh: meshes[args.mesh]}
    for arch in archs:
      for shape in configs.shapes_for(arch):
        if args.shape and shape.name != args.shape:
          continue
        for mesh_name, mesh in meshes.items():
          try:
            run_cell(arch, shape, mesh_name, mesh, args.optimizer)
          except Exception as e:
            failures.append((arch, shape.name, mesh_name, repr(e)))
            print(f"FAILED [{arch} x {shape.name} x {mesh_name}]: {e}")
            traceback.print_exc()
  if failures:
    print(f"\n{len(failures)} FAILURES:")
    for f in failures:
      print(" ", f)
    raise SystemExit(1)
  print("\nAll dry-run cells ran.")


if __name__ == "__main__":
  main()
