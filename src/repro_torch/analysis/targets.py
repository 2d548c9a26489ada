"""Audit programs: the serving programs, each run once under the op walk.

Counterpart of `repro/analysis/targets.py`, with its grid
(`DEFAULT_CONFIGS` x `POLICIES` x `QUANTS` x `PROGRAMS`) and geometry.
The reference traces each program abstractly; eager PyTorch has no
trace, so the port runs each smoke program once, on real tensors on the
target device, under `op_walk.OpWalk` (milliseconds on the CPU):

  program   runs                                    as the engine does
  decode    ModelApi.decode_step                    LMEngine's step
  window    ModelApi.decode_window                  speculative verify
  prefill   PROMPT_LEN decode steps from a fresh    LMEngine's admission
            state (token-driven families)           (`_prefill_slot`)
  train     ModelApi.loss_fn's forward              Trainer (plain only)

Weights come from the family's own init (seed 0), the int8 rows from
`quant.quantize_params` of them. The policies keep the reference's
names: "jnp" is `KernelPolicy(mode="jnp_only")`, "pallas"
`dispatch.decode_policy(BATCH)`, the kernels (a window's B x W rows are
past that bound and route as the reference's do).

With `ledgers=True` each program is walked with its trace kept, and
its target carries the cost ledger (`dist.hlo_cost.analyze_walk`) and
the memory ledger (`liveness.estimate` over the program's arguments:
parameters, decode state, inputs; the state as donated), which
`budgets.program_ledger` reads.

Besides its walk, each decode and window target keeps what
`checks.check_transfer_lint` reads: every decode-state tensor's shape,
dtype and storage before and after the step (the torch form of the
reference's donation check: a state written in place keeps its
storage), and, on the card, the first error a warmed run raised under
`torch.cuda.set_sync_debug_mode("error")`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional

import torch

from repro_torch import configs
from repro_torch.analysis import liveness
from repro_torch.analysis.op_walk import OpWalk, WalkResult, param_seeds
from repro_torch.device import resolve_device
from repro_torch.dist import hlo_cost
from repro_torch.kernels import dispatch
from repro_torch.layers.common import ShapeConfig
from repro_torch.models.api import get_model
from repro_torch.quant.ptq import quantize_params

#: the five model families, one production config each
DEFAULT_CONFIGS = ("qwen3-4b", "zamba2-7b", "xlstm-350m", "whisper-small",
                   "deepspeech2-wsj")
POLICIES = ("jnp", "pallas")
QUANTS = ("float", "int8")
PROGRAMS = ("decode", "window", "prefill", "train")

#: audit geometry — the reference's
BATCH = 2
MAX_LEN = 16
WINDOW = 3
PROMPT_LEN = 8
TRAIN_SEQ = 64


def normalize_config(name: str) -> str:
  """CLI convenience: qwen3_4b -> qwen3-4b."""
  hyphen = name.replace("_", "-")
  if hyphen in configs._MODULES:
    return hyphen
  return name


def policy_of(policy: str):
  """The port's KernelPolicy for a reference policy name."""
  if policy == "jnp":
    return dispatch.JNP_ONLY
  if policy == "pallas":
    return dispatch.decode_policy(BATCH)
  raise ValueError(f"unknown audit policy {policy!r} (jnp | pallas)")


@dataclasses.dataclass
class RunTarget:
  config: str
  family: str
  policy: str                    # "jnp" | "pallas" | "-"
  quant: str                     # "float" | "int8"
  program: str
  walk: WalkResult
  dispatch_log: list             # DispatchRecords of the walked run
  #: {state path: ((shape, dtype, storage) before, (...) after)}; empty
  #: for programs that take no decode state across a step
  state: dict
  sync_error: Optional[str]      # first sync error on the card, or None
  device: str
  cost: Optional[object] = None  # hlo_cost.CostReport (ledgers=True)
  live: Optional[object] = None  # liveness.LivenessReport (ledgers=True)

  @property
  def coord(self) -> dict:
    return dict(config=self.config, policy=self.policy, quant=self.quant,
                program=self.program)


def _leaves(tree, prefix: str = "") -> Iterator[tuple]:
  if isinstance(tree, torch.Tensor):
    yield prefix, tree
  elif isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))


def state_signature(state) -> dict:
  """{path: (shape, dtype, storage address)} of every tensor of a decode
  state."""
  return {k: (tuple(t.shape), t.dtype, t.untyped_storage().data_ptr())
          for k, t in _leaves(state)}


def sync_error(fn, device: torch.device) -> Optional[str]:
  """Run `fn` (warmed) under sync debug mode "error" on the card; the
  first line of the error it raised, or None. None on the CPU."""
  if device.type != "cuda":
    return None
  torch.cuda.synchronize(device)
  torch.cuda.set_sync_debug_mode("error")
  try:
    fn()
  except RuntimeError as e:
    return str(e).splitlines()[0]
  finally:
    torch.cuda.set_sync_debug_mode(0)
  return None


def run_program(fn, seeds, *, keep_trace: bool = False):
  """`fn()` once under an `OpWalk` seeded from `seeds`; returns (its
  result, the walk, the dispatch log)."""
  walk = OpWalk(seeds, keep_trace=keep_trace)
  with torch.no_grad(), walk:
    out = fn()
  return out, walk, list(walk.log)


def _ledgers(walk: OpWalk, out, inputs, donated=None) -> dict:
  """The cost and memory ledgers of a walked program (kept trace)."""
  return dict(cost=hlo_cost.analyze_walk(walk.result.trace),
              live=liveness.estimate(walk.result, walk, outputs=out,
                                     inputs=inputs, donated=donated))


def _train_batch(cfg, gen: torch.Generator, device) -> dict:
  from repro_torch.configs import specs
  spec = specs.input_specs(cfg, ShapeConfig("audit_train", "train",
                                            TRAIN_SEQ, BATCH))
  out = {}
  for k, s in spec.items():
    if k.endswith("_lengths"):
      n = spec["feats" if k == "feat_lengths" else "labels"].shape[1]
      out[k] = torch.full(tuple(s.shape), n, dtype=s.dtype)
    elif s.dtype.is_floating_point:
      out[k] = torch.randn(tuple(s.shape), generator=gen).to(s.dtype)
    else:
      out[k] = torch.randint(1, cfg.vocab_size, tuple(s.shape),
                             generator=gen).to(s.dtype)
  return {k: v.to(device) for k, v in out.items()}


def iter_targets(config_names: Iterable[str] = DEFAULT_CONFIGS,
                 policies: Iterable[str] = POLICIES,
                 quants: Iterable[str] = QUANTS,
                 programs: Iterable[str] = PROGRAMS,
                 *, device=None, ledgers: bool = False
                 ) -> Iterator[RunTarget]:
  """Yield every RunTarget of the requested grid, each program run once
  on `device` (default: the GPU); with `ledgers`, each with its cost and
  memory ledgers."""
  device = resolve_device(device)
  for name in config_names:
    name = normalize_config(name)
    cfg = configs.get_smoke(name)
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    float_params = api.init(cfg, generator=gen, device=device)
    for p in float_params.parameters():
      p.requires_grad_(False)
    params_by_quant = {"float": float_params}
    if cfg.family == "deepspeech":
      freq = ((cfg.feat_dim + 1) // 2 + 1) // 2
      width = (freq * cfg.conv_channels,)
      tok = torch.randn((BATCH, 1) + width, generator=gen).to(device)
      win_tok = torch.randn((BATCH, WINDOW) + width,
                            generator=gen).to(device)
    else:
      tok = torch.randint(1, cfg.vocab_size, (BATCH, 1),
                          generator=gen).to(device)
      win_tok = torch.randint(1, cfg.vocab_size, (BATCH, WINDOW),
                              generator=gen).to(device)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=gen).to(device)
    pos = torch.full((BATCH,), 3, dtype=torch.int64, device=device)

    def fresh():
      return api.init_decode_state(cfg, BATCH, MAX_LEN, device=device)

    for quant in quants:
      if quant == "int8" and quant not in params_by_quant:
        params_by_quant["int8"] = quantize_params(float_params)
      params = params_by_quant[quant]
      seeds = param_seeds(params)
      if quant == "int8" and not any(t.dtype == torch.int8 for t in seeds):
        continue    # nothing quantized at this scale: target is vacuous

      for policy in policies:
        pol = policy_of(policy)

        runs = {
            "decode": lambda s, t: api.decode_step(params, s, t, pos, cfg,
                                                   pol),
            "window": lambda s, t: api.decode_window(params, s, t, pos,
                                                     cfg, pol),
        }
        for program, inputs in (("decode", tok), ("window", win_tok)):
          if program not in programs:
            continue
          step = runs[program]
          # warm on a state of its own (the card's first call builds
          # the kernels), then the sync check, then the walked run
          step(fresh(), inputs)
          sync = sync_error(lambda: step(fresh(), inputs), device)
          state = fresh()
          before = state_signature(state)
          out, walk, log = run_program(lambda: step(state, inputs), seeds,
                                       keep_trace=ledgers)
          after = state_signature(out[1])
          yield RunTarget(name, cfg.family, policy, quant, program,
                          walk.result, log,
                          {k: (before.get(k), after.get(k))
                           for k in set(before) | set(after)},
                          sync, device.type,
                          **(_ledgers(walk, out, (params, state, inputs,
                                                  pos), state)
                             if ledgers else {}))

        if "prefill" in programs and cfg.family != "deepspeech":
          # token-driven only: DS2 prefills frame-synchronously through
          # the streaming server
          def prefill(state):
            lg = None
            for t in range(PROMPT_LEN):
              lg, state = api.decode_step(params, state,
                                          prompts[:, t:t + 1],
                                          torch.full_like(pos, t), cfg,
                                          pol)
            return lg, state
          prefill(fresh())
          sync = sync_error(lambda: prefill(fresh()), device)
          state = fresh()
          out, walk, log = run_program(lambda: prefill(state), seeds,
                                       keep_trace=ledgers)
          yield RunTarget(name, cfg.family, policy, quant, "prefill",
                          walk.result, log, {}, sync, device.type,
                          **(_ledgers(walk, out, (params, state, prompts,
                                                  pos))
                             if ledgers else {}))

    if "train" in programs:
      # loss_fn threads no KernelPolicy (training is the plain surface),
      # so the train program has one coordinate: float x "-"
      batch = _train_batch(cfg, gen, device)
      out, walk, log = run_program(
          lambda: api.loss_fn(float_params, batch, cfg),
          param_seeds(float_params), keep_trace=ledgers)
      yield RunTarget(name, cfg.family, "-", "float", "train",
                      walk.result, log, {}, None, device.type,
                      **(_ledgers(walk, out, (float_params, batch))
                         if ledgers else {}))
