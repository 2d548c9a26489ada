"""Training loop: microbatched gradient accumulation, the paper's two-stage
schedule (stage-1 trace-norm training -> truncated-SVD warmstart ->
stage-2 fine-tune), trace-norm diagnostics, checkpoint and restart.

Counterpart of `repro.training.trainer`, for the deepspeech,
transformer (dense and DeepSeek: its loss adds the MoE aux loss and the
MTP head's) and whisper families. A step is the forward and backward of
every microbatch (autograd, with no kernel policy: no kernel has a
backward), the regularizer, and an in-place AdamW update. A transformer
batch {tokens, targets} goes to the trainer's device as int64 tensors
before the step, a whisper batch {frames, tokens, targets} as f32
frames and int64 tokens. The transition replaces the factored leaves
(full rank -> truncated), so it makes new parameters, turns their
gradients on, and starts new optimizer moments.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Optional, Union

import torch
from torch import nn

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.compress import FactorizationPlan, to_stage1, to_stage2
from repro_torch.core.factored import FactoredLinear, param_tree, trainable
from repro_torch.core.schedule import TwoStageSchedule
from repro_torch.core.tracenorm import (RegularizerConfig, regularization_loss,
                                        trace_norm_metrics)
from repro_torch.data.lm import shard_batch
from repro_torch.device import resolve_device
from repro_torch.layers.common import ModelConfig
from repro_torch.models.api import ModelApi, get_model
from repro_torch.optim import AdamWConfig, make_optimizer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  lr: Union[Callable[[int], float], float] = 1e-3
  optimizer: str = "adamw"
  adam: AdamWConfig = AdamWConfig(max_grad_norm=1.0)
  microbatches: int = 1
  regularizer: RegularizerConfig = RegularizerConfig()
  checkpoint_dir: Optional[str] = None
  checkpoint_every: int = 0          # steps; 0 = off
  async_checkpoint: bool = True


def _lr_at(lr, step: int) -> float:
  return float(lr(step)) if callable(lr) else float(lr)


def _slice(batch: dict, i: int, k: int) -> dict:
  """Microbatch i of k: a slice of every value's leading dim."""
  def one(x):
    mb = x.shape[0] // k
    return x[i * mb:(i + 1) * mb]
  return {key: one(x) for key, x in batch.items()}


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    api: Optional[ModelApi] = None,
                    reg: Optional[RegularizerConfig] = None):
  """Build (opt_init, step_fn): step_fn(params, opt_state, batch, step)
  -> (params, opt_state, metrics), updating params and opt_state in
  place. `step_fn.grads_of(params, batch)` -> (loss, metrics, grads) is
  its gradient half: k microbatches (`train_cfg.microbatches`) slice the
  leading dim, their f32 gradients are summed and divided by k, the loss
  is their mean and the metrics the last one's."""
  api = api or get_model(model_cfg)
  if api.loss_fn is None:
    raise NotImplementedError(
        f"no loss_fn for the {api.family} family yet: ROADMAP, \"Modules "
        "to port\"")
  reg = train_cfg.regularizer if reg is None else reg
  opt_init, opt_apply = make_optimizer(train_cfg.optimizer)

  def loss_fn(params, batch):
    loss, metrics = api.loss_fn(params, batch, model_cfg)
    if reg.kind != "none":
      r = regularization_loss(params, reg)
      metrics = dict(metrics, reg=r)
      loss = loss + r
    return loss, metrics

  def value_and_grads(params, batch):
    tree = param_tree(params)
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(tree.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(tree, grads)))

  def grads_of(params, batch):
    k = train_cfg.microbatches
    if k <= 1:
      return value_and_grads(params, batch)
    loss_sum, gsum = 0.0, None
    for i in range(k):
      loss, metrics, g = value_and_grads(params, _slice(batch, i, k))
      g = {name: x.float() for name, x in g.items()}
      gsum = g if gsum is None else {n: gsum[n] + g[n] for n in gsum}
      loss_sum = loss_sum + loss
    return loss_sum / k, metrics, {n: g / k for n, g in gsum.items()}

  def step_fn(params, opt_state, batch, step: int):
    loss, metrics, grads = grads_of(params, batch)
    lr = _lr_at(train_cfg.lr, step)
    params, opt_state, opt_metrics = opt_apply(
        params, grads, opt_state, lr, train_cfg.adam)
    metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
    return params, opt_state, metrics

  step_fn.grads_of = grads_of
  return opt_init, step_fn


def _shaped_as_stored(params: nn.Module, leaves: dict,
                      prefix: str = "params") -> nn.Module:
  """`params` with every FactoredLinear shaped as a checkpoint's manifest
  `leaves` stores it (unfactored, or factored at its rank), so a
  checkpoint of either stage restores into it."""
  out = copy.deepcopy(params)
  for pname, parent in list(out.named_modules()):
    for key, child in list(parent.named_children()):
      if not isinstance(child, FactoredLinear):
        continue
      path = "/".join(x for x in (prefix, pname.replace(".", "/"), key) if x)
      stored = {f: tuple(leaves[f"{path}/{f}"]["shape"]) for f in "wuv"
                if f"{path}/{f}" in leaves}
      have = {f: tuple(getattr(child, f).shape) for f in "wuv"
              if getattr(child, f) is not None}
      if stored and stored != have:
        like = dict(dtype=child.dtype, device=(child.u if child.is_factored
                                               else child.w).device)
        setattr(parent, key, FactoredLinear(
            **{f: torch.zeros(s, **like) for f, s in stored.items()},
            name=child.name, group=child.group))
  return out


class Trainer:
  """Drives make_train_step with the two-stage schedule and checkpoints.

  The model is drawn from `generator` (default: a CPU generator seeded
  with 0) on `device` (default: the GPU; the CPU only when asked). A
  mesh is not ported yet."""

  def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, *,
               schedule: Optional[TwoStageSchedule] = None,
               plan: Optional[FactorizationPlan] = None, mesh=None,
               generator: Optional[torch.Generator] = None, device=None):
    if mesh is not None:
      raise NotImplementedError(
          "Trainer(mesh=...) is not ported yet: ROADMAP, \"Distribution\"")
    self.model_cfg = model_cfg
    self.train_cfg = train_cfg
    self.schedule = schedule
    self.plan = plan or FactorizationPlan()
    self.api = get_model(model_cfg)
    self.device = resolve_device(device)
    gen = torch.Generator().manual_seed(0) if generator is None \
        else generator
    params = self.api.init(model_cfg, generator=gen, device=self.device)
    if schedule is not None and schedule.regularizer.kind == "trace":
      params = to_stage1(params, self.plan)     # full-rank factored form
    self.params = trainable(params)
    self.step = 0
    self.stage = 1 if schedule is not None else 0
    self._lr_scale = 1.0
    self._build(reg=self._current_reg())
    self.opt_state = self._opt_init(self.params)
    self.ckpt = (CheckpointManager(train_cfg.checkpoint_dir)
                 if train_cfg.checkpoint_dir else None)
    self.metrics_history: list[dict] = []

  def _current_reg(self) -> RegularizerConfig:
    if self.schedule is None:
      return self.train_cfg.regularizer
    return self.schedule.regularizer_at(self.step)

  def _build(self, reg: RegularizerConfig) -> None:
    tc = self.train_cfg
    if self._scaled_lr() is not tc.lr:
      tc = dataclasses.replace(tc, lr=self._scaled_lr())
    self._opt_init, self._step_fn = make_train_step(
        self.model_cfg, tc, self.api, reg=reg)

  def _scaled_lr(self):
    base = self.train_cfg.lr
    if self._lr_scale == 1.0:
      return base
    if callable(base):
      return lambda s: base(s) * self._lr_scale
    return base * self._lr_scale

  # -- two-stage transition ---------------------------------------------------

  def _enter_stage2(self) -> None:
    self.stage = 2
    self._lr_scale = self.schedule.stage2_lr_scale()
    self._build(reg=RegularizerConfig(kind="none"))

  def maybe_transition(self) -> bool:
    """Stage 1 -> stage 2 at the schedule's transition step (paper
    §3.2.3): truncated-SVD warmstart, no regularizer, the LR schedule
    continued (scaled by `stage2_lr_scale`), new moments (the shapes
    changed)."""
    if (self.schedule is None or self.stage != 1 or
        self.step < self.schedule.transition_step):
      return False
    self.params = trainable(to_stage2(self.params, self.plan,
                                      self.schedule.truncation))
    self._enter_stage2()
    self.opt_state = self._opt_init(self.params)
    return True

  # -- stepping ---------------------------------------------------------------

  def train_step(self, batch: dict) -> dict:
    self.maybe_transition()
    t0 = time.perf_counter()
    if self.api.family in ("transformer", "zamba"):
      batch = shard_batch(batch, self.device)
    elif self.api.family == "whisper":
      batch = {"frames": torch.as_tensor(batch["frames"], dtype=torch.float32,
                                         device=self.device),
               **shard_batch({k: batch[k] for k in ("tokens", "targets")},
                             self.device)}
    self.params, self.opt_state, metrics = self._step_fn(
        self.params, self.opt_state, batch, self.step)
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["step"] = self.step
    metrics["stage"] = self.stage
    metrics["wall_s"] = time.perf_counter() - t0
    self.metrics_history.append(metrics)
    self.step += 1
    if (self.ckpt and self.train_cfg.checkpoint_every and
        self.step % self.train_cfg.checkpoint_every == 0):
      self.save()
    return metrics

  def tracenorm_report(self) -> dict:
    """SVD diagnostics (nu, trace norm, frobenius, rank90) per factored
    GEMM."""
    return {k: {kk: float(vv) for kk, vv in m.items()}
            for k, m in trace_norm_metrics(self.params).items()}

  # -- checkpointing ----------------------------------------------------------

  def save(self, blocking: Optional[bool] = None) -> None:
    if self.ckpt is None:
      return
    blocking = (not self.train_cfg.async_checkpoint
                if blocking is None else blocking)
    self.ckpt.save(self.step, {"params": self.params,
                               "opt": self.opt_state},
                   extra={"step": self.step, "stage": self.stage},
                   blocking=blocking)

  def restore(self, step: Optional[int] = None) -> None:
    """Load a checkpoint of this package or the reference's. Its leaves'
    shapes decide the structure, so a stage-2 checkpoint restores into a
    trainer still at stage 1 (and moves it to stage 2)."""
    if self.ckpt is None:
      raise ValueError("no checkpoint dir configured")
    self.ckpt.wait()
    params = _shaped_as_stored(self.params,
                               self.ckpt.manifest(step)["leaves"])
    template = {"params": params, "opt": self._opt_init(params)}
    tree, extra = self.ckpt.restore(template, step=step)
    self.params = trainable(tree["params"])
    self.opt_state = tree["opt"]
    self.step = int(extra.get("step", 0))
    stage = int(extra.get("stage", self.stage))
    if stage == 2 and self.stage != 2:
      self._enter_stage2()
    elif stage != self.stage:               # back to stage 1 (or none)
      self.stage, self._lr_scale = stage, 1.0
      self._build(reg=self._current_reg())
