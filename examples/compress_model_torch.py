"""Offline compression on the PyTorch port: take trained (unfactored)
weights, apply the paper's stage-2 truncated-SVD warmstart at several
thresholds, and print the accuracy-vs-parameters trade-off table (the
Fig. 4 workflow as a tool). Works on any arch in the registry.

    PYTHONPATH=src python examples/compress_model_torch.py --arch xlstm-350m
    PYTHONPATH=src python examples/compress_model_torch.py --device cpu \
        --pretrain-steps 2

The same pipeline as `examples/compress_model.py` (the JAX package's),
at the smoke width of `--arch` in f32. `--device` defaults to the GPU
and raises without one.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core.compress import FactorizationPlan, to_stage2
from repro_torch.core.factored import count_params
from repro_torch.core.svd import TruncationSpec
from repro_torch.data.lm import LMDataConfig, batch_at
from repro_torch.models.api import get_model
from repro_torch.training import TrainConfig, Trainer

THRESHOLDS = (0.99, 0.95, 0.9, 0.8, 0.6)


def main(argv=None) -> list:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default="xlstm-350m",
                  choices=configs.ARCH_NAMES)
  ap.add_argument("--pretrain-steps", type=int, default=40)
  ap.add_argument("--device", default=None,
                  help="torch device (default: the GPU)")
  args = ap.parse_args(argv)

  cfg = configs.get_smoke(args.arch).with_(vocab_size=128,
                                           dtype=torch.float32)
  dc = LMDataConfig(vocab_size=128, seq_len=32, global_batch=8)
  api = get_model(cfg)

  # "pretrained" model: a short unregularized training run
  trainer = Trainer(cfg, TrainConfig(lr=1e-3), device=args.device)
  for i in range(args.pretrain_steps):
    trainer.train_step(batch_at(dc, i))
  base = trainer.params
  dev = trainer.device

  @torch.no_grad()
  def eval_loss(params) -> float:
    b = batch_at(dc, 900)
    loss, _ = api.loss_fn(params, {k: torch.as_tensor(v, device=dev)
                                   for k, v in b.items()}, cfg)
    return float(loss)

  plan = FactorizationPlan(min_dim=48)
  print(f"{'threshold':>10} {'params':>12} {'reduction':>10} "
        f"{'eval loss':>10}")
  rows = [("dense", count_params(base), 0.0, eval_loss(base))]
  print(f"{'dense':>10} {rows[0][1]:>12,} {'-':>10} {rows[0][3]:>10.3f}")
  # NOTE: without stage-1 trace-norm regularization the weights are near
  # full rank, so high thresholds can *grow* the model (rank r costs
  # r(m+n) > mn params once r > mn/(m+n)) — exactly the paper's argument
  # for regularizing before truncating (Figs. 2-4).
  for thr in THRESHOLDS:
    comp = to_stage2(base, plan, TruncationSpec(variance_threshold=thr,
                                                round_to=8))
    p = count_params(comp)
    red = 100 * (1 - p / rows[0][1])
    rows.append((thr, p, red, eval_loss(comp)))
    print(f"{thr:>10} {p:>12,} {red:>9.1f}% {rows[-1][3]:>10.3f}")
  return rows


if __name__ == "__main__":
  main()
