"""Quickstart on the PyTorch port: compress a model with the paper's
two-stage recipe.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
        --steps 4 --transition 2

The same recipe as `examples/quickstart.py` (the JAX package's):
1. Build a small LM (the llama3-family smoke config, f32).
2. Stage 1: factor every large GEMM (W = UV, full rank) and train with
   the variational trace-norm penalty (paper eq. 3).
3. Stage 2: warmstart from the truncated SVD at a 90% explained-variance
   threshold and fine-tune without regularization.
4. Report the parameter reduction and per-GEMM rank/nu diagnostics.

`--device` defaults to the GPU and raises without one.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core.compress import FactorizationPlan
from repro_torch.core.factored import count_params
from repro_torch.core.schedule import TwoStageSchedule
from repro_torch.core.svd import TruncationSpec
from repro_torch.core.tracenorm import RegularizerConfig
from repro_torch.data.lm import LMDataConfig, batch_at
from repro_torch.training import TrainConfig, Trainer


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=60)
  ap.add_argument("--transition", type=int, default=40)
  ap.add_argument("--device", default=None,
                  help="torch device (default: the GPU)")
  args = ap.parse_args(argv)

  cfg = configs.get_smoke("llama3-8b").with_(vocab_size=256,
                                             dtype=torch.float32)
  data = LMDataConfig(vocab_size=256, seq_len=64, global_batch=8)
  schedule = TwoStageSchedule(
      total_steps=args.steps, transition_step=args.transition,
      regularizer=RegularizerConfig(kind="trace", lambda_rec=1e-4,
                                    lambda_nonrec=1e-4),
      truncation=TruncationSpec(variance_threshold=0.9, round_to=8))
  plan = FactorizationPlan(min_dim=64)

  trainer = Trainer(cfg, TrainConfig(lr=1e-3), schedule=schedule, plan=plan,
                    device=args.device)
  p0 = count_params(trainer.params)
  print(f"stage-1 (full-rank factored) params: {p0:,}")
  losses = []
  for step in range(args.steps):
    m = trainer.train_step(batch_at(data, step))
    losses.append(float(m["loss"]))
    if step % 10 == 0 or step == args.steps - 1:
      print(f"  step {step:3d} stage {m['stage']} loss {m['loss']:.3f}")

  p1 = count_params(trainer.params)
  print(f"stage-2 (rank-truncated) params:     {p1:,}  "
        f"({100 * (1 - p1 / p0):.0f}% smaller)")
  print("\nper-GEMM diagnostics (nu, rank @ 90% variance):")
  report = trainer.tracenorm_report()
  for name, r in list(report.items())[:6]:
    print(f"  {name:28s} nu={r['nu']:.3f} rank90={int(r['rank90'])}")
  return dict(params_before=p0, params_after=p1, losses=losses,
              stage=int(m["stage"]), report=report)


if __name__ == "__main__":
  main()
