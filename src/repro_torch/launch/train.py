"""Training entry point of the port: the deepspeech, transformer (dense
and DeepSeek), zamba, xlstm and whisper branches of `repro.launch.train`, with
its flags and `--device`. A DeepSeek config's loss lines also print the MoE
aux loss and, with MTP, the MTP head's cross-entropy.

Examples (on a machine with a GPU; `--device cpu` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepspeech2-wsj \
      --device cpu --steps 6 --two-stage --transition 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --device cpu --steps 6 --two-stage --transition 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \
      --device cpu --steps 6 --two-stage --transition 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \
      --device cpu --steps 6 --two-stage --transition 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
      --device cpu --steps 6 --two-stage --transition 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
      --device cpu --steps 6 --two-stage --transition 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepspeech2-wsj \
      --full --steps 8 --batch 16 --two-stage --transition 4
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.compress import FactorizationPlan
from repro_torch.core.schedule import TwoStageSchedule, cosine_schedule
from repro_torch.core.svd import TruncationSpec
from repro_torch.core.tracenorm import RegularizerConfig
from repro_torch.data import lm as lm_data
from repro_torch.data import speech as speech_data
from repro_torch.training import TrainConfig, Trainer


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
  ap.add_argument("--steps", type=int, default=30)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=64)
  ap.add_argument("--lr", type=float, default=1e-3)
  ap.add_argument("--microbatches", type=int, default=1)
  ap.add_argument("--full", action="store_true",
                  help="the full config (default: the smoke config)")
  ap.add_argument("--two-stage", action="store_true")
  ap.add_argument("--transition", type=int, default=0)
  ap.add_argument("--lambda-rec", type=float, default=1e-4)
  ap.add_argument("--lambda-nonrec", type=float, default=1e-4)
  ap.add_argument("--reg", default="trace", choices=["trace", "l2", "none"])
  ap.add_argument("--variance", type=float, default=0.9)
  ap.add_argument("--checkpoint-dir", default=None)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
  args = ap.parse_args(argv)

  cfg = (configs.get_config(args.arch) if args.full
         else configs.get_smoke(args.arch))

  schedule = None
  plan = FactorizationPlan(min_dim=32, exclude=("*embed*",))
  if args.two_stage:
    schedule = TwoStageSchedule(
        total_steps=args.steps,
        transition_step=args.transition or args.steps // 2,
        regularizer=RegularizerConfig(kind=args.reg,
                                      lambda_rec=args.lambda_rec,
                                      lambda_nonrec=args.lambda_nonrec),
        truncation=TruncationSpec(variance_threshold=args.variance,
                                  round_to=8),
    )

  tcfg = TrainConfig(lr=cosine_schedule(args.lr, args.steps // 10,
                                        args.steps),
                     microbatches=args.microbatches,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=max(args.steps // 4, 1)
                     if args.checkpoint_dir else 0)
  trainer = Trainer(cfg, tcfg, schedule=schedule, plan=plan,
                    generator=torch.Generator().manual_seed(args.seed),
                    device=args.device)

  if cfg.family == "deepspeech":
    dc = speech_data.SpeechDataConfig(vocab_size=cfg.vocab_size,
                                      feat_dim=cfg.feat_dim,
                                      global_batch=args.batch, seed=args.seed)
    gen = lambda i: speech_data.batch_at(dc, i)  # noqa: E731
  elif cfg.family == "whisper":
    dcl = lm_data.LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=args.seed)

    def gen(i):
      # the frontend is a stub: seeded random frame embeddings, as the
      # reference's launch/train.py draws them
      b = lm_data.batch_at(dcl, i)
      frames = np.random.RandomState(i).randn(
          args.batch, args.seq, cfg.d_model).astype(np.float32)
      return {"frames": frames, "tokens": b["tokens"],
              "targets": b["targets"]}
  else:                 # the token LMs: transformer, zamba and xlstm
    dcl = lm_data.LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=args.seed)
    gen = lambda i: lm_data.batch_at(dcl, i)  # noqa: E731
  for i in range(args.steps):
    m = trainer.train_step(gen(i))
    if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
      parts = "".join(f" {k} {m[k]:.4f}" for k in ("moe_aux", "mtp")
                      if k in m and cfg.moe is not None)
      print(f"step {m['step']:4d} stage {m['stage']} "
            f"loss {m['loss']:.4f}{parts} wall {m['wall_s']:.2f}s",
            flush=True)
  if trainer.ckpt is not None:
    trainer.ckpt.wait()

  if args.two_stage:
    print("\ntrace-norm diagnostics (first 5 GEMMs):")
    rep = trainer.tracenorm_report()
    for name in list(rep)[:5]:
      r = rep[name]
      print(f"  {name:32s} nu={r['nu']:.3f} rank90={int(r['rank90'])}")
  out = {"final_loss": trainer.metrics_history[-1]["loss"]}
  print(json.dumps(out))
  return out


if __name__ == "__main__":
  main()
