"""End-to-end example on the PyTorch port: train the paper's DS2 acoustic
model with the two-stage trace-norm recipe on the synthetic speech task,
with checkpointing and a supervised (fault-tolerant) step loop, then
report CER before and after and the compression achieved.

    PYTHONPATH=src python examples/train_speech_e2e_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_speech_e2e_torch.py --device cpu \
        --steps 4 --transition 2

The same recipe as `examples/train_speech_e2e.py` (the JAX package's),
at the smoke width of `deepspeech2-wsj` in f32. `--device` defaults to
the GPU and raises without one; `--full` trains the full-width config.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.compress import FactorizationPlan
from repro_torch.core.factored import count_params
from repro_torch.core.schedule import TwoStageSchedule
from repro_torch.core.svd import TruncationSpec
from repro_torch.core.tracenorm import RegularizerConfig
from repro_torch.data.speech import SpeechDataConfig, batch_at, cer
from repro_torch.models import deepspeech
from repro_torch.models.ctc import ctc_greedy_decode
from repro_torch.runtime import Supervisor
from repro_torch.training import TrainConfig, Trainer


@torch.no_grad()
def evaluate(trainer, cfg, dc, batches=3) -> float:
  scores = []
  for j in range(batches):
    b = batch_at(dc, 5000 + j)
    dev = trainer.device
    lp = deepspeech.forward(trainer.params,
                            torch.as_tensor(b["feats"], device=dev), cfg)
    ol = deepspeech.output_lengths(
        torch.as_tensor(b["feat_lengths"], device=dev), cfg)
    scores.append(cer(ctc_greedy_decode(lp, ol).cpu().numpy(), b["labels"],
                      b["label_lengths"]))
  return float(np.mean(scores))


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=300)
  ap.add_argument("--transition", type=int, default=180)
  ap.add_argument("--device", default=None,
                  help="torch device (default: the GPU)")
  ap.add_argument("--full", action="store_true",
                  help="the full-width deepspeech2-wsj config")
  ap.add_argument("--checkpoint-dir", default=None)
  args = ap.parse_args(argv)

  get = configs.get_config if args.full else configs.get_smoke
  cfg = get("deepspeech2-wsj").with_(dtype=torch.float32)
  dc = SpeechDataConfig(vocab_size=cfg.vocab_size, feat_dim=cfg.feat_dim,
                        global_batch=8, max_label_len=12, noise=0.2)
  ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="ds2_ckpt_")
  every = max(1, min(50, args.steps // 2))

  schedule = TwoStageSchedule(
      total_steps=args.steps, transition_step=args.transition,
      regularizer=RegularizerConfig(kind="trace", lambda_rec=3e-5,
                                    lambda_nonrec=3e-5),
      truncation=TruncationSpec(variance_threshold=0.9, round_to=8))
  trainer = Trainer(
      cfg, TrainConfig(lr=1e-3, checkpoint_dir=ckpt_dir,
                       checkpoint_every=every, async_checkpoint=True),
      schedule=schedule, plan=FactorizationPlan(min_dim=48),
      device=args.device)
  supervisor = Supervisor(restore=trainer.restore)

  params_before = count_params(trainer.params)
  cer_before = evaluate(trainer, cfg, dc)
  print(f"stage-1 params {params_before:,}; "
        f"CER before training: {cer_before:.3f}")
  step, losses = 0, []
  while step < args.steps:
    m = supervisor.run_step(
        step, lambda: trainer.train_step(batch_at(dc, trainer.step)))
    losses.append(m["loss"])
    if step % 50 == 0 or step == args.steps - 1:
      print(f"  step {m['step']:4d} stage {m['stage']} "
            f"loss {m['loss']:7.3f} wall {m['wall_s']:.2f}s")
    step = trainer.step
  trainer.save(blocking=True)

  params_after = count_params(trainer.params)
  cer_after = evaluate(trainer, cfg, dc)
  print(f"stage-2 params {params_after:,}; "
        f"CER after training: {cer_after:.3f}")
  print(f"stragglers flagged: {len(supervisor.events.stragglers)}; "
        f"checkpoints in {ckpt_dir}")
  return {"cer_before": cer_before, "cer_after": cer_after,
          "params_before": params_before, "params_after": params_after,
          "losses": losses, "stage": trainer.stage,
          "checkpoints": trainer.ckpt.all_steps()}


if __name__ == "__main__":
  main()
