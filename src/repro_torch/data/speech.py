"""Synthetic speech task for the DS2/CTC reproduction.

WSJ (80 h audio) is not available offline; this pipeline generates random
"phone" strings and renders them to noisy mel-like feature sequences:
each label id owns a fixed random prototype feature vector, emitted for a
random duration (2-4 frames) with additive noise and random silence gaps.
A DS2 model must learn prototype->label mapping and CTC alignment — the
task exercises exactly the (acoustic model, CTC) pair the paper trains,
and its CER responds to capacity/regularization the way Figures 1-5 need
(see EXPERIMENTS.md for the scale caveat).

Batches are stateless in (seed, step). The module is numpy-only and a
copy of `repro.data.speech`: both packages draw identical batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpeechDataConfig:
  vocab_size: int = 32          # labels 1..vocab-1 (0 = CTC blank)
  feat_dim: int = 80
  min_label_len: int = 6
  max_label_len: int = 24
  # frames per phone: DS2's conv frontend strides time by 4x, and CTC needs
  # output_length >= label_length — min_dur 5 keeps every utterance feasible
  min_dur: int = 5
  max_dur: int = 8
  silence_prob: float = 0.15
  noise: float = 0.4
  global_batch: int = 16
  seed: int = 0

  @property
  def max_frames(self) -> int:
    return self.max_label_len * (self.max_dur + 2) + 8


def _prototypes(cfg: SpeechDataConfig) -> np.ndarray:
  rng = np.random.RandomState(cfg.seed + 777)
  return rng.randn(cfg.vocab_size, cfg.feat_dim).astype(np.float32)


def batch_at(cfg: SpeechDataConfig, step: int) -> dict:
  rng = np.random.RandomState((cfg.seed * 9_999_991 + step) % (2 ** 31))
  protos = _prototypes(cfg)
  b = cfg.global_batch
  t_max = cfg.max_frames
  l_max = cfg.max_label_len
  feats = np.zeros((b, t_max, cfg.feat_dim), np.float32)
  labels = np.zeros((b, l_max), np.int32)
  feat_lengths = np.zeros((b,), np.int32)
  label_lengths = np.zeros((b,), np.int32)
  for i in range(b):
    n = rng.randint(cfg.min_label_len, cfg.max_label_len + 1)
    seq = rng.randint(1, cfg.vocab_size, size=n)
    labels[i, :n] = seq
    label_lengths[i] = n
    t = 0
    for ph in seq:
      if rng.rand() < cfg.silence_prob:
        gap = rng.randint(1, 3)
        t += gap                      # silence = zeros
      dur = rng.randint(cfg.min_dur, cfg.max_dur + 1)
      feats[i, t:t + dur] = protos[ph][None, :]
      t += dur
    t = min(t + rng.randint(0, 4), t_max)
    feat_lengths[i] = t
  feats += rng.randn(*feats.shape).astype(np.float32) * cfg.noise
  return {"feats": feats, "feat_lengths": feat_lengths,
          "labels": labels, "label_lengths": label_lengths}


def stream(cfg: SpeechDataConfig, start_step: int = 0) -> Iterator[dict]:
  step = start_step
  while True:
    yield batch_at(cfg, step)
    step += 1


# ---------------------------------------------------------------------------
# CER metric (the paper's accuracy axis).
# ---------------------------------------------------------------------------

def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
  """Levenshtein distance between two int sequences."""
  la, lb = len(a), len(b)
  dp = np.arange(lb + 1)
  for i in range(1, la + 1):
    prev = dp.copy()
    dp[0] = i
    for j in range(1, lb + 1):
      cost = 0 if a[i - 1] == b[j - 1] else 1
      dp[j] = min(prev[j] + 1, dp[j - 1] + 1, prev[j - 1] + cost)
  return int(dp[lb])


def cer(decoded: np.ndarray, labels: np.ndarray,
        label_lengths: np.ndarray) -> float:
  """Character error rate from greedy-decoded sequences (-1 padded)."""
  total_err, total_len = 0, 0
  for i in range(len(labels)):
    hyp = decoded[i][decoded[i] >= 0]
    tgt = labels[i][:label_lengths[i]]
    total_err += edit_distance(hyp, tgt)
    total_len += len(tgt)
  return total_err / max(total_len, 1)
