"""Synthetic LM stream: deterministic, learnable, stateless in (seed,
step).

Sequences mix a fixed random bigram successor function (token_{t+1} =
perm[token_t]) with uniform noise; a model that learns the bigram table
drives cross-entropy well below the entropy of uniform sampling, so the
stream supports real training runs, not just shape checks. Any step's
batch can be drawn again, so a restart needs no loader state.

A copy of `repro.data.lm`: the same numpy `RandomState` draws in the
same order, so both packages draw bit-equal batches. `shard_batch`
places a batch on one device (the reference's takes a mesh's sharding;
a mesh is not ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
  vocab_size: int
  seq_len: int
  global_batch: int
  seed: int = 0
  structure: float = 0.8      # fraction of bigram-followed transitions


def _perm(cfg: LMDataConfig) -> np.ndarray:
  rng = np.random.RandomState(cfg.seed + 12345)
  return rng.permutation(cfg.vocab_size)


def batch_at(cfg: LMDataConfig, step: int) -> dict:
  """The batch of a global step: {tokens, targets} (B, S) int32 numpy,
  targets the tokens shifted by one."""
  rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2 ** 31))
  perm = _perm(cfg)
  b, s = cfg.global_batch, cfg.seq_len
  toks = np.empty((b, s + 1), np.int32)
  toks[:, 0] = rng.randint(0, cfg.vocab_size, size=b)
  structured = rng.rand(b, s) < cfg.structure
  noise = rng.randint(0, cfg.vocab_size, size=(b, s))
  for t in range(s):
    nxt = perm[toks[:, t]]
    toks[:, t + 1] = np.where(structured[:, t], nxt, noise[:, t])
  return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def stream(cfg: LMDataConfig, start_step: int = 0) -> Iterator[dict]:
  step = start_step
  while True:
    yield batch_at(cfg, step)
    step += 1


def shard_batch(batch: dict, device: DeviceLike = None) -> dict:
  """A host batch as int64 tensors on `device` (default: the GPU)."""
  dev = resolve_device(device)
  return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64, device=dev)
          for k, v in batch.items()}
