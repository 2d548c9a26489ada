"""One dispatch surface over the ported model families — counterpart of
`repro.models.api`, as far as serving and training need it.

`get_model(cfg)` returns a `ModelApi` for the `transformer`, `zamba`,
`whisper` and `deepspeech` families with `init`, `forward`, `encode` (whisper's
encoder), `loss_fn`,
`init_decode_state`, `decode_step`, `decode_state_batch_axes`, the
speculative-rewind
contract `decode_state_carry`, the batched window `decode_window` (and
its oracle `decode_window_sequential`) and the slot surgery
`insert_slot` (over every stack's cache: a DeepSeek state has "dense"
and "moe"). Decode states are nested dicts of tensors; `insert_slot`
writes into the batched state in place (the reference returns a new
tree). `cast_kv_cache` narrows only attention-KV leaves. The other
families and the prefix-snapshot contract come with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.layers.common import ModelConfig
from repro_torch.models import deepspeech, transformer, whisper, zamba

__all__ = ["KV_CACHE_KEYS", "ModelApi", "cast_kv_cache", "get_model"]

#: leaf names that tag an attention KV cache inside a decode state; every
#: other leaf (GRU hidden states, ...) is a recurrent carry kept at its
#: working precision
KV_CACHE_KEYS = frozenset({"k", "v", "c_kv", "k_rope"})


def _map(fn, tree: dict, *rest: dict, key: Optional[str] = None):
  """fn(key, leaf, *leaves) over nested dicts of one structure."""
  if isinstance(tree, dict):
    return {k: _map(fn, v, *(r[k] for r in rest), key=k)
            for k, v in tree.items()}
  return fn(key, tree, *rest)


def cast_kv_cache(state: dict, dtype) -> dict:
  """Cast only the attention KV-cache leaves of a decode state to
  `dtype` (None: unchanged). The KV cache is written once and read many
  times, so a narrower copy halves its traffic; recurrent carries are
  read and written every step and keep their precision."""
  if dtype is None:
    return state
  return _map(lambda k, x: x.to(dtype)
              if k in KV_CACHE_KEYS and x.is_floating_point() else x, state)


@dataclasses.dataclass(frozen=True)
class ModelApi:
  """One model family behind a uniform callable surface. `decode_step`
  is (params, state, token (b, 1) or frame (b, 1, f), positions (b,),
  cfg, policy) -> (logits (b, 1, v), new state); `policy` is a
  `kernels.dispatch.KernelPolicy` (None: the plain path)."""
  family: str
  init: Callable
  forward: Optional[Callable] = None
  # (params, batch, cfg) -> (loss, metrics)
  loss_fn: Optional[Callable] = None
  init_decode_state: Optional[Callable] = None
  decode_step: Optional[Callable] = None
  # cfg -> nested dict of ints: the batch axis of every decode-state leaf
  decode_state_batch_axes: Optional[Callable] = None
  # cfg -> nested dict of bools of the decode state's structure: True for
  # read-modify-write carries (GRU hiddens, Mamba2 SSM states and conv
  # tails) that a speculative rewind
  # restores from a pre-draft snapshot and replays through the accepted
  # prefix; False for attention KV rows, written at absolute positions,
  # whose rewind is the position counter alone
  decode_state_carry: Optional[Callable] = None
  # family batched window: (params, state, tokens (b, W), positions (b,),
  # cfg, policy) -> (logits (b, W, v), state after the W tokens), the
  # whole window in one weight pass; each row equals W sequential
  # `decode_step`s' to f32 summation order (the port's GEMMs block b*W
  # rows differently from b rows, so not bit for bit as on the reference)
  decode_window_batched: Optional[Callable] = None
  # encoder-decoder families: (params, frames (b, t, d), cfg, policy) ->
  # memory (b, t, d), which the decode state's "mem" holds
  encode: Optional[Callable] = None

  @property
  def decodable(self) -> bool:
    return self.decode_step is not None

  def decode_window(self, params, state, tokens, positions,
                    cfg: ModelConfig, policy=None):
    """Decode a W-token window: tokens (b, W) ids, or (b, W, f) frames
    for deepspeech, fed at positions `positions + t`; returns (logits
    (b, W, v) f32, state after all W steps). Routes to the family's
    `decode_window_batched`, or to `decode_window_sequential` where the
    family has none. The caller owns undoing a rejected suffix (see
    `decode_state_carry`)."""
    if not self.decodable:
      raise ValueError(f"{self.family} has no decode path")
    if self.decode_window_batched is None:
      return self.decode_window_sequential(params, state, tokens, positions,
                                           cfg, policy)
    logits, state = self.decode_window_batched(params, state, tokens,
                                               positions, cfg, policy)
    return logits.float(), state

  def decode_window_sequential(self, params, state, tokens, positions,
                               cfg: ModelConfig, policy=None):
    """The W-token window as W `decode_step`s, one position each: the
    oracle of `decode_window` and the fallback of a family without a
    batched window; same semantics."""
    if not self.decodable:
      raise ValueError(f"{self.family} has no decode path")
    logits = []
    for t in range(tokens.shape[1]):
      lg, state = self.decode_step(params, state, tokens[:, t:t + 1],
                                   positions + t, cfg, policy)
      logits.append(lg[:, 0].float())
    return torch.stack(logits, dim=1), state

  def _slot_axes(self, cfg: ModelConfig) -> dict:
    if self.decode_state_batch_axes is None:
      raise ValueError(
          f"{self.family} does not define decode_state_batch_axes")
    return self.decode_state_batch_axes(cfg)

  def insert_slot(self, cfg: ModelConfig, state: dict, slot_state: dict,
                  slot: int) -> dict:
    """Write a batch-1 `slot_state` into slot `slot` of `state`, in
    place; returns `state`."""
    def put(_, x, s, ax):
      x.narrow(ax, slot, 1).copy_(s)
      return x
    _map(put, state, slot_state, self._slot_axes(cfg))
    return state


def get_model(cfg: ModelConfig) -> ModelApi:
  fam = cfg.family
  if fam == "transformer":
    return ModelApi(
        family=fam, init=transformer.init_lm, loss_fn=transformer.loss_fn,
        forward=transformer.forward,
        init_decode_state=transformer.init_decode_state,
        decode_step=transformer.decode_step,
        decode_state_batch_axes=transformer.decode_state_batch_axes,
        decode_state_carry=transformer.decode_state_carry,
        decode_window_batched=transformer.decode_window)
  if fam == "zamba":
    return ModelApi(
        family=fam, init=zamba.init_lm, loss_fn=zamba.loss_fn,
        forward=zamba.forward, init_decode_state=zamba.init_decode_state,
        decode_step=zamba.decode_step,
        decode_state_batch_axes=zamba.decode_state_batch_axes,
        decode_state_carry=zamba.decode_state_carry,
        decode_window_batched=zamba.decode_window)
  if fam == "whisper":
    return ModelApi(
        family=fam, init=whisper.init_model, loss_fn=whisper.loss_fn,
        forward=None, init_decode_state=whisper.init_decode_state,
        decode_step=whisper.decode_step, encode=whisper.encode,
        decode_state_batch_axes=whisper.decode_state_batch_axes,
        decode_state_carry=whisper.decode_state_carry,
        decode_window_batched=whisper.decode_window)
  if fam == "deepspeech":
    return ModelApi(
        family=fam, init=deepspeech.init_model, forward=deepspeech.forward,
        loss_fn=deepspeech.loss_fn,
        init_decode_state=lambda cfg, batch, max_len=None, cache_dtype=None,
        device=None: deepspeech.init_decode_state(cfg, batch, device),
        decode_step=deepspeech.api_decode_step,
        decode_state_batch_axes=deepspeech.decode_state_batch_axes,
        decode_state_carry=deepspeech.decode_state_carry,
        decode_window_batched=deepspeech.api_decode_window)
  raise ValueError(f"model family {fam!r} is not ported yet")
