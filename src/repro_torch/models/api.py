"""One dispatch surface over the ported model families — counterpart of
`repro.models.api`, as far as serving and training need it.

`get_model(cfg)` returns a `ModelApi` for the `transformer`, `zamba`,
`xlstm`, `whisper` and `deepspeech` families with `init`, `forward`,
`encode` (whisper's encoder), `loss_fn`, `init_decode_state`,
`decode_step`, `decode_state_batch_axes`, the speculative-rewind
contract `decode_state_carry`, the batched window `decode_window` (and
its oracle `decode_window_sequential`), the slot surgery (`insert_slot`,
`extract_slot`, `reset_slot`, over every stack's cache: a DeepSeek state
has "dense" and "moe") and the prefix-snapshot contract
(`decode_state_length_axes`, `prefix_view`, `slot_snapshot`,
`splice_prefix`). Decode states are nested dicts of tensors;
`insert_slot`, `reset_slot` and `splice_prefix` write into the state
they are given, in place (the reference returns a new tree), and
`extract_slot`, `prefix_view` and `slot_snapshot` return copies, which a
later in-place step does not change. `cast_kv_cache` narrows only
attention-KV leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.dist.sharding import assign, cut_prefix, slot_of, splice_cut
from repro_torch.layers.common import ModelConfig
from repro_torch.models import (deepspeech, transformer, whisper,
                                xlstm_model, zamba)

__all__ = ["KV_CACHE_KEYS", "ModelApi", "cast_kv_cache", "get_model"]

#: leaf names that tag an attention KV cache inside a decode state; every
#: other leaf (GRU hidden states, SSM and xLSTM carries, Whisper's encoder
#: memory) is a carry or a step-invariant leaf, kept at its working
#: precision and copied whole into a prefix snapshot
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
  # tails, xLSTM's C, n, m and h, c, n, m) that a speculative rewind
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
                    cfg: ModelConfig, policy=None, **kw):
    """Decode a W-token window: tokens (b, W) ids, or (b, W, f) frames
    for deepspeech, fed at positions `positions + t`; returns (logits
    (b, W, v) f32, state after all W steps). Routes to the family's
    `decode_window_batched`, or to `decode_window_sequential` where the
    family has none. The caller owns undoing a rejected suffix (see
    `decode_state_carry`). `kw` (a mesh's `cs`) goes to the family's
    step."""
    if not self.decodable:
      raise ValueError(f"{self.family} has no decode path")
    if self.decode_window_batched is None:
      return self.decode_window_sequential(params, state, tokens, positions,
                                           cfg, policy, **kw)
    logits, state = self.decode_window_batched(params, state, tokens,
                                               positions, cfg, policy, **kw)
    return logits.float(), state

  def decode_window_sequential(self, params, state, tokens, positions,
                               cfg: ModelConfig, policy=None, **kw):
    """The W-token window as W `decode_step`s, one position each: the
    oracle of `decode_window` and the fallback of a family without a
    batched window; same semantics."""
    if not self.decodable:
      raise ValueError(f"{self.family} has no decode path")
    logits = []
    for t in range(tokens.shape[1]):
      lg, state = self.decode_step(params, state, tokens[:, t:t + 1],
                                   positions + t, cfg, policy, **kw)
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
    place; returns `state`. A DTensor leaf (a mesh) is written block by
    block, with no gather (`dist.sharding.write_slot`)."""
    from repro_torch.dist.sharding import write_slot

    def put(_, x, s, ax):
      write_slot(x, s, ax, slot)
      return x
    _map(put, state, slot_state, self._slot_axes(cfg))
    return state

  def extract_slot(self, cfg: ModelConfig, state: dict, slot: int) -> dict:
    """A copy of slot `slot` of `state`, batch 1 (of a DTensor leaf, a
    DTensor with the batch axis whole: `dist.sharding.slot_of`)."""
    return _map(lambda _, x, ax: slot_of(x, ax, slot).clone(), state,
                self._slot_axes(cfg))

  def reset_slot(self, cfg: ModelConfig, state: dict, slot: int, *,
                 max_len: Optional[int] = None) -> dict:
    """Slot `slot` of `state` back to its init value (zero KV rows, fresh
    carries), in place; every other slot untouched. Returns `state`."""
    device = _first_leaf(state).device
    fresh = self.init_decode_state(cfg, 1, max_len, device=device)
    return self.insert_slot(cfg, state, fresh, slot)

  # -- prefix snapshots (the prefix-cache contract) -------------------------
  # A decode state after m tokens has three kinds of leaf: positional KV
  # (attention k/v, MLA c_kv/k_rope), of which only rows [0, m) are ever
  # read under the causal mask, so a snapshot keeps those rows; carries
  # (SSM states, conv tails, xLSTM's memories, GRU hiddens), copied whole
  # and valid at exactly m, never sliced to a shorter prefix; and
  # step-invariant leaves (Whisper's encoder memory), copied whole.

  def decode_state_length_axes(self, cfg: ModelConfig) -> dict:
    """Per leaf, the axis a decode position indexes: the axis after the
    batch axis for attention-KV leaves, -1 for carries and step-invariant
    leaves, which have no positional extent."""
    return _map(lambda key, ax: ax + 1 if key in KV_CACHE_KEYS else -1,
                self._slot_axes(cfg))

  def prefix_view(self, cfg: ModelConfig, slot_state: dict,
                  length: int) -> dict:
    """A snapshot (a copy) of a batch-1 decode state after exactly
    `length` tokens: KV leaves cut to rows [0, length), every other leaf
    whole. `slot_state` must be the state after `length` tokens: carries
    are valid only there. Of a DTensor state, each rank keeps the rows of
    its own block (`dist.sharding.cut_prefix`)."""
    return _map(lambda _, x, ax: x.clone() if ax < 0 else
                cut_prefix(x, ax, length),
                slot_state, self.decode_state_length_axes(cfg))

  def slot_snapshot(self, cfg: ModelConfig, state: dict, slot: int,
                    length: int) -> dict:
    """`extract_slot` and `prefix_view`: the snapshot of one live slot's
    first `length` positions, copied once."""
    view = _map(lambda _, x, ax: slot_of(x, ax, slot), state,
                self._slot_axes(cfg))
    return self.prefix_view(cfg, view, length)

  def splice_prefix(self, cfg: ModelConfig, fresh: dict,
                    snapshot: dict) -> dict:
    """The inverse of `prefix_view`, into a fresh batch-1 state in place:
    KV rows land at [0, m) and the zeros beyond stay, what a cold prefill
    of those m tokens leaves there; every other leaf is the snapshot's.
    Each rank writes its own block of a DTensor state. Returns `fresh`."""
    def put(_, f, s, ax):
      if ax < 0:
        assign(f, s)
      else:
        splice_cut(f, s, ax)
      return f
    _map(put, fresh, snapshot, self.decode_state_length_axes(cfg))
    return fresh


def _first_leaf(tree):
  while isinstance(tree, dict):
    tree = next(iter(tree.values()))
  return tree


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
  if fam == "xlstm":
    return ModelApi(
        family=fam, init=xlstm_model.init_lm, loss_fn=xlstm_model.loss_fn,
        forward=xlstm_model.forward,
        init_decode_state=xlstm_model.init_decode_state,
        decode_step=xlstm_model.decode_step,
        decode_state_batch_axes=xlstm_model.decode_state_batch_axes,
        decode_state_carry=xlstm_model.decode_state_carry,
        decode_window_batched=xlstm_model.decode_window)
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
  raise ValueError(f"unknown model family: {fam!r}")
