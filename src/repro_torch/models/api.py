"""One dispatch surface over the ported model families — counterpart of
`repro.models.api`, as far as serving and DS2 training need it.

`get_model(cfg)` returns a `ModelApi` for the `transformer` and
`deepspeech` families with `init`, `forward`, `loss_fn` (deepspeech;
the transformer's comes with its training slice), `init_decode_state`,
`decode_step`, `decode_state_batch_axes` and the slot surgery
`insert_slot`. Decode states are nested dicts of tensors; `insert_slot`
writes into the batched state in place (the reference returns a new
tree). `cast_kv_cache` narrows only attention-KV leaves. The other
families, decode windows, the speculative-rewind and the
prefix-snapshot contracts come with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.layers.common import ModelConfig
from repro_torch.models import deepspeech, transformer

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

  @property
  def decodable(self) -> bool:
    return self.decode_step is not None

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
        family=fam, init=transformer.init_lm, forward=transformer.forward,
        init_decode_state=transformer.init_decode_state,
        decode_step=transformer.decode_step,
        decode_state_batch_axes=transformer.decode_state_batch_axes)
  if fam == "deepspeech":
    return ModelApi(
        family=fam, init=deepspeech.init_model, forward=deepspeech.forward,
        loss_fn=deepspeech.loss_fn,
        init_decode_state=lambda cfg, batch, max_len=None, cache_dtype=None,
        device=None: deepspeech.init_decode_state(cfg, batch, device),
        decode_step=deepspeech.api_decode_step,
        decode_state_batch_axes=deepspeech.decode_state_batch_axes)
  raise ValueError(f"model family {fam!r} is not ported yet")
