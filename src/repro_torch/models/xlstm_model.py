"""xLSTM LM — counterpart of `repro.models.xlstm_model`: alternating
mLSTM / sLSTM block pairs (1:1). xlstm-350m: 24 blocks = 12 (mLSTM,
sLSTM) pairs, d_model 1024, 4 heads, d_ff 0 (the blocks carry their own
projections).

Params keep the reference's tree: `embedding`, `final_norm` and `pairs`,
whose leaves are stacked (pairs, ...): `pairs/m_norm` (pairs, d),
`pairs/mlstm/up/w` (pairs, d, 2 di), ..., `pairs/slstm/rh/w` (pairs,
heads, hd, 4 hd). The reference scans the pairs; here a Python loop walks
`pairs.layers()`, each a dict {"m_norm", "mlstm": {...}, "s_norm",
"slstm": {...}} of views. `cfg.remat == "full"` checkpoints each pair of
a training forward, as the reference's `jax.remat` does.

The decode state is all carry, {"mlstm": {"C", "n", "m"}, "slstm": {"h",
"c", "n", "m"}}, each stacked (pairs, batch, ...): fixed-size, whatever
the length, so a prefix snapshot of it is valid at exactly the length it
was taken at. `decode_step` and `decode_window` write it in place and
return it; `positions` is unused (the family has no positional state)
but kept for the uniform signature.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.layers import xlstm as xl
from repro_torch.layers.common import (Constraint, ModelConfig,
                                      identity_constraint)
from repro_torch.layers.embedding import (Embedding, embed, init_embedding,
                                          logits as lm_logits)
from repro_torch.layers.norms import init_rms, rms_norm
from repro_torch.models.transformer import StackedLayers, _xent


def check_supported(cfg: ModelConfig) -> None:
  if cfg.family != "xlstm":
    raise ValueError(f"{cfg.name}: family {cfg.family!r} is not xlstm")


def _npairs(cfg: ModelConfig) -> int:
  return cfg.num_layers // 2


class PairStack(StackedLayers):
  """The (mLSTM, sLSTM) pairs stacked on a leading axis: `m_norm`,
  `s_norm` (pairs, d) f32, `mlstm` (an `xlstm.MLSTM`) and `slstm` (an
  `xlstm.SLSTM`) of stacked leaves. `layers()` gives a pair's view."""

  def __init__(self, m_norm: torch.Tensor, s_norm: torch.Tensor,
               mlstm: xl.MLSTM, slstm: xl.SLSTM):
    super().__init__()
    self.m_norm = nn.Parameter(m_norm, requires_grad=False)
    self.s_norm = nn.Parameter(s_norm, requires_grad=False)
    self.mlstm = mlstm
    self.slstm = slstm


class XlstmLM(nn.Module):
  """`embedding`, `final_norm` and `pairs`: the reference's tree."""

  def __init__(self, embedding: Embedding, final_norm: torch.Tensor,
               pairs: PairStack):
    super().__init__()
    self.embedding = embedding
    self.final_norm = nn.Parameter(final_norm, requires_grad=False)
    self.pairs = pairs


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device=None) -> XlstmLM:
  """Random weights from `generator`, on `device` (default: the GPU). A
  CPU generator gives the same weights on every device; a CUDA
  generator draws on the card in cfg.dtype (full width)."""
  check_supported(cfg)
  device = resolve_device(device)
  d, n = cfg.d_model, _npairs(cfg)
  kw = dict(generator=generator, device=device)
  emb = init_embedding(cfg.vocab_size, d, dtype=cfg.dtype,
                       tie=cfg.tie_embeddings, **kw)
  pairs = PairStack(
      init_rms(d, stack=(n,), device=device),
      init_rms(d, stack=(n,), device=device),
      xl.MLSTM(**xl.init_mlstm(cfg, layer_prefix="pairs", stack=(n,), **kw)),
      xl.SLSTM(**xl.init_slstm(cfg, layer_prefix="pairs", stack=(n,), **kw)))
  return XlstmLM(emb, init_rms(d, device=device), pairs)


def _pair_block(h: torch.Tensor, lp: dict, cfg: ModelConfig,
                policy=None, cs: Constraint = identity_constraint
                ) -> torch.Tensor:
  lp = cs(lp, "layer_params")         # inside the checkpointed region
  h = h + xl.mlstm_forward(lp["mlstm"], rms_norm(h, lp["m_norm"],
                                                 cfg.norm_eps),
                           cfg, policy=policy)
  return h + xl.slstm_forward(lp["slstm"], rms_norm(h, lp["s_norm"],
                                                    cfg.norm_eps),
                              cfg, policy=policy)


def forward(params: XlstmLM, tokens: torch.Tensor, cfg: ModelConfig, *,
            last_only: bool = False, policy=None,
            cs: Constraint = identity_constraint) -> torch.Tensor:
  """tokens (b, s) -> logits (b, s, v); last_only=True (serving
  prefill) narrows to the final position before the vocab projection.
  s must be at most CHUNK or a multiple of it (`xlstm.mlstm_forward`)."""
  x = cs(embed(params.embedding, tokens), "bsd")
  block = functools.partial(_pair_block, cfg=cfg, policy=policy, cs=cs)
  if cfg.remat == "full" and torch.is_grad_enabled() and any(
      p.requires_grad for p in params.parameters()):
    block = functools.partial(ckpt.checkpoint, block, use_reentrant=False)
  with dispatch.scanned():              # the reference's pair scan
    for lp in params.pairs.layers():
      x = cs(block(x, lp), "bsd")
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  if last_only:
    x = x[:, -1:]
  return cs(lm_logits(params.embedding, x, policy), "bsv")


def loss_fn(params: XlstmLM, batch: dict, cfg: ModelConfig,
            cs: Constraint = identity_constraint
            ) -> tuple[torch.Tensor, dict]:
  """Mean next-token cross-entropy of a batch {"tokens", "targets"}
  (b, s), tensors or numpy arrays, with no kernel policy; returns (loss,
  {"xent": loss})."""
  check_supported(cfg)
  dev = params.final_norm.device
  tokens, targets = (torch.as_tensor(batch[k], device=dev).long()
                     for k in ("tokens", "targets"))
  loss = _xent(forward(params, tokens, cfg, cs=cs), targets)
  return loss, {"xent": loss}


# ----------------------------------------------------------------------------
# Decode.
# ----------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int = None,
                      cache_dtype=None, device=None) -> dict:
  """The zero carries on `device` (default: the GPU); `max_len` and
  `cache_dtype` do not apply (no KV cache)."""
  check_supported(cfg)
  device = resolve_device(device)
  n = _npairs(cfg)
  return {"mlstm": xl.init_mlstm_state(cfg, batch, stack=(n,),
                                       device=device),
          "slstm": xl.init_slstm_state(cfg, batch, stack=(n,),
                                       device=device)}


def decode_state_batch_axes(cfg: ModelConfig) -> dict:
  """Batch axis of every decode-state leaf: both block states are
  stacked over the pairs, so batch is axis 1."""
  return {"mlstm": {"C": 1, "n": 1, "m": 1},
          "slstm": {"h": 1, "c": 1, "n": 1, "m": 1}}


def decode_state_carry(cfg: ModelConfig) -> dict:
  """Speculative-rewind and prefix-snapshot contract: every leaf is a
  read-modify-write carry, restored from a snapshot and replayed on a
  rewind, and valid at exactly the length it was taken at."""
  return {k: {kk: True for kk in v}
          for k, v in decode_state_batch_axes(cfg).items()}


def _decode(params: XlstmLM, state: dict, tokens: torch.Tensor,
            cfg: ModelConfig, policy, mlstm, slstm, cs: Constraint
            ) -> tuple[torch.Tensor, dict]:
  x = cs(embed(params.embedding, tokens), "bsd")
  ms, ss = state["mlstm"], state["slstm"]
  with dispatch.scanned():              # the reference's pair scan
    for i, lp in enumerate(params.pairs.layers()):
      lp = cs(lp, "layer_params")
      y, _ = mlstm(lp["mlstm"], rms_norm(x, lp["m_norm"], cfg.norm_eps),
                   {k: t[i] for k, t in ms.items()}, cfg, policy=policy)
      x = x + y
      y, _ = slstm(lp["slstm"], rms_norm(x, lp["s_norm"], cfg.norm_eps),
                   {k: t[i] for k, t in ss.items()}, cfg, policy=policy)
      x = x + y
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  return lm_logits(params.embedding, x, policy), state


def decode_step(params: XlstmLM, state: dict, token: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                policy=None, cs: Constraint = identity_constraint
                ) -> tuple[torch.Tensor, dict]:
  """token (b, 1) -> (logits (b, 1, v), state), every carry written in
  place."""
  return _decode(params, state, token, cfg, policy, xl.mlstm_decode,
                 xl.slstm_decode, cs)


def decode_window(params: XlstmLM, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig,
                  policy=None, cs: Constraint = identity_constraint
                  ) -> tuple[torch.Tensor, dict]:
  """Batched window decode: tokens (b, W) -> (logits (b, W, v), state
  after the W tokens, written in place). Every non-recurrent GEMM reads
  its weights once for the window; only the carries run position by
  position. Each row equals W sequential `decode_step`s' to f32
  summation order."""
  return _decode(params, state, tokens, cfg, policy, xl.mlstm_decode_window,
                 xl.slstm_decode_window, cs)
