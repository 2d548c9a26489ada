"""Zamba2-style hybrid — counterpart of `repro.models.zamba`: a Mamba2
backbone and one *shared* attention+MLP block (one weight set) that runs
before every group of `attn_every` Mamba2 blocks (arXiv:2411.15242).

Params keep the reference's tree: `embedding`, `final_norm`, `main` (the
Mamba2 leaves stacked (groups, attn_every, ...): `main/in_zx/w` is
(groups, attn_every, d, 2 * d_inner)), `shared_attn` (`ln1`, `attn`,
`ln2`, `ffn`, unstacked) and, where num_layers is not a multiple of
attn_every, `tail` (the last layers, stacked (tail, ...), after the last
group and with no shared block). The reference scans groups and layers;
here Python loops walk `main.layers()` (a list of groups, each a list of
layer dicts) and `tail.layers()`.

A training forward checkpoints every Mamba2 block whatever `cfg.remat`
says, as the reference remats them; `forward` discards the SSM state, so
a prefill gives no decode state.

The decode state is {"main_ssm": {"ssm", "conv"} stacked (groups,
attn_every, batch, ...), "shared_kv": {"k", "v"} (groups, batch, ...),
["tail_ssm": (tail, batch, ...)]}. `decode_step` and `decode_window`
write it in place and return it. The SSM leaves are carries (rewound
from a snapshot), the shared block's KV rows positional.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mamba2 as m2
from repro_torch.layers.common import ModelConfig
from repro_torch.layers.embedding import (Embedding, embed, init_embedding,
                                          logits as lm_logits)
from repro_torch.layers.ffn import init_swiglu, swiglu_forward
from repro_torch.layers.norms import init_rms, rms_norm
from repro_torch.models.transformer import (DenseLayer, StackedLayers, _view,
                                            _xent)


def check_supported(cfg: ModelConfig) -> None:
  if cfg.family != "zamba":
    raise ValueError(f"{cfg.name}: family {cfg.family!r} is not zamba")


def _plan(cfg: ModelConfig) -> tuple[int, int, int]:
  """(attn_every, groups, tail layers)."""
  k = cfg.attn_every or 6
  groups = cfg.num_layers // k
  return k, groups, cfg.num_layers - groups * k


class MambaStack(m2.Mamba2, StackedLayers):
  """Mamba2 blocks stacked on one leading axis (`tail`) or two (`main`:
  groups, attn_every), with per-layer views: `layers()` is a list of
  layer dicts, or for two axes a list of groups, each a list of them."""

  def _build_views(self) -> list:
    lead = tuple(self.A_log.shape[:-1])
    if len(lead) == 1:
      return [_view(self, i) for i in range(lead[0])]
    return [[_view(self, (g, j)) for j in range(lead[1])]
            for g in range(lead[0])]


class ZambaLM(nn.Module):
  """`embedding`, `final_norm`, `main`, `shared_attn` and `tail` (None
  where the plan has no tail): the reference's tree."""

  def __init__(self, embedding: Embedding, final_norm: torch.Tensor,
               main: MambaStack, shared_attn: DenseLayer,
               tail: MambaStack = None):
    super().__init__()
    self.embedding = embedding
    self.final_norm = nn.Parameter(final_norm, requires_grad=False)
    self.main = main
    self.shared_attn = shared_attn
    self.tail = tail


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device=None) -> ZambaLM:
  """Random weights from `generator`, on `device` (default: the GPU). A
  CPU generator gives the same weights on every device; a CUDA
  generator draws on the card in cfg.dtype (full width)."""
  check_supported(cfg)
  device = resolve_device(device)
  k, groups, tail = _plan(cfg)
  d = cfg.d_model
  kw = dict(generator=generator, device=device)
  mamba = functools.partial(m2.init_mamba2, cfg, layer_prefix="mamba", **kw)
  emb = init_embedding(cfg.vocab_size, d, dtype=cfg.dtype,
                       tie=cfg.tie_embeddings, **kw)
  main = MambaStack(**mamba(stack=(groups, k)))
  shared = DenseLayer(
      init_rms(d, device=device), init_rms(d, device=device),
      attn_lib.init_attention(cfg, layer_prefix="shared", **kw),
      init_swiglu(d, cfg.d_ff, layer_prefix="shared", dtype=cfg.dtype, **kw))
  return ZambaLM(emb, init_rms(d, device=device), main, shared,
                 MambaStack(**mamba(stack=(tail,))) if tail else None)


def _shared_block(x: torch.Tensor, sp: dict, cfg: ModelConfig,
                  policy=None) -> torch.Tensor:
  h = rms_norm(x, sp["ln1"], cfg.norm_eps)
  x = x + attn_lib.attention_forward(sp["attn"], h, cfg, policy)
  h = rms_norm(x, sp["ln2"], cfg.norm_eps)
  return x + swiglu_forward(sp["ffn"], h, policy)


def _mamba_block(h: torch.Tensor, lp: dict, cfg: ModelConfig,
                 policy=None) -> torch.Tensor:
  return h + m2.mamba2_forward(lp, rms_norm(h, lp["norm_in"], cfg.norm_eps),
                               cfg, policy=policy)


def _mamba_scan(x: torch.Tensor, layers: list, cfg: ModelConfig, policy,
                recorded: bool) -> torch.Tensor:
  """The blocks of `layers` in order; a forward that autograd records
  checkpoints each block (the reference remats every one)."""
  block = functools.partial(_mamba_block, cfg=cfg, policy=policy)
  if recorded:
    block = functools.partial(ckpt.checkpoint, block, use_reentrant=False)
  for lp in layers:
    x = block(x, lp)
  return x


def forward(params: ZambaLM, tokens: torch.Tensor, cfg: ModelConfig, *,
            last_only: bool = False, policy=None) -> torch.Tensor:
  """tokens (b, s) -> logits (b, s, v); last_only=True (serving
  prefill) narrows to the final position before the vocab projection.
  s must be at most CHUNK or a multiple of it (`mamba2.ssd_chunked`)."""
  x = embed(params.embedding, tokens)
  recorded = torch.is_grad_enabled() and any(
      p.requires_grad for p in params.parameters())
  sp = params.shared_attn.view()
  with dispatch.scanned():              # the reference's group scans
    for group in params.main.layers():
      x = _shared_block(x, sp, cfg, policy)
      x = _mamba_scan(x, group, cfg, policy, recorded)
    if params.tail is not None:
      x = _mamba_scan(x, params.tail.layers(), cfg, policy, recorded)
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  if last_only:
    x = x[:, -1:]
  return lm_logits(params.embedding, x, policy)


def loss_fn(params: ZambaLM, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
  """Mean next-token cross-entropy of a batch {"tokens", "targets"}
  (b, s), tensors or numpy arrays, with no kernel policy; returns (loss,
  {"xent": loss})."""
  check_supported(cfg)
  dev = params.final_norm.device
  tokens, targets = (torch.as_tensor(batch[k], device=dev).long()
                     for k in ("tokens", "targets"))
  loss = _xent(forward(params, tokens, cfg), targets)
  return loss, {"xent": loss}


# ----------------------------------------------------------------------------
# Decode.
# ----------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=None, device=None) -> dict:
  """Zeros on `device` (default: the GPU): see the module docstring."""
  check_supported(cfg)
  device = resolve_device(device)
  k, groups, tail = _plan(cfg)
  state = {
      "main_ssm": m2.init_mamba2_state(cfg, batch, stack=(groups, k),
                                       device=device),
      "shared_kv": attn_lib.init_kv_cache(cfg, batch, max_len,
                                          stack=(groups,), dtype=cache_dtype,
                                          device=device),
  }
  if tail:
    state["tail_ssm"] = m2.init_mamba2_state(cfg, batch, stack=(tail,),
                                             device=device)
  return state


def decode_state_batch_axes(cfg: ModelConfig) -> dict:
  """Batch axis of every decode-state leaf: `main_ssm` is stacked
  (groups, attn_every, ...) so its batch is axis 2; the shared KV cache
  and the tail's SSM stack one level."""
  axes = {"main_ssm": {"ssm": 2, "conv": 2}, "shared_kv": {"k": 1, "v": 1}}
  if _plan(cfg)[2]:
    axes["tail_ssm"] = {"ssm": 1, "conv": 1}
  return axes


def decode_state_carry(cfg: ModelConfig) -> dict:
  """Speculative-rewind contract: the Mamba2 SSM states and conv tails
  are read-modify-write every step, so rewinding a rejected draft suffix
  restores them from the pre-draft snapshot and replays the accepted
  prefix; the shared block's KV rows rewind with the position counter."""
  carry = {"main_ssm": {"ssm": True, "conv": True},
           "shared_kv": {"k": False, "v": False}}
  if _plan(cfg)[2]:
    carry["tail_ssm"] = {"ssm": True, "conv": True}
  return carry


def _decode(params: ZambaLM, state: dict, tokens: torch.Tensor,
            positions: torch.Tensor, cfg: ModelConfig, policy, attend,
            mamba) -> tuple[torch.Tensor, dict]:
  x = embed(params.embedding, tokens)
  sp = params.shared_attn.view()
  ms, kv = state["main_ssm"], state["shared_kv"]

  def blocks(x, layers, ssm, idx):
    for j, lp in enumerate(layers):
      ls = {key: s[idx + (j,)] for key, s in ssm.items()}
      y, _ = mamba(lp, rms_norm(x, lp["norm_in"], cfg.norm_eps), ls, cfg,
                   policy=policy)
      x = x + y
    return x

  with dispatch.scanned():              # the reference's group scans
    for g, group in enumerate(params.main.layers()):
      a = rms_norm(x, sp["ln1"], cfg.norm_eps)
      a, _ = attend(sp["attn"], a, {key: c[g] for key, c in kv.items()},
                    positions, cfg, policy)
      x = x + a
      f = rms_norm(x, sp["ln2"], cfg.norm_eps)
      x = x + swiglu_forward(sp["ffn"], f, policy)
      x = blocks(x, group, ms, (g,))
    if params.tail is not None:
      x = blocks(x, params.tail.layers(), state["tail_ssm"], ())
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  return lm_logits(params.embedding, x, policy), state


def decode_step(params: ZambaLM, state: dict, token: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                policy=None) -> tuple[torch.Tensor, dict]:
  """token (b, 1), positions (b,) -> (logits (b, 1, v), state), the KV
  rows at `positions` and every SSM carry written in place."""
  return _decode(params, state, token, positions, cfg, policy,
                 attn_lib.attention_decode, m2.mamba2_decode)


def decode_window(params: ZambaLM, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig,
                  policy=None) -> tuple[torch.Tensor, dict]:
  """Batched window decode: tokens (b, W) at positions `positions + t`
  -> (logits (b, W, v), state after the W tokens, written in place). One
  weight pass for the whole window: the shared block runs
  `attention_decode_window`, each Mamba2 block `mamba2_decode_window`;
  each row equals W sequential `decode_step`s' to f32 summation
  order."""
  return _decode(params, state, tokens, positions, cfg, policy,
                 attn_lib.attention_decode_window, m2.mamba2_decode_window)
