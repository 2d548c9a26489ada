"""Whisper-style encoder-decoder — counterpart of `repro.models.whisper`
(the audio backbone; the conv frontend is a stub, as in the reference:
`encode` takes precomputed frame embeddings (b, t, d)).

Encoder: non-causal self-attention and a GELU FFN over (b, frames, d),
sinusoidal positions. Decoder: causal self-attention (KV cache on
decode), cross-attention to the encoder memory, a GELU FFN; pre-norm
LayerNorms throughout and a tied head.

Params keep the reference's tree: `embedding` (the tied `table`),
`pos_dec`, `enc_layers` and `dec_layers` (layer-stacked leaves, (L, ...)),
`enc_ln` and `dec_ln`, so `state_dict()` keys are its checkpoint paths
(`enc_layers.attn.wq.w` for `enc_layers/attn/wq/w`). The reference scans
over the stacks; the port walks them in Python, each walk inside
`dispatch.scanned()`, so calibration observes what the reference's
does: nothing in there. `encode_unrolled` is `encode` with each layer
under `dispatch.calibration_layer(i)` instead, the forward LiteASR's
calibration runs ("enc/attn_q@L3", ...).

The reference's quirks stay: the decoder's self-attention applies RoPE
and its input also adds the learned `pos_dec`; the encoder adds the
sinusoid after casting it to cfg.dtype; `_xattn` computes K and V from
the memory at every decode step (there is no cross-attention cache);
the tied head stays plain. `decode_step` and `decode_window` write the
self-attention KV rows into the state in place and return it; the
memory is step-invariant.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.factored import dense, normal
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import heads_local, merge_heads, split_heads
from repro_torch.kernels import dispatch
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.common import (Constraint, ModelConfig, gemm,
                                      identity_constraint)
from repro_torch.layers.embedding import (Embedding, embed, init_embedding,
                                          logits as lm_logits)
from repro_torch.layers.ffn import GeluFFN, gelu_ffn_forward, init_gelu_ffn
from repro_torch.layers.norms import LayerNorm, init_ln, layer_norm
from repro_torch.models.transformer import StackedLayers, _xent


class WhisperLayers(StackedLayers):
  """The encoder's stack (ln1, attn, ln2, ffn) or, with `xattn` and
  `ln3`, the decoder's (ln1, attn, ln2, xattn, ln3, ffn). A layer's view:
  {"ln1": {"scale", "bias"}, "attn": {"wq", ...}, ..., "ffn": {"w_in",
  "w_out", "b_in", "b_out"}}."""

  def __init__(self, ln1: LayerNorm, attn: attn_lib.Attention,
               ln2: LayerNorm, ffn: GeluFFN,
               xattn: Optional[attn_lib.Attention] = None,
               ln3: Optional[LayerNorm] = None):
    super().__init__()
    if (xattn is None) != (ln3 is None):
      raise ValueError("a decoder stack takes both xattn and ln3")
    self.ln1, self.attn, self.ln2 = ln1, attn, ln2
    if xattn is not None:
      self.xattn, self.ln3 = xattn, ln3
    self.ffn = ffn


class Whisper(nn.Module):
  """`embedding`, `pos_dec`, `enc_layers`, `enc_ln`, `dec_layers`,
  `dec_ln`: the reference's tree."""

  def __init__(self, embedding: Embedding, pos_dec: torch.Tensor,
               enc_layers: WhisperLayers, enc_ln: LayerNorm,
               dec_layers: WhisperLayers, dec_ln: LayerNorm):
    super().__init__()
    self.embedding = embedding
    self.pos_dec = nn.Parameter(pos_dec, requires_grad=False)
    self.enc_layers, self.enc_ln = enc_layers, enc_ln
    self.dec_layers, self.dec_ln = dec_layers, dec_ln


def _init_xattn(cfg: ModelConfig, prefix: str, **kw) -> attn_lib.Attention:
  d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
  kw = dict(kw, dtype=cfg.dtype)
  return attn_lib.Attention(dense(d, h * hd, name=f"{prefix}/xattn_q", **kw),
                            dense(d, h * hd, name=f"{prefix}/xattn_k", **kw),
                            dense(d, h * hd, name=f"{prefix}/xattn_v", **kw),
                            dense(h * hd, d, name=f"{prefix}/xattn_o", **kw))


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None) -> Whisper:
  """Random weights from `generator`, on `device` (default: the GPU). A
  CPU generator gives the same weights on every device; a CUDA
  generator draws on the card in cfg.dtype."""
  if cfg.family != "whisper":
    raise ValueError(f"{cfg.name}: family {cfg.family!r} is not whisper")
  device = resolve_device(device)
  d = cfg.d_model
  kw = dict(generator=generator, device=device)

  def stack(n, prefix, decoder):
    st = dict(stack=(n,), **kw)
    extra = {}
    if decoder:
      extra = dict(xattn=_init_xattn(cfg, prefix, **st),
                   ln3=init_ln(d, stack=(n,), device=device))
    return WhisperLayers(
        init_ln(d, stack=(n,), device=device),
        attn_lib.init_attention(cfg, layer_prefix=prefix, **st),
        init_ln(d, stack=(n,), device=device),
        init_gelu_ffn(d, cfg.d_ff, layer_prefix=prefix, dtype=cfg.dtype,
                      **st), **extra)

  emb = init_embedding(cfg.vocab_size, d, dtype=cfg.dtype, tie=True, **kw)
  pos_dec = normal((cfg.max_source_positions * 32, d), 0.01, generator,
                   cfg.dtype, device)
  enc = stack(cfg.encoder_layers or cfg.num_layers, "enc", False)
  dec = stack(cfg.num_layers, "dec", True)
  return Whisper(emb, pos_dec, enc, init_ln(d, device=device), dec,
                 init_ln(d, device=device))


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
  """(length, d) f32: sin of the d/2 angles, then their cos."""
  f32 = torch.float32
  pos = torch.arange(length, dtype=f32, device=device)[:, None]
  dim = torch.arange(d // 2, dtype=f32, device=device)[None, :]
  inv = torch.exp(-math.log(10000.0) * dim / (d // 2))
  ang = pos * inv
  return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
  return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _xattn(p, x: torch.Tensor, mem: torch.Tensor, cfg: ModelConfig,
           policy=None) -> torch.Tensor:
  """Cross attention: queries from x (b, s, d), keys and values from the
  memory (b, t, d), scores and softmax in f32; on DTensors on each
  rank's rows and heads."""
  h, hd = cfg.num_heads, cfg.resolved_head_dim
  q = split_heads(gemm(p["wq"], x, policy), h, hd)
  k = split_heads(gemm(p["wk"], mem, policy), h, hd)
  v = split_heads(gemm(p["wv"], mem, policy), h, hd)
  o = heads_local(_cross, q, k, v)
  return gemm(p["wo"], merge_heads(o, h).to(x.dtype), policy)


def _cross(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
  """softmax(q k^T / sqrt(hd)) v of plain (b, s, h, hd) q and (b, t, h,
  hd) k, v, in f32."""
  sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (
      q.shape[-1] ** 0.5)
  pr = torch.softmax(sc, dim=-1)
  return torch.einsum("bhqk,bkhd->bqhd", pr, v.float())


def _enc_block(x: torch.Tensor, lp: dict, cfg: ModelConfig,
               policy=None, cs: Constraint = identity_constraint
               ) -> torch.Tensor:
  lp = cs(lp, "layer_params")         # inside the checkpointed region
  x = x + attn_lib.bidir_attention_forward(lp["attn"], _ln(x, lp["ln1"], cfg),
                                           cfg, policy)
  return x + gelu_ffn_forward(lp["ffn"], _ln(x, lp["ln2"], cfg), policy, cs)


def _dec_block(x: torch.Tensor, lp: dict, mem: torch.Tensor,
               cfg: ModelConfig, cs: Constraint = identity_constraint
               ) -> torch.Tensor:
  lp = cs(lp, "layer_params")         # inside the checkpointed region
  x = x + attn_lib.attention_forward(lp["attn"], _ln(x, lp["ln1"], cfg), cfg,
                                     cs=cs)
  x = x + _xattn(lp["xattn"], _ln(x, lp["ln2"], cfg), mem, cfg)
  return x + gelu_ffn_forward(lp["ffn"], _ln(x, lp["ln3"], cfg), cs=cs)


def _remat(body, cfg: ModelConfig, params: Whisper):
  """`body` checkpointed under cfg.remat == "full" (the reference's only
  remat mode here) where autograd records the forward."""
  recorded = torch.is_grad_enabled() and any(
      p.requires_grad for p in params.parameters())
  if cfg.remat == "full" and recorded:
    return functools.partial(ckpt.checkpoint, body, use_reentrant=False)
  return body


def _frames_in(frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  b, t, d = frames.shape
  return frames.to(cfg.dtype) + _sinusoid(t, d, frames.device).to(
      cfg.dtype)[None]


def encode(params: Whisper, frames: torch.Tensor, cfg: ModelConfig,
           policy=None, cs: Constraint = identity_constraint
           ) -> torch.Tensor:
  """frames (b, t, d) -> memory (b, t, d) in cfg.dtype. t must be a
  multiple of min(cfg.attn_block_kv, t), as in the reference."""
  x = cs(_frames_in(frames, cfg), "bsd")
  block = _remat(functools.partial(_enc_block, cfg=cfg, policy=policy,
                                   cs=cs), cfg, params)
  with dispatch.scanned():              # the reference's layer scan
    for lp in params.enc_layers.layers():
      x = cs(block(x, lp), "bsd")
  return layer_norm(x, params.enc_ln.scale, params.enc_ln.bias, cfg.norm_eps)


def encode_unrolled(params: Whisper, frames: torch.Tensor, cfg: ModelConfig,
                    policy=None, cs: Constraint = identity_constraint
                    ) -> torch.Tensor:
  """`encode` with each layer under `dispatch.calibration_layer(i)` and
  outside `dispatch.scanned()`: with a policy threaded, the observers see
  every encoder GEMM, keyed "name@L{i}". The forward of LiteASR's
  calibration; serve with `encode`."""
  x = cs(_frames_in(frames, cfg), "bsd")
  for i, lp in enumerate(params.enc_layers.layers()):
    with dispatch.calibration_layer(i):
      x = cs(_enc_block(x, lp, cfg, policy, cs), "bsd")
  return layer_norm(x, params.enc_ln.scale, params.enc_ln.bias, cfg.norm_eps)


def decode_train(params: Whisper, tokens: torch.Tensor, mem: torch.Tensor,
                 cfg: ModelConfig, cs: Constraint = identity_constraint
                 ) -> torch.Tensor:
  """tokens (b, s), memory (b, t, d) -> logits (b, s, v), no kernel
  policy (the reference's training decoder takes none)."""
  s = tokens.shape[1]
  x = embed(params.embedding, tokens)
  x = x + params.pos_dec[:s][None].to(x.dtype)
  block = _remat(functools.partial(_dec_block, cfg=cfg, cs=cs), cfg, params)
  with dispatch.scanned():              # the reference's layer scan
    for lp in params.dec_layers.layers():
      x = cs(block(x, lp, mem), "bsd")
  x = layer_norm(x, params.dec_ln.scale, params.dec_ln.bias, cfg.norm_eps)
  return lm_logits(params.embedding, x)


def loss_fn(params: Whisper, batch: dict, cfg: ModelConfig,
            cs: Constraint = identity_constraint
            ) -> tuple[torch.Tensor, dict]:
  """Next-token cross-entropy of a batch {"frames" (b, t, d), "tokens",
  "targets" (b, s)}, tensors or numpy arrays, through `encode` and
  `decode_train` with no kernel policy. Returns (loss, {"xent"})."""
  dev = params.pos_dec.device
  frames = torch.as_tensor(batch["frames"], device=dev)
  tokens, targets = (torch.as_tensor(batch[k], device=dev).long()
                     for k in ("tokens", "targets"))
  mem = encode(params, frames, cfg, cs=cs)
  loss = _xent(decode_train(params, tokens, mem, cfg, cs), targets)
  return loss, {"xent": loss}


# ----------------------------------------------------------------------------
# Decode.
# ----------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int = 1500, cache_dtype=None,
                      device=None) -> dict:
  """{"kv": {"k", "v"} (L, batch, max_len, h, hd), "mem": (batch,
  enc_len, d)}, zeros, on `device` (default: the GPU)."""
  device = resolve_device(device)
  return {"kv": attn_lib.init_kv_cache(cfg, batch, max_len,
                                       stack=(cfg.num_layers,),
                                       dtype=cache_dtype, device=device),
          "mem": torch.zeros((batch, enc_len, cfg.d_model), dtype=cfg.dtype,
                             device=device)}


def decode_state_batch_axes(cfg: ModelConfig) -> dict:
  """Batch axis of every decode-state leaf: the self-attention cache is
  stacked over layers; the memory carries batch leading."""
  return {"kv": {"k": 1, "v": 1}, "mem": 0}


def decode_state_carry(cfg: ModelConfig) -> dict:
  """Speculative-rewind contract: the KV cache rewinds positionally and
  the memory is step-invariant, so no leaf is a carry."""
  return {"kv": {"k": False, "v": False}, "mem": False}


def _decode_stack(params: Whisper, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, policy,
                  attend, cs: Constraint) -> tuple[torch.Tensor, dict]:
  pos = positions[:, None] + torch.arange(tokens.shape[1],
                                          device=tokens.device)[None, :]
  x = embed(params.embedding, tokens)
  x = x + params.pos_dec[pos].to(x.dtype)
  mem, kv = state["mem"], state["kv"]
  with dispatch.scanned():              # the reference's layer scan
    for i, lp in enumerate(params.dec_layers.layers()):
      lp = cs(lp, "layer_params")
      a, _ = attend(lp["attn"], _ln(x, lp["ln1"], cfg),
                    {"k": kv["k"][i], "v": kv["v"][i]}, positions, cfg,
                    policy, cs)
      x = x + a
      x = x + _xattn(lp["xattn"], _ln(x, lp["ln2"], cfg), mem, cfg, policy)
      x = x + gelu_ffn_forward(lp["ffn"], _ln(x, lp["ln3"], cfg), policy, cs)
  x = layer_norm(x, params.dec_ln.scale, params.dec_ln.bias, cfg.norm_eps)
  return lm_logits(params.embedding, x, policy), state


def decode_step(params: Whisper, state: dict, token: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                policy=None, cs: Constraint = identity_constraint
                ) -> tuple[torch.Tensor, dict]:
  """token (b, 1), positions (b,) -> (logits (b, 1, v), state), the KV
  rows at `positions` written into `state` in place."""
  return _decode_stack(params, state, token, positions, cfg, policy,
                       attn_lib.attention_decode, cs)


def decode_window(params: Whisper, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig,
                  policy=None, cs: Constraint = identity_constraint
                  ) -> tuple[torch.Tensor, dict]:
  """Batched window decode: tokens (b, W) at positions `positions + t`
  -> (logits (b, W, v), state after the W tokens, written in place).
  The causal self-attention runs `attention_decode_window`; the
  cross-attention and the FFN are position-independent and take the
  b*W rows together. Each row equals W sequential `decode_step`s' to f32
  summation order."""
  return _decode_stack(params, state, tokens, positions, cfg, policy,
                       attn_lib.attention_decode_window, cs)
