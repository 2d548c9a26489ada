"""Multi-head Latent Attention (DeepSeek V2/V3) — counterpart of
`repro.layers.mla`.

MLA is itself a low-rank factorization of the KV projection, the paper's
W = UV idea as shipped: the KV path is W_uk @ (W_dkv x) with inner rank
kv_lora_rank, and the compressed latent c_kv is what gets cached. The
decode path uses the absorbed form (the query projected into latent
space), so a step reads rank-sized cache rows.

`mla_forward` (training, prefill) up-projects k and v from the latent
and runs the reference's blockwise online softmax over
`cfg.attn_block_q` x `cfg.attn_block_kv` tiles in plain PyTorch: the
qk width (nope + rope, 192 at full width) is not the v width (128), and
the reference computes this attention in jnp, so there is no kernel to
route it to. Both blocks must divide the sequence (the reference
reshapes into s // block blocks); otherwise a `ValueError` names them.

Every GEMM goes through `layers.common.gemm(..., policy)`; the absorbed
einsums take w_uk and w_uv as float products (`_as_w`), as the
reference does. `mla_decode` and `mla_decode_window` write the new
latent rows into the cache in place (a row at or past max_len is
dropped, as the reference's scatter drops it) and return the same dict.

Cache layout: c_kv (b, S, kv_lora_rank) + k_rope (b, S, qk_rope_dim).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.factored import dense
from repro_torch.dist import sharding as shd
from repro_torch.layers.attention import NEG_INF, softmax_mix, write_rows
from repro_torch.layers.common import (Constraint, ModelConfig, gemm,
                                      identity_constraint)
from repro_torch.layers.norms import init_rms, rms_norm
from repro_torch.layers.rope import apply_rope


class MLA(nn.Module):
  """The reference's MLA params: `wq` (d, h*qk), or with q-LoRA `wq_a`
  (d, q_lora), `q_a_norm` (q_lora,) f32 and `wq_b` (q_lora, h*qk); then
  `w_dkv` (d, kv_lora + rope), `kv_a_norm` (kv_lora,) f32, `w_uk`
  (kv_lora, h*nope), `w_uv` (kv_lora, h*v) and `wo` (h*v, d).
  Layer-stacked in a model."""

  def __init__(self, *, w_dkv: nn.Module, kv_a_norm: torch.Tensor,
               w_uk: nn.Module, w_uv: nn.Module, wo: nn.Module,
               wq: Optional[nn.Module] = None,
               wq_a: Optional[nn.Module] = None,
               q_a_norm: Optional[torch.Tensor] = None,
               wq_b: Optional[nn.Module] = None):
    super().__init__()
    if (wq is None) == (wq_a is None) or \
        (wq_a is None) != (wq_b is None) or \
        (wq_a is None) != (q_a_norm is None):
      raise ValueError("MLA takes wq, or wq_a, q_a_norm and wq_b")
    if wq is not None:
      self.wq = wq
    else:
      self.wq_a = wq_a
      self.q_a_norm = nn.Parameter(q_a_norm, requires_grad=False)
      self.wq_b = wq_b
    self.w_dkv = w_dkv
    self.kv_a_norm = nn.Parameter(kv_a_norm, requires_grad=False)
    self.w_uk, self.w_uv, self.wo = w_uk, w_uv, wo


def init_mla(cfg: ModelConfig, *, layer_prefix: str, stack: tuple = (),
             generator: torch.Generator, device) -> MLA:
  m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
  qk = m.qk_nope_dim + m.qk_rope_dim
  kw = dict(dtype=cfg.dtype, stack=stack, generator=generator, device=device)
  q = {}
  if m.q_lora_rank:
    q = dict(wq_a=dense(d, m.q_lora_rank, name=f"{layer_prefix}/mla_q_a",
                        **kw),
             q_a_norm=init_rms(m.q_lora_rank, stack=stack, device=device),
             wq_b=dense(m.q_lora_rank, h * qk,
                        name=f"{layer_prefix}/mla_q_b", **kw))
  else:
    q = dict(wq=dense(d, h * qk, name=f"{layer_prefix}/mla_q", **kw))
  return MLA(
      **q,
      w_dkv=dense(d, m.kv_lora_rank + m.qk_rope_dim,
                  name=f"{layer_prefix}/mla_dkv", **kw),
      kv_a_norm=init_rms(m.kv_lora_rank, stack=stack, device=device),
      w_uk=dense(m.kv_lora_rank, h * m.qk_nope_dim,
                 name=f"{layer_prefix}/mla_uk", **kw),
      w_uv=dense(m.kv_lora_rank, h * m.v_head_dim,
                 name=f"{layer_prefix}/mla_uv", **kw),
      wo=dense(h * m.v_head_dim, d, name=f"{layer_prefix}/mla_o", **kw))


def _queries(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
             policy=None) -> tuple[torch.Tensor, torch.Tensor]:
  """(q_nope (b, s, h, nope), q_rope (b, s, h, rope)), RoPE applied."""
  m, h = cfg.mla, cfg.num_heads
  if m.q_lora_rank:
    qa = rms_norm(gemm(p["wq_a"], x, policy), p["q_a_norm"], cfg.norm_eps)
    q = gemm(p["wq_b"], qa, policy)
  else:
    q = gemm(p["wq"], x, policy)
  q = shd.split_heads(q, h, m.qk_nope_dim + m.qk_rope_dim)
  q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
  return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
             policy=None) -> tuple[torch.Tensor, torch.Tensor]:
  """(c (b, s, kv_lora) after the kv-a RMSNorm, k_rope (b, s, rope)): the
  rope part is one head shared by all heads."""
  m = cfg.mla
  ckv = gemm(p["w_dkv"], x, policy)
  c = rms_norm(ckv[..., :m.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
  k_rope = apply_rope(ckv[..., None, m.kv_lora_rank:], positions,
                      cfg.rope_theta)[..., 0, :]
  return c, k_rope


def _blocks(s: int, cfg: ModelConfig) -> tuple[int, int]:
  bq, bkv = min(cfg.attn_block_q, s), min(cfg.attn_block_kv, s)
  if s % bq or s % bkv:
    raise ValueError(
        f"MLA over {s} positions with attn_block_q={cfg.attn_block_q}, "
        f"attn_block_kv={cfg.attn_block_kv}: the blocks ({bq}, {bkv}) must "
        f"divide {s} (the reference reshapes q, k and v into s // block "
        "blocks); pick attn_block_q and attn_block_kv that divide it")
  return bq, bkv


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig, policy=None,
                cs: Constraint = identity_constraint) -> torch.Tensor:
  """Full-sequence causal MLA (training, prefill), x (b, s, d). The
  (bq, s) score rows never exist: each query block runs an online
  softmax over its kv blocks, scores, running max, sum and accumulator
  in f32. Kv blocks wholly above the diagonal are skipped: in the
  reference they add exp(NEG_INF - m) = 0 and scale by 1. On DTensors
  (a mesh) the attention runs on each rank's rows and heads; the shared
  rope key, which has no head axis, is whole on every rank."""
  m, h = cfg.mla, cfg.num_heads
  b, s, _ = x.shape
  bq, bkv = _blocks(s, cfg)
  positions = torch.arange(s, device=x.device)[None].expand(b, s)
  q_nope, q_rope = _queries(p, x, cfg, positions, policy)
  c, k_rope = _latents(p, x, cfg, positions, policy)
  # k and v up-projected from the latent (the non-absorbed form)
  k_nope = shd.split_heads(gemm(p["w_uk"], c, policy), h, m.qk_nope_dim)
  v = shd.split_heads(gemm(p["w_uv"], c, policy), h, m.v_head_dim)
  q_nope = cs(q_nope, "bshd_q")
  k_nope = cs(k_nope, "bshd_q")
  v = cs(v, "bshd_q")
  scale = 1.0 / ((m.qk_nope_dim + m.qk_rope_dim) ** 0.5)
  out = shd.split_call(_attend_blocks, (q_nope, "bsh"), (q_rope, "bsh"),
                       (k_nope, "bsh"), (k_rope, "b"), (v, "bsh"),
                       out="bsh", bq=bq, bkv=bkv, scale=scale, dtype=x.dtype)
  return gemm(p["wo"], out.reshape(b, s, h * m.v_head_dim), policy)


def _attend_blocks(q_nope, q_rope, k_nope, k_rope, v, *, bq: int, bkv: int,
                   scale: float, dtype) -> torch.Tensor:
  """The blockwise causal softmax of `mla_forward` on plain tensors:
  q_nope (b, s, h, nope), q_rope (b, s, h, rope), k_nope (b, s, h,
  nope), k_rope (b, s, rope), v (b, s, h, vd) -> (b, s, h, vd) in
  `dtype`."""
  b, s, h, vd = v.shape
  dev = v.device
  f32 = torch.float32
  blocks = []
  for q0 in range(0, s, bq):
    qn = q_nope[:, q0:q0 + bq].to(f32)
    qr = q_rope[:, q0:q0 + bq].to(f32)
    qpos = torch.arange(q0, q0 + bq, device=dev)[:, None]
    mx = torch.full((b, h, bq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, h, bq), dtype=f32, device=dev)
    o = torch.zeros((b, bq, h, vd), dtype=f32, device=dev)
    for k0 in range(0, q0 + bq, bkv):
      sc = torch.einsum("bqhd,bkhd->bhqk", qn,
                        k_nope[:, k0:k0 + bkv].to(f32))
      sc = sc + torch.einsum("bqhr,bkr->bhqk", qr,
                             k_rope[:, k0:k0 + bkv].to(f32))
      sc = sc * scale
      kpos = torch.arange(k0, k0 + bkv, device=dev)[None, :]
      sc = torch.where(kpos <= qpos, sc, NEG_INF)
      m_new = torch.maximum(mx, sc.amax(dim=-1))
      pexp = torch.exp(sc - m_new[..., None])
      alpha = torch.exp(mx - m_new)
      l = l * alpha + pexp.sum(dim=-1)
      o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
          "bhqk,bkhd->bqhd", pexp, v[:, k0:k0 + bkv].to(f32))
      mx = m_new
    o = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    blocks.append(o.to(dtype))
  return torch.cat(blocks, dim=1)


# ----------------------------------------------------------------------------
# Decode (the absorbed form over the latent cache).
# ----------------------------------------------------------------------------

def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   stack: tuple = (), dtype=None, device=None) -> dict:
  m = cfg.mla
  dtype = dtype or cfg.dtype
  lead = tuple(stack) + (batch, max_len)
  return {"c_kv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                              device=device),
          "k_rope": torch.zeros(lead + (m.qk_rope_dim,), dtype=dtype,
                                device=device)}


def _as_w(leaf) -> torch.Tensor:
  """A GEMM leaf as its float weight: W = UV for a factored leaf, the
  dequantized W for a quantized one."""
  return leaf.product() if hasattr(leaf, "product") else leaf


def _absorbed(p, x: torch.Tensor, cache: dict, positions: torch.Tensor,
              cfg: ModelConfig, policy) -> tuple[torch.Tensor, dict]:
  """x (b, W, d) at positions `positions + t` against the latent cache:
  scores = (q_nope^T W_uk) c + q_rope^T k_rope, out = W_uv^T (sum p c),
  query t reading cache rows <= positions + t. On DTensors (a mesh) the
  queries are absorbed into the latent space on each rank's heads, then
  every head of a rank's rows attends over the rank's block of the
  cache's length, the blocks combined across the model axis
  (`softmax_mix`), and W_uv maps the context out on each rank's heads
  again: no rank reads another's cache, nor gathers W_uk or W_uv."""
  m, h = cfg.mla, cfg.num_heads
  b, w, _ = x.shape
  pos = positions[:, None] + torch.arange(w, device=x.device)[None, :]
  q_nope, q_rope = _queries(p, x, cfg, pos, policy)
  c_new, kr_new = _latents(p, x, cfg, pos, policy)
  c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
  write_rows(c_cache, c_new, positions, pos)
  write_rows(kr_cache, kr_new, positions, pos)
  w_uk = _as_w(p["w_uk"]).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
  w_uv = _as_w(p["w_uv"]).reshape(m.kv_lora_rank, h, m.v_head_dim)
  scale = 1.0 / ((m.qk_nope_dim + m.qk_rope_dim) ** 0.5)
  f32 = torch.float32
  q_lat = shd.split_call(
      lambda qn, wk: torch.einsum("bqhd,rhd->bqhr", qn.to(f32), wk.to(f32)),
      (q_nope, "bsh"), (w_uk, ".h"), out="bsh")
  ctx = shd.split_call(_latent_attend, (q_lat, "b"), (q_rope, "b"),
                       (c_cache, "bl"), (kr_cache, "bl"), (pos, "b"),
                       out="b", scale=scale)
  out = shd.split_call(
      lambda cx, wv: torch.einsum("bqhr,rhd->bqhd", cx, wv.to(f32)),
      (ctx, "bsh"), (w_uv, ".h"), out="bsh")
  out = out.reshape(b, w, h * m.v_head_dim).to(x.dtype)
  return gemm(p["wo"], out, policy), cache


def _latent_attend(q_lat, q_rope, c_cache, kr_cache, pos, *, scale: float,
                   group, offset: int) -> torch.Tensor:
  """The absorbed attention in the latent space, of plain tensors: q_lat
  (b, W, h, r) f32, q_rope (b, W, h, rope), the latent cache rows c (b,
  S', r) and k_rope (b, S', rope) from position `offset` on, pos (b, W)
  -> the context (b, W, h, r) f32 (`softmax_mix` over `group`)."""
  f32 = torch.float32
  c = c_cache.to(f32)
  sc = torch.einsum("bqhr,bsr->bqhs", q_lat, c)
  sc = sc + torch.einsum("bqhr,bsr->bqhs", q_rope.to(f32), kr_cache.to(f32))
  sc = sc * scale
  mask = torch.arange(offset, offset + c.shape[1], device=c.device)[
      None, None, :] <= pos[:, :, None]                   # (b, W, S')
  sc = torch.where(mask[:, :, None, :], sc, NEG_INF)
  return softmax_mix(sc, lambda pr: torch.einsum("bqhs,bsr->bqhr", pr, c),
                     group)


def mla_decode(p, x: torch.Tensor, cache: dict, positions: torch.Tensor,
               cfg: ModelConfig, policy=None,
               cs: Constraint = identity_constraint
               ) -> tuple[torch.Tensor, dict]:
  """One absorbed-form decode step. x: (b, 1, d); positions: (b,) write
  offsets; cache {"c_kv", "k_rope"}: (b, max_len, ...), updated in
  place."""
  return _absorbed(p, x, cache, positions, cfg, policy)


def mla_decode_window(p, x: torch.Tensor, cache: dict,
                      positions: torch.Tensor, cfg: ModelConfig,
                      policy=None, cs: Constraint = identity_constraint
                      ) -> tuple[torch.Tensor, dict]:
  """Batched W-token absorbed-form decode (speculative verification).
  x: (b, W, d); positions: (b,) start. The query and latent projections
  run as (b*W)-row GEMMs (one weight pass), the W new latents are
  written at positions + t, and every window query scores the cache
  under its own causal mask. Each row equals W sequential `mla_decode`
  steps' to f32 summation order."""
  return _absorbed(p, x, cache, positions, cfg, policy)
