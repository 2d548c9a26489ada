"""GQA attention: blockwise causal prefill and cached decode.

Counterpart of `repro.layers.attention` for the dense transformer,
qwen3's qk-norm included (a per-head RMSNorm of q and k after their
projections and before RoPE, on every path).
`flash_attention` keeps the reference's contract (causal; head j reads
kv head j // rep). Under a kernel policy it launches the hand-written
CUDA kernel (`kernels/csrc/flash_attention.cu`, through
`kernels.dispatch.maybe_flash_attention`) on the un-repeated kv heads,
which the kernel reads in place; otherwise it repeats the kv heads, as
the reference does, and runs the plain blockwise online softmax over
`cfg.attn_block_q` x `cfg.attn_block_kv` tiles, which never builds the
S x S score matrix.

`bidir_attention_forward` is Whisper's encoder self-attention, the
reference's `_bidir_attention`: non-causal, no RoPE, under a kernel
policy the same kernel in its non-causal mode (recorded as "enc/attn"),
otherwise the plain online softmax over kv blocks of
min(cfg.attn_block_kv, s), which must divide s (the reference reshapes
k and v into blocks; both routes raise where it would fail).

`attention_decode` and `attention_decode_window` (speculative
verification: W tokens a slot in one pass) write the new K/V rows into
the cache in place (the reference returns a new cache; a copy per step
would double the cache traffic) and return the same dict. A row at or
past max_len is dropped, as the reference's scatter drops it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.factored import dense
from repro_torch.kernels import dispatch
from repro_torch.layers.common import ModelConfig, gemm
from repro_torch.layers.norms import init_rms, rms_norm
from repro_torch.layers.rope import apply_rope

NEG_INF = -2.0 ** 30  # large-negative in f32: exp never sees inf - inf


class Attention(nn.Module):
  """wq (d, h*hd), wk/wv (d, kv*hd), wo (h*hd, d); layer-stacked in a
  model. With qwen3's qk-norm also `q_norm`, `k_norm`: per-head RMSNorm
  scales (hd,) in f32, (L, hd) stacked."""

  def __init__(self, wq: nn.Module, wk: nn.Module, wv: nn.Module,
               wo: nn.Module, q_norm: Optional[torch.Tensor] = None,
               k_norm: Optional[torch.Tensor] = None):
    super().__init__()
    if (q_norm is None) != (k_norm is None):
      raise ValueError("Attention takes both q_norm and k_norm, or neither")
    self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
    self.q_norm = None if q_norm is None else nn.Parameter(
        q_norm, requires_grad=False)
    self.k_norm = None if k_norm is None else nn.Parameter(
        k_norm, requires_grad=False)


def init_attention(cfg: ModelConfig, *, layer_prefix: str, stack: tuple = (),
                   generator: torch.Generator, device) -> Attention:
  d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
  hd = cfg.resolved_head_dim
  kw = dict(dtype=cfg.dtype, stack=stack, generator=generator, device=device)
  norms = {}
  if cfg.qk_norm:
    norms = {k: init_rms(hd, stack=stack, device=device)
             for k in ("q_norm", "k_norm")}
  return Attention(dense(d, h * hd, name=f"{layer_prefix}/attn_q", **kw),
                   dense(d, kv * hd, name=f"{layer_prefix}/attn_k", **kw),
                   dense(d, kv * hd, name=f"{layer_prefix}/attn_v", **kw),
                   dense(h * hd, d, name=f"{layer_prefix}/attn_o", **kw),
                   **norms)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, policy=None):
  b, s, _ = x.shape
  h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
  q = gemm(p["wq"], x, policy).reshape(b, s, h, hd)
  k = gemm(p["wk"], x, policy).reshape(b, s, kv, hd)
  v = gemm(p["wv"], x, policy).reshape(b, s, kv, hd)
  if cfg.qk_norm:             # per head, before RoPE, as the reference
    q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k = rms_norm(k, p["k_norm"], cfg.norm_eps)
  q = apply_rope(q, positions, cfg.rope_theta)
  k = apply_rope(k, positions, cfg.rope_theta)
  return q, k, v


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_q: int, block_kv: int) -> torch.Tensor:
  """Plain causal online-softmax attention over (block_q x block_kv)
  tiles. q, k, v: (b, s, h, hd), kv heads already repeated.

  Scores, running max, sum and accumulator are f32; output in q.dtype.
  Tiles wholly above the diagonal are skipped: in the reference they
  add exp(NEG_INF - m) = 0 to the sums and scale them by exp(0) = 1, so
  the result is the same. A ragged last tile is sliced, not padded."""
  b, s, h, hd = q.shape
  bq, bkv = min(block_q, s), min(block_kv, s)
  scale = 1.0 / (hd ** 0.5)
  f32 = torch.float32
  out = torch.empty_like(q)
  for q0 in range(0, s, bq):
    q_blk = q[:, q0:q0 + bq].to(f32)
    n = q_blk.shape[1]
    qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
    m = torch.full((b, h, n), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, h, n), dtype=f32, device=q.device)
    o = torch.zeros((b, n, h, hd), dtype=f32, device=q.device)
    for k0 in range(0, min(s, q0 + n), bkv):
      kj = k[:, k0:k0 + bkv].to(f32)
      vj = v[:, k0:k0 + bkv].to(f32)
      sc = torch.einsum("bqhd,bkhd->bhqk", q_blk, kj) * scale
      kpos = torch.arange(k0, k0 + kj.shape[1], device=q.device)[None, :]
      sc = torch.where(kpos <= qpos, sc, NEG_INF)
      m_new = torch.maximum(m, sc.amax(dim=-1))
      p = torch.exp(sc - m_new[..., None])
      alpha = torch.exp(m - m_new)
      l = l * alpha + p.sum(dim=-1)
      o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
          "bhqk,bkhd->bqhd", p, vj)
      m = m_new
    o = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    out[:, q0:q0 + n] = o.to(q.dtype)
  return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: ModelConfig, policy=None) -> torch.Tensor:
  """Causal attention. q: (b, s, h, hd); k, v: (b, s, kv, hd)."""
  out = dispatch.maybe_flash_attention(q, k, v, policy, name="layers/attn")
  if out is not None:
    return out
  h, kvh = q.shape[2], k.shape[2]
  if h != kvh:
    rep = h // kvh
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
  return blockwise_attention(q, k, v, cfg.attn_block_q, cfg.attn_block_kv)


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      policy=None) -> torch.Tensor:
  """Full-sequence causal self-attention (prefill, training). `p` maps
  "wq", "wk", "wv", "wo" to 2-D leaves (and, with qk-norm, "q_norm",
  "k_norm" to (hd,) scales)."""
  b, s, _ = x.shape
  positions = torch.arange(s, device=x.device)[None].expand(b, s)
  q, k, v = _project_qkv(p, x, cfg, positions, policy)
  out = flash_attention(q, k, v, cfg, policy)
  h, hd = cfg.num_heads, cfg.resolved_head_dim
  return gemm(p["wo"], out.reshape(b, s, h * hd), policy)


def _bidir_block(s: int, block_kv: int) -> int:
  """The kv block of a non-causal attention over s positions:
  min(block_kv, s), which must divide s."""
  bkv = min(block_kv, s)
  if s % bkv:
    raise ValueError(
        f"non-causal attention over {s} positions with attn_block_kv="
        f"{block_kv}: the kv block {bkv} does not divide {s} (the "
        "reference reshapes k and v into s // block blocks); pick an "
        f"attn_block_kv that divides {s}")
  return bkv


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, block_kv: int) -> torch.Tensor:
  """Plain non-causal online-softmax attention over kv blocks of
  `block_kv` rows (dividing s); every query row whole. q, k, v:
  (b, s, h, hd). Scores, running max, sum and accumulator are f32;
  output in q.dtype."""
  b, s, h, hd = q.shape
  scale = 1.0 / (hd ** 0.5)
  f32 = torch.float32
  qf = q.to(f32)
  m = torch.full((b, h, s), NEG_INF, dtype=f32, device=q.device)
  l = torch.zeros((b, h, s), dtype=f32, device=q.device)
  o = torch.zeros((b, s, h, hd), dtype=f32, device=q.device)
  for k0 in range(0, s, block_kv):
    kj = k[:, k0:k0 + block_kv].to(f32)
    vj = v[:, k0:k0 + block_kv].to(f32)
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kj) * scale
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, vj)
    m = m_new
  o = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
  return o.to(q.dtype)


def bidir_attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                            policy=None) -> torch.Tensor:
  """Whisper's encoder self-attention over x (b, s, d): non-causal, no
  RoPE, q, k and v at cfg.num_heads heads. `p` maps "wq", "wk", "wv",
  "wo" to 2-D leaves."""
  b, s, _ = x.shape
  bkv = _bidir_block(s, cfg.attn_block_kv)
  h, hd = cfg.num_heads, cfg.resolved_head_dim
  q, k, v = (gemm(p[w], x, policy).reshape(b, s, h, hd)
             for w in ("wq", "wk", "wv"))
  out = dispatch.maybe_flash_attention(q, k, v, policy, name="enc/attn",
                                       causal=False)
  if out is None:
    out = bidirectional_attention(q, k, v, bkv)
  return gemm(p["wo"], out.reshape(b, s, h * hd), policy)


# ----------------------------------------------------------------------------
# Decode path (one new token against a KV cache).
# ----------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  stack: tuple = (), dtype=None, device=None) -> dict:
  kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
  shape = tuple(stack) + (batch, max_len, kv, hd)
  dtype = dtype or cfg.dtype
  return {"k": torch.zeros(shape, dtype=dtype, device=device),
          "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_rows(cache: torch.Tensor, new: torch.Tensor,
                start: torch.Tensor, pos: torch.Tensor) -> None:
  """cache[i, pos[i, t]] = new[i, t] in place; cache (b, S, ...), new
  (b, W, ...) (GQA's (kv, hd) rows, MLA's latent rows), pos (b, W) =
  start[:, None] + t. A row at or past S is
  dropped (the reference's scatter drops it; an index past S would
  raise here, or assert on the device) without a host sync: it rewrites
  row clamp(start - 1, 0, S - 1) with that row's own value, a row this
  call writes nowhere else unless start is 0 and W > S (an idle slot's
  window, whose rows are garbage until its next admit)."""
  b, s = cache.shape[:2]
  valid = pos < s
  spare = (start - 1).clamp(0, s - 1)[:, None].expand_as(pos)
  rows = torch.where(valid, pos, spare)
  bidx = torch.arange(b, device=cache.device)[:, None].expand_as(pos)
  keep = valid.reshape(valid.shape + (1,) * (new.ndim - 2))
  cache[bidx, rows] = torch.where(keep, new.to(cache.dtype),
                                  cache[bidx, rows])


def attention_decode(p, x: torch.Tensor, cache: dict,
                     positions: torch.Tensor, cfg: ModelConfig,
                     policy=None) -> tuple[torch.Tensor, dict]:
  """One decode step. x: (b, 1, d); positions: (b,) write offsets;
  cache {"k", "v"}: (b, max_len, kv, hd), updated in place."""
  b = x.shape[0]
  h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
  q, k_new, v_new = _project_qkv(p, x, cfg, positions[:, None], policy)
  k, v = cache["k"], cache["v"]
  write_rows(k, k_new, positions, positions[:, None])
  write_rows(v, v_new, positions, positions[:, None])
  f32 = torch.float32
  mask = torch.arange(k.shape[1], device=x.device)[None, :] <= \
      positions[:, None]                                   # (b, S)
  if h != kvh:
    # kv heads grouped into the score einsum instead of repeated
    group = h // kvh
    qg = q[:, 0].reshape(b, kvh, group, hd)
    sc = torch.einsum("bkgd,bskd->bkgs", qg.to(f32), k.to(f32)) / (hd ** 0.5)
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", pr, v.to(f32))
  else:
    sc = torch.einsum("bhd,bshd->bhs", q[:, 0].to(f32), k.to(f32)) / \
        (hd ** 0.5)
    sc = torch.where(mask[:, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", pr, v.to(f32))
  out = out.reshape(b, 1, h * hd).to(x.dtype)
  return gemm(p["wo"], out, policy), cache


def attention_decode_window(p, x: torch.Tensor, cache: dict,
                            positions: torch.Tensor, cfg: ModelConfig,
                            policy=None) -> tuple[torch.Tensor, dict]:
  """Batched W-token decode window. x: (b, W, d); positions: (b,) start;
  cache {"k", "v"}: (b, max_len, kv, hd), updated in place.

  The speculative-verify forward: the W tokens go through the q/k/v/o
  GEMMs as one (b*W)-row pass (one weight read for the whole window, the
  paper's §4 amortization), then attend causally against the cache with
  per-query masks (query t sees positions <= positions + t). Each row
  computes what `attention_decode` computes for its token; the two
  agree to f32 summation order, not bit for bit (the GEMMs and the
  score einsums block their rows differently)."""
  b, w, _ = x.shape
  h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
  pos = positions[:, None] + torch.arange(w, device=x.device)[None, :]
  q, k_new, v_new = _project_qkv(p, x, cfg, pos, policy)
  k, v = cache["k"], cache["v"]
  write_rows(k, k_new, positions, pos)
  write_rows(v, v_new, positions, pos)
  f32 = torch.float32
  mask = torch.arange(k.shape[1], device=x.device)[None, None, :] <= \
      pos[:, :, None]                                      # (b, W, S)
  if h != kvh:
    group = h // kvh
    qg = q.reshape(b, w, kvh, group, hd)
    sc = torch.einsum("bqkgd,bskd->bqkgs", qg.to(f32), k.to(f32)) / \
        (hd ** 0.5)
    sc = torch.where(mask[:, :, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", pr, v.to(f32))
  else:
    sc = torch.einsum("bqhd,bshd->bqhs", q.to(f32), k.to(f32)) / (hd ** 0.5)
    sc = torch.where(mask[:, :, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqhs,bshd->bqhd", pr, v.to(f32))
  out = out.reshape(b, w, h * hd).to(x.dtype)
  return gemm(p["wo"], out, policy), cache
