"""Decoder-only transformer LM — counterpart of `repro.models.transformer`:
the dense GQA archs (chameleon, llama3, glm4, stablelm and qwen3's
qk-norm) and the DeepSeek family (MLA attention, the capacity-routed
MoE with shared experts, DeepSeek-V3's q-LoRA and MTP head).

Params keep the reference's layer-stacked layout: `dense_layers` (the
dense-FFN layers; with a MoE config the first `first_dense_layers`) and,
under `cfg.moe`, `moe_layers`, each a stack whose leaves carry a leading
layer axis (`ln1` (L, d), `attn.wq.w` (L, d, h*hd), the experts'
`moe.w_gate.w` (L, E, d, f), ...), so `state_dict()` keys are the
checkpoint paths (`dense_layers.attn.wq.w` for `dense_layers/attn/wq/w`).
The reference scans over each stack; here a Python loop walks the layers
and takes layer i's leaves from `layers()`. `cfg.mla` puts MLA in place
of GQA; `cfg.mtp` adds the `mtp` head (`proj`, one unstacked dense
layer, `norm`), which only `loss_fn` runs, with no kernel policy, as the
reference does.

`forward` returns the logits; `forward_with_aux` also returns the summed
MoE load-balance loss, which `loss_fn` adds as the reference does
(xent + router_aux_weight * aux + 0.3 * MTP xent). `cfg.remat`
checkpoints each layer of a training forward as the reference's
`jax.remat` does.

`decode_step` and `decode_window` update the decode state in place and
return it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.factored import dense, is_gemm_leaf
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mla as mla_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers.common import ModelConfig, gemm
from repro_torch.layers.embedding import (Embedding, embed, init_embedding,
                                          logits as lm_logits)
from repro_torch.layers.ffn import SwiGLU, init_swiglu, swiglu_forward
from repro_torch.layers.norms import init_rms, rms_norm


def check_supported(cfg: ModelConfig) -> None:
  if cfg.family != "transformer":
    raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                     "transformer")


def depths(cfg: ModelConfig) -> tuple[int, int]:
  """(dense-FFN layers, MoE layers): the reference's two stacks."""
  if cfg.moe is None:
    return cfg.num_layers, 0
  n_dense = cfg.moe.first_dense_layers
  return n_dense, cfg.num_layers - n_dense


def _view(mod: nn.Module, i: Optional[int]) -> dict:
  """`mod`'s params and GEMM leaves as the reference's nested dict:
  layer i of every stacked leaf (views sharing storage), or with i None
  the leaves themselves."""
  out = {}
  for key, t in mod._parameters.items():
    if t is not None:
      out[key] = t if i is None else t[i]
  for key, child in mod._modules.items():
    if child is None:
      continue
    if is_gemm_leaf(child):
      out[key] = child if i is None else child.layer(i)
    else:
      out[key] = _view(child, i)
  return out


def _stacked(mod: nn.Module) -> list:
  """`mod`'s params and GEMM-leaf modules, depth-first."""
  out = [t for t in mod._parameters.values() if t is not None]
  for child in mod._modules.values():
    if child is None:
      continue
    out.extend([child] if is_gemm_leaf(child) else _stacked(child))
  return out


class StackedLayers(nn.Module):
  """Base of a model's layer stacks: the L layers' params stacked on a
  leading axis, with per-layer views (`layers()`): layer i's dict of the
  stack's params and GEMM leaves, each at index i, nested as the
  submodules nest."""

  def __init__(self):
    super().__init__()
    self._views = None        # (stacked leaves, per-layer dicts)

  def _leaves(self) -> tuple:
    return tuple(_stacked(self))

  def _build_views(self) -> list[dict]:
    depth = next(iter(self.parameters())).shape[0]
    return [_view(self, i) for i in range(depth)]

  def _apply(self, fn, *args, **kwargs):
    self._views = None        # a move or cast gives the params new storage
    return super()._apply(fn, *args, **kwargs)

  def __getstate__(self):
    # copies and pickles rebuild the views on their own storage
    return {**self.__dict__, "_views": None}

  def layers(self) -> list[dict]:
    """Per-layer views in the reference's dict shape, each leaf sharing
    storage with layer i of its stack.

    Where autograd could record them (grad mode on and a leaf that
    requires grad) the views are built anew on each call, so each
    forward's graph reaches the stacked leaves through its own views. A
    kept view would carry an earlier step's graph, or, built while the
    params were frozen, none at all. Otherwise (serving) they are built
    once and kept until a leaf is replaced or `_apply` (`.to()`, ...)
    moves the params: a step would otherwise build a leaf module a GEMM
    and layer."""
    leaves = self._leaves()
    if torch.is_grad_enabled() and any(
        t.requires_grad for leaf in leaves if leaf is not None
        for t in ([leaf] if isinstance(leaf, torch.Tensor)
                  else leaf.parameters())):
      return self._build_views()
    if self._views is None or any(
        a is not b for a, b in zip(self._views[0], leaves)):
      self._views = (leaves, self._build_views())
    return self._views[1]


class LayerStack(StackedLayers):
  """The dense-FFN layers: [{"ln1", "ln2", "attn": {"wq", ...,
  ["q_norm", "k_norm"]} or MLA's {"wq" | "wq_a", "q_a_norm", "wq_b",
  "w_dkv", "kv_a_norm", "w_uk", "w_uv", "wo"}, "ffn": {"w_gate", ...}}]
  a layer."""

  def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor, attn: nn.Module,
               ffn: SwiGLU):
    super().__init__()
    self.ln1 = nn.Parameter(ln1, requires_grad=False)
    self.ln2 = nn.Parameter(ln2, requires_grad=False)
    self.attn = attn
    self.ffn = ffn


class MoELayerStack(StackedLayers):
  """The MoE layers: as `LayerStack` with "moe": {"router" (d, E),
  "w_gate", "w_up", "w_down" (E, m, n leaves), "shared": {"w_gate",
  ...}} in place of "ffn"."""

  def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor, attn: nn.Module,
               moe: moe_lib.MoE):
    super().__init__()
    self.ln1 = nn.Parameter(ln1, requires_grad=False)
    self.ln2 = nn.Parameter(ln2, requires_grad=False)
    self.attn = attn
    self.moe = moe


class DenseLayer(nn.Module):
  """One unstacked dense-FFN layer (the MTP head's): 2-D leaves."""

  def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor, attn: nn.Module,
               ffn: SwiGLU):
    super().__init__()
    self.ln1 = nn.Parameter(ln1, requires_grad=False)
    self.ln2 = nn.Parameter(ln2, requires_grad=False)
    self.attn = attn
    self.ffn = ffn

  def view(self) -> dict:
    return _view(self, None)


class MTP(nn.Module):
  """DeepSeek-V3's multi-token-prediction head: `proj` (2d, d), `layer`
  (a `DenseLayer`) and `norm` (d,) f32."""

  def __init__(self, proj: nn.Module, layer: DenseLayer, norm: torch.Tensor):
    super().__init__()
    self.proj = proj
    self.layer = layer
    self.norm = nn.Parameter(norm, requires_grad=False)


class TransformerLM(nn.Module):
  """`embedding`, `final_norm`, `dense_layers`, and with a MoE config
  `moe_layers`, with MTP `mtp`: the reference's tree. A stack the config
  does not have is None."""

  def __init__(self, embedding: Embedding, final_norm: torch.Tensor,
               dense_layers: Optional[LayerStack] = None,
               moe_layers: Optional[MoELayerStack] = None,
               mtp: Optional[MTP] = None):
    super().__init__()
    self.embedding = embedding
    self.final_norm = nn.Parameter(final_norm, requires_grad=False)
    self.dense_layers = dense_layers
    self.moe_layers = moe_layers
    self.mtp = mtp

  def stacks(self) -> list[tuple[str, StackedLayers]]:
    """(decode-state key, stack) of each stack the model has, in order."""
    return [(key, s) for key, s in (("dense", self.dense_layers),
                                    ("moe", self.moe_layers))
            if s is not None]


def _init_attn(cfg: ModelConfig, stack: tuple, generator, device):
  if cfg.mla is not None:
    return mla_lib.init_mla(cfg, layer_prefix="layers", stack=stack,
                            generator=generator, device=device)
  return attn_lib.init_attention(cfg, layer_prefix="layers", stack=stack,
                                 generator=generator, device=device)


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device=None) -> TransformerLM:
  """Random weights from `generator`, on `device` (default: the GPU). A
  CPU generator gives the same weights on every device; a CUDA
  generator draws on the card in cfg.dtype (full width)."""
  check_supported(cfg)
  device = resolve_device(device)
  d = cfg.d_model
  kw = dict(generator=generator, device=device)
  emb = init_embedding(cfg.vocab_size, d, dtype=cfg.dtype,
                       tie=cfg.tie_embeddings, **kw)
  n_dense, n_moe = depths(cfg)

  def norms(stack):
    return (init_rms(d, stack=stack, device=device),
            init_rms(d, stack=stack, device=device))

  def ffn(stack):
    return init_swiglu(d, cfg.d_ff, layer_prefix="layers", dtype=cfg.dtype,
                       stack=stack, **kw)

  dense_layers = moe_layers = mtp = None
  if n_dense:
    stack = (n_dense,)
    dense_layers = LayerStack(*norms(stack), _init_attn(cfg, stack, **kw),
                              ffn(stack))
  if n_moe:
    stack = (n_moe,)
    moe_layers = MoELayerStack(
        *norms(stack), _init_attn(cfg, stack, **kw),
        moe_lib.init_moe(cfg, layer_prefix="layers", stack=stack, **kw))
  if cfg.mtp:
    proj = dense(2 * d, d, name="mtp/proj", dtype=cfg.dtype, **kw)
    layer = DenseLayer(*norms(()), _init_attn(cfg, (), **kw), ffn(()))
    mtp = MTP(proj, layer, init_rms(d, device=device))
  return TransformerLM(emb, init_rms(d, device=device), dense_layers,
                       moe_layers, mtp)


def _attend(p, x: torch.Tensor, cfg: ModelConfig, policy) -> torch.Tensor:
  if cfg.mla is not None:
    return mla_lib.mla_forward(p, x, cfg, policy)
  return attn_lib.attention_forward(p, x, cfg, policy)


def _layer_fwd(x: torch.Tensor, lp: dict, cfg: ModelConfig,
               policy=None) -> torch.Tensor:
  h = rms_norm(x, lp["ln1"], cfg.norm_eps)
  x = x + _attend(lp["attn"], h, cfg, policy)
  h = rms_norm(x, lp["ln2"], cfg.norm_eps)
  return x + swiglu_forward(lp["ffn"], h, policy)


def _moe_layer_fwd(x: torch.Tensor, lp: dict, cfg: ModelConfig,
                   policy=None) -> tuple[torch.Tensor, torch.Tensor]:
  h = rms_norm(x, lp["ln1"], cfg.norm_eps)
  x = x + _attend(lp["attn"], h, cfg, policy)
  h = rms_norm(x, lp["ln2"], cfg.norm_eps)
  f, aux = moe_lib.moe_forward(lp["moe"], h, cfg, policy)
  return x + f, aux


#: the matmul ops whose outputs remat="dots" keeps (the reference's
#: `dots_with_no_batch_dims_saveable`: the GEMMs, not the batched einsums
#: of the attention and the experts)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
  return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
          else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(cfg: ModelConfig, policy, recorded: bool,
                 body=_layer_fwd):
  """The layer body under `cfg.remat`, as the reference wraps its scanned
  body: "full" recomputes the whole layer in the backward pass, "dots"
  keeps the GEMM outputs and recomputes the rest, "none" keeps all. Only
  a forward that autograd records (`recorded`) is checkpointed."""
  body = functools.partial(body, cfg=cfg, policy=policy)
  if cfg.remat == "none" or not recorded:
    return body
  if cfg.remat == "full":
    return functools.partial(ckpt.checkpoint, body, use_reentrant=False)
  if cfg.remat == "dots":
    return functools.partial(
        ckpt.checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _save_dots))
  raise ValueError(f"{cfg.name}: unknown remat policy {cfg.remat!r}")


def forward_with_aux(params: TransformerLM, tokens: torch.Tensor,
                     cfg: ModelConfig, *, last_only: bool = False,
                     policy=None) -> tuple[torch.Tensor, torch.Tensor]:
  """tokens (b, s) -> (logits (b, s, v), MoE aux loss () f32: the sum of
  the MoE layers' load-balance losses, 0 for a dense model).

  last_only=True (serving prefill) narrows to the final position before
  the vocab projection, so the (b, s, v) logits never exist."""
  x = embed(params.embedding, tokens)
  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  recorded = torch.is_grad_enabled() and any(
      p.requires_grad for p in params.parameters())
  with dispatch.scanned():              # the reference's layer scans
    if params.dense_layers is not None:
      layer = _remat_layer(cfg, policy, recorded)
      for lp in params.dense_layers.layers():
        x = layer(x, lp)
    if params.moe_layers is not None:
      layer = _remat_layer(cfg, policy, recorded, _moe_layer_fwd)
      for lp in params.moe_layers.layers():
        x, a = layer(x, lp)
        aux = aux + a
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  if last_only:
    x = x[:, -1:]
  return lm_logits(params.embedding, x, policy), aux


def forward(params: TransformerLM, tokens: torch.Tensor, cfg: ModelConfig,
            *, last_only: bool = False, policy=None) -> torch.Tensor:
  """tokens (b, s) -> logits (b, s, v) (`forward_with_aux` without the
  aux loss)."""
  return forward_with_aux(params, tokens, cfg, last_only=last_only,
                          policy=policy)[0]


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
  """Mean next-token cross-entropy, log-softmax in f32."""
  lp = torch.log_softmax(logits.float(), dim=-1)
  return -lp.gather(-1, targets[..., None].long())[..., 0].mean()


def _mtp_loss(params: TransformerLM, tokens: torch.Tensor,
              targets: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  """Multi-token prediction (deepseek-v3): predict t+2 from
  [h_t; emb_{t+1}] through the head's own dense layer (no policy, no
  remat). The full length is kept (the MLA blocks need s % block == 0);
  the roll wraps the last position, which the target slice drops."""
  head = params.mtp
  x = embed(params.embedding, tokens)
  h = torch.cat([x, torch.roll(x, -1, dims=1)], dim=-1)
  h = gemm(head.proj, h)
  h = _layer_fwd(h, head.layer.view(), cfg)
  h = rms_norm(h, head.norm, cfg.norm_eps)
  logits = lm_logits(params.embedding, h)
  if targets.shape[1] > 2:
    return _xent(logits[:, :-2], targets[:, 2:])
  return _xent(logits[:, -1:], targets[:, -1:])


def loss_fn(params: TransformerLM, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
  """The loss of a batch {"tokens", "targets"} (b, s), tensors or numpy
  arrays, through the full forward with no kernel policy (no kernel has a
  backward): the next-token cross-entropy, plus router_aux_weight times
  the MoE aux loss under a MoE config, plus 0.3 times the MTP head's
  cross-entropy under `cfg.mtp`. Returns (loss, {"xent", "moe_aux"} and,
  with MTP, "mtp"); a dense model's MoE aux loss is 0, as the
  reference's."""
  check_supported(cfg)
  dev = params.final_norm.device
  tokens, targets = (torch.as_tensor(batch[k], device=dev).long()
                     for k in ("tokens", "targets"))
  logits, aux = forward_with_aux(params, tokens, cfg)
  xent = _xent(logits, targets)
  metrics = {"xent": xent, "moe_aux": aux}
  total = xent
  if cfg.moe:
    total = total + cfg.moe.router_aux_weight * aux
  if cfg.mtp and params.mtp is not None:
    mtp = _mtp_loss(params, tokens, targets, cfg)
    metrics["mtp"] = mtp
    total = total + 0.3 * mtp
  return total, metrics


# ----------------------------------------------------------------------------
# Decode.
# ----------------------------------------------------------------------------

def _cache_keys(cfg: ModelConfig) -> tuple:
  return ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=None, device=None) -> dict:
  """{"dense": cache, ["moe": cache]}, zeros, on `device` (default: the
  GPU): GQA's {"k", "v"} (L, batch, max_len, kv, hd), or MLA's latent
  {"c_kv" (L, batch, max_len, kv_lora), "k_rope" (..., rope)}."""
  check_supported(cfg)
  device = resolve_device(device)
  mk = (mla_lib.init_mla_cache if cfg.mla is not None
        else attn_lib.init_kv_cache)
  state = {}
  for key, depth in zip(("dense", "moe"), depths(cfg)):
    if depth:
      state[key] = mk(cfg, batch, max_len, stack=(depth,),
                      dtype=cache_dtype, device=device)
  return state


def decode_state_batch_axes(cfg: ModelConfig) -> dict:
  """Batch axis of every decode-state leaf (after the layer axis)."""
  return {key: {k: 1 for k in _cache_keys(cfg)}
          for key, depth in zip(("dense", "moe"), depths(cfg)) if depth}


def decode_state_carry(cfg: ModelConfig) -> dict:
  """Speculative-rewind contract: the whole decode state is attention KV
  (GQA k/v or MLA c_kv/k_rope) written at absolute positions. Rows past
  the committed position are never read under the causal mask, so a
  rejected draft suffix rewinds by moving the position counter alone
  (no leaf is a carry)."""
  return {key: {k: False for k in axes}
          for key, axes in decode_state_batch_axes(cfg).items()}


def _decode_stack(params: TransformerLM, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, policy,
                  attend) -> tuple[torch.Tensor, dict]:
  x = embed(params.embedding, tokens)
  with dispatch.scanned():              # the reference's layer scans
    for key, stack in params.stacks():
      cache = state[key]
      for i, lp in enumerate(stack.layers()):
        a = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attend(lp["attn"], a, {k: c[i] for k, c in cache.items()},
                      positions, cfg, policy)
        x = x + a
        f = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
          f, _ = moe_lib.moe_forward(lp["moe"], f, cfg, policy)
        else:
          f = swiglu_forward(lp["ffn"], f, policy)
        x = x + f
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  return lm_logits(params.embedding, x, policy), state


def decode_step(params: TransformerLM, state: dict, token: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                policy=None) -> tuple[torch.Tensor, dict]:
  """token (b, 1), positions (b,) -> (logits (b, 1, v), state), the KV
  (or latent) rows at `positions` written into `state` in place."""
  attend = (mla_lib.mla_decode if cfg.mla is not None
            else attn_lib.attention_decode)
  return _decode_stack(params, state, token, positions, cfg, policy, attend)


def decode_window(params: TransformerLM, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig,
                  policy=None) -> tuple[torch.Tensor, dict]:
  """Batched window decode: tokens (b, W) at positions `positions + t`
  -> (logits (b, W, v), state after the W tokens, written in place). One
  weight pass for the whole window: every GEMM takes b*W rows (under the
  "cuda" policy `decode_matvec` up to 16 rows) and the attention runs
  `attention_decode_window` / `mla_decode_window`; norms, the FFN and the
  MoE are position-independent. Each row's logits equal W sequential
  `decode_step`s' to f32 summation order, as long as no MoE expert
  overflows its capacity in the window's b*W rows where the steps' b rows
  did not (the reference's capacity rule, at least 8 slots an expert)."""
  attend = (mla_lib.mla_decode_window if cfg.mla is not None
            else attn_lib.attention_decode_window)
  return _decode_stack(params, state, tokens, positions, cfg, policy, attend)
