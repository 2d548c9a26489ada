"""Decoder-only transformer LM — the dense GQA part of
`repro.models.transformer` (chameleon, llama3, glm4, stablelm and
qwen3's qk-norm).

Params keep the reference's layer-stacked layout: one `LayerStack`
whose leaves carry a leading layer axis (`ln1` (L, d), `attn.wq.w`
(L, d, h*hd), ...), so `state_dict()` keys are the checkpoint paths
(`dense_layers.attn.wq.w` for `dense_layers/attn/wq/w`). The reference
scans over that axis; here a Python loop walks the layers and takes
layer i's 2-D leaves from `LayerStack.layers()`. `loss_fn` is the
reference's next-token cross-entropy; `cfg.remat` checkpoints each
layer of a training forward as the reference's `jax.remat` does. The
MoE, MLA and MTP variants come with later slices.

`decode_step` and `decode_window` update the decode state in place and
return it.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.common import ModelConfig
from repro_torch.layers.embedding import (Embedding, embed, init_embedding,
                                          logits as lm_logits)
from repro_torch.layers.ffn import SwiGLU, init_swiglu, swiglu_forward
from repro_torch.layers.norms import init_rms, rms_norm

#: reference config features this slice does not port, and where they go
_LATER = {"moe": "the MoE slice", "mla": "the MLA (DeepSeek) slice",
          "mtp": "the DeepSeek MTP slice"}


def check_supported(cfg: ModelConfig) -> None:
  if cfg.family != "transformer":
    raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                     "transformer")
  for field, later in _LATER.items():
    if getattr(cfg, field, None):
      raise NotImplementedError(
          f"{cfg.name}: {field} is not ported yet; it comes with {later}")


class StackedLayers(nn.Module):
  """Base of a model's layer stacks: the L layers' params stacked on a
  leading axis, with per-layer views (`layers()`). A subclass names its
  stacked leaves (`_leaves`) and builds layer i's dict of 2-D views
  (`_build_views`)."""

  def __init__(self):
    super().__init__()
    self._views = None        # (stacked leaves, per-layer dicts)

  def _leaves(self) -> tuple:
    raise NotImplementedError

  def _build_views(self) -> list[dict]:
    raise NotImplementedError

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
  """The transformer's L layers: [{"ln1", "ln2", "attn": {"wq", ...,
  ["q_norm", "k_norm"]}, "ffn": {"w_gate", ...}}] a layer."""

  _ATTN = ("wq", "wk", "wv", "wo")
  _NORMS = ("q_norm", "k_norm")
  _FFN = ("w_gate", "w_up", "w_down")

  def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor,
               attn: attn_lib.Attention, ffn: SwiGLU):
    super().__init__()
    self.ln1 = nn.Parameter(ln1, requires_grad=False)
    self.ln2 = nn.Parameter(ln2, requires_grad=False)
    self.attn = attn
    self.ffn = ffn

  def _leaves(self) -> tuple:
    return (self.ln1, self.ln2, *(getattr(self.attn, k) for k in self._ATTN),
            *(getattr(self.attn, k) for k in self._NORMS),
            *(getattr(self.ffn, k) for k in self._FFN))

  def _build_views(self) -> list[dict]:
    def attn(i):
      out = {k: getattr(self.attn, k).layer(i) for k in self._ATTN}
      if self.attn.q_norm is not None:
        out.update(q_norm=self.attn.q_norm[i], k_norm=self.attn.k_norm[i])
      return out
    return [{"ln1": self.ln1[i], "ln2": self.ln2[i], "attn": attn(i),
             "ffn": {k: getattr(self.ffn, k).layer(i) for k in self._FFN}}
            for i in range(self.ln1.shape[0])]


class TransformerLM(nn.Module):
  """`embedding`, `final_norm`, `dense_layers`: the reference's tree."""

  def __init__(self, embedding: Embedding, final_norm: torch.Tensor,
               dense_layers: LayerStack):
    super().__init__()
    self.embedding = embedding
    self.final_norm = nn.Parameter(final_norm, requires_grad=False)
    self.dense_layers = dense_layers


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device=None) -> TransformerLM:
  """Random weights from `generator`, on `device` (default: the GPU). A
  CPU generator gives the same weights on every device; a CUDA
  generator draws on the card in cfg.dtype (full width)."""
  check_supported(cfg)
  device = resolve_device(device)
  stack = (cfg.num_layers,)
  d = cfg.d_model
  emb = init_embedding(cfg.vocab_size, d, dtype=cfg.dtype,
                       tie=cfg.tie_embeddings, generator=generator,
                       device=device)
  layers = LayerStack(
      init_rms(d, stack=stack, device=device),
      init_rms(d, stack=stack, device=device),
      attn_lib.init_attention(cfg, layer_prefix="layers", stack=stack,
                              generator=generator, device=device),
      init_swiglu(d, cfg.d_ff, layer_prefix="layers", dtype=cfg.dtype,
                  stack=stack, generator=generator, device=device))
  return TransformerLM(emb, init_rms(d, device=device), layers)


def _layer_fwd(x: torch.Tensor, lp: dict, cfg: ModelConfig,
               policy=None) -> torch.Tensor:
  h = rms_norm(x, lp["ln1"], cfg.norm_eps)
  x = x + attn_lib.attention_forward(lp["attn"], h, cfg, policy)
  h = rms_norm(x, lp["ln2"], cfg.norm_eps)
  return x + swiglu_forward(lp["ffn"], h, policy)


#: the matmul ops whose outputs remat="dots" keeps (the reference's
#: `dots_with_no_batch_dims_saveable`: the GEMMs, not the batched einsums
#: of the attention)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
  return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
          else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(cfg: ModelConfig, policy, recorded: bool):
  """The layer body under `cfg.remat`, as the reference wraps its scanned
  body: "full" recomputes the whole layer in the backward pass, "dots"
  keeps the GEMM outputs and recomputes the rest, "none" keeps all. Only
  a forward that autograd records (`recorded`) is checkpointed."""
  body = functools.partial(_layer_fwd, cfg=cfg, policy=policy)
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


def forward(params: TransformerLM, tokens: torch.Tensor, cfg: ModelConfig,
            *, last_only: bool = False, policy=None) -> torch.Tensor:
  """tokens (b, s) -> logits (b, s, v). The reference also returns the
  MoE aux loss, which a dense model does not have.

  last_only=True (serving prefill) narrows to the final position before
  the vocab projection, so the (b, s, v) logits never exist."""
  x = embed(params.embedding, tokens)
  layer = _remat_layer(cfg, policy, torch.is_grad_enabled() and any(
      p.requires_grad for p in params.parameters()))
  with dispatch.scanned():              # the reference's layer scan
    for lp in params.dense_layers.layers():
      x = layer(x, lp)
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  if last_only:
    x = x[:, -1:]
  return lm_logits(params.embedding, x, policy)


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
  """Mean next-token cross-entropy, log-softmax in f32."""
  lp = torch.log_softmax(logits.float(), dim=-1)
  return -lp.gather(-1, targets[..., None].long())[..., 0].mean()


def loss_fn(params: TransformerLM, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
  """The cross-entropy of a batch {"tokens", "targets"} (b, s), tensors
  or numpy arrays, through the full forward with no kernel policy (no
  kernel has a backward). Returns (loss, {"xent", "moe_aux"}); a dense
  model's MoE aux loss is 0, as the reference's."""
  check_supported(cfg)
  dev = params.final_norm.device
  tokens, targets = (torch.as_tensor(batch[k], device=dev).long()
                     for k in ("tokens", "targets"))
  loss = _xent(forward(params, tokens, cfg), targets)
  return loss, {"xent": loss,
                "moe_aux": torch.zeros((), dtype=torch.float32, device=dev)}


# ----------------------------------------------------------------------------
# Decode.
# ----------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=None, device=None) -> dict:
  """{"dense": {"k", "v"}}, each (L, batch, max_len, kv, hd), zeros, on
  `device` (default: the GPU)."""
  check_supported(cfg)
  device = resolve_device(device)
  return {"dense": attn_lib.init_kv_cache(
      cfg, batch, max_len, stack=(cfg.num_layers,), dtype=cache_dtype,
      device=device)}


def decode_state_batch_axes(cfg: ModelConfig) -> dict:
  """Batch axis of every decode-state leaf (after the layer axis)."""
  return {"dense": {"k": 1, "v": 1}}


def decode_state_carry(cfg: ModelConfig) -> dict:
  """Speculative-rewind contract: the whole decode state is attention KV
  written at absolute positions. Rows past the committed position are
  never read under the causal mask, so a rejected draft suffix rewinds
  by moving the position counter alone (no leaf is a carry)."""
  return {"dense": {"k": False, "v": False}}


def _decode_stack(params: TransformerLM, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, policy,
                  attend) -> tuple[torch.Tensor, dict]:
  x = embed(params.embedding, tokens)
  cache = state["dense"]
  with dispatch.scanned():              # the reference's layer scan
    for i, lp in enumerate(params.dense_layers.layers()):
      a = rms_norm(x, lp["ln1"], cfg.norm_eps)
      a, _ = attend(lp["attn"], a, {"k": cache["k"][i], "v": cache["v"][i]},
                    positions, cfg, policy)
      x = x + a
      f = rms_norm(x, lp["ln2"], cfg.norm_eps)
      x = x + swiglu_forward(lp["ffn"], f, policy)
  x = rms_norm(x, params.final_norm, cfg.norm_eps)
  return lm_logits(params.embedding, x, policy), state


def decode_step(params: TransformerLM, state: dict, token: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                policy=None) -> tuple[torch.Tensor, dict]:
  """token (b, 1), positions (b,) -> (logits (b, 1, v), state), the KV
  rows at `positions` written into `state` in place."""
  return _decode_stack(params, state, token, positions, cfg, policy,
                       attn_lib.attention_decode)


def decode_window(params: TransformerLM, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig,
                  policy=None) -> tuple[torch.Tensor, dict]:
  """Batched window decode: tokens (b, W) at positions `positions + t`
  -> (logits (b, W, v), state after the W tokens, written in place). One
  weight pass for the whole window: every GEMM takes b*W rows (under the
  "cuda" policy `decode_matvec` up to 16 rows) and the attention runs
  `attention_decode_window`; norms and the FFN are position-independent.
  Each row's logits equal W sequential `decode_step`s' to f32 summation
  order."""
  return _decode_stack(params, state, tokens, positions, cfg, policy,
                       attn_lib.attention_decode_window)
