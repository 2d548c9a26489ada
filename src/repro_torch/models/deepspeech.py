"""Deep Speech 2 acoustic model — the paper's baseline architecture.

Counterpart of `repro.models.deepspeech`: two strided 2D convs + ReLU,
growing forward-only GRUs (paper App. B.1), FC + ReLU, output GEMM and
log-softmax. Public tensors keep the reference's layouts — features
(b, t, f), conv weights HWIO — and the convs run as `F.conv2d` on
NCHW/OIHW views with explicit `F.pad`s, because the reference's time
padding (`conv_time_pads`) is asymmetric. `loss_fn` is the CTC
training loss; `api_decode_window` the batched window of the streaming
frame step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.factored import dense
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import assign
from repro_torch.kernels import dispatch
from repro_torch.layers.common import (Constraint, ModelConfig, gemm,
                                      identity_constraint)
from repro_torch.layers.gru import (GRU, gru_cell, gru_decode, gru_forward,
                                   init_gru)
from repro_torch.models.ctc import ctc_loss

CONV1_TIME_STRIDE = 2   # conv1 halves time; conv2's time stride is
                        # cfg.time_stride
CONV_FREQ_STRIDE = 2    # both convs halve frequency


class DeepSpeech2(nn.Module):
  """The DS2 parameters. Attribute paths match the reference's pytree
  (`conv1`, `conv2`, `grus.gru{i}.{nonrec,rec,bias}`, `fc`, `out`), so
  `state_dict()` keys are its checkpoint paths with "." for "/"."""

  def __init__(self, conv1: torch.Tensor, conv2: torch.Tensor,
               grus: dict[str, GRU], fc: nn.Module, out: nn.Module):
    super().__init__()
    self.conv1 = nn.Parameter(conv1, requires_grad=False)   # HWIO
    self.conv2 = nn.Parameter(conv2, requires_grad=False)   # HWIO
    self.grus = nn.ModuleDict(grus)
    self.fc = fc
    self.out = out

  def forward(self, feats: torch.Tensor, cfg: ModelConfig,
              policy=None) -> torch.Tensor:
    return forward(self, feats, cfg, policy)


def conv_out_len(t: int, k: int, stride: int) -> int:
  return (t + stride - 1) // stride  # ceil(t / stride), see conv_time_pads


def conv_time_pads(t: int, k: int, stride: int) -> tuple:
  """(pad_left, pad_right) of the streaming time-padding convention: a
  fixed left pad of (k - stride) // 2, and a right pad that completes
  exactly ceil(t / stride) output frames."""
  out = (t + stride - 1) // stride
  pad_l = (k - stride) // 2
  pad_r = (out - 1) * stride + k - t - pad_l
  return pad_l, max(pad_r, 0)


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None) -> DeepSpeech2:
  """Random DS2 weights drawn from `generator` (a CPU generator: the same
  seed gives the same weights on every device), placed on `device`
  (default: the GPU)."""
  device = resolve_device(device)
  ch = cfg.conv_channels

  def conv(shape):
    w = torch.randn(shape, generator=generator) * 0.05
    return w.to(device=device, dtype=cfg.dtype)

  # conv1: (time 11 x freq 41), stride (2, 2); conv2: (11 x 21), stride (t, 2)
  conv1 = conv((11, 41, 1, ch))
  conv2 = conv((11, 21, ch, ch))
  freq_after = ((cfg.feat_dim + 1) // 2 + 1) // 2
  grus, prev = {}, freq_after * ch
  for i, h in enumerate(cfg.gru_dims):
    grus[f"gru{i}"] = init_gru(prev, h, layer_prefix=f"gru{i}",
                               dtype=cfg.dtype, generator=generator,
                               device=device)
    prev = h
  kw = dict(group="nonrec", dtype=cfg.dtype, generator=generator,
            device=device)
  return DeepSpeech2(conv1, conv2, grus,
                     fc=dense(prev, cfg.fc_dim, name="fc", **kw),
                     out=dense(cfg.fc_dim, cfg.vocab_size, name="out", **kw))


def _freq_pads(f: int, k: int, stride: int) -> tuple:
  total = (conv_out_len(f, k, stride) - 1) * stride + k - f
  return total // 2, total - total // 2   # "SAME": centred (freq is static)


def conv_relu(x: torch.Tensor, w_hwio: torch.Tensor, stride: tuple,
              time_pads: tuple, freq_pads: tuple) -> torch.Tensor:
  """One frontend stage in the reference's layout: x (b, t, f, c_in),
  w (kt, kf, c_in, c_out) -> relu(conv) (b, t', f', c_out), computed in
  x.dtype with the ReLU in f32, as the reference does. On DTensors (a
  mesh) each rank convolves its own rows (`dist.sharding.rows_local`)."""
  from repro_torch.dist.sharding import rows_local
  return rows_local(_conv_relu, x, whole=(w_hwio,), stride=stride,
                    time_pads=time_pads, freq_pads=freq_pads)


def _conv_relu(x: torch.Tensor, w_hwio: torch.Tensor, *, stride: tuple,
               time_pads: tuple, freq_pads: tuple) -> torch.Tensor:
  y = F.pad(x.permute(0, 3, 1, 2), freq_pads + time_pads)
  y = F.conv2d(y, w_hwio.permute(3, 2, 0, 1), stride=stride)
  return torch.relu(y.float()).to(x.dtype).permute(0, 2, 3, 1)


def _frontend(params: DeepSpeech2, feats: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
  """feats (b, t, f) -> (b, t', gru_in). Time padding follows
  `conv_time_pads`, so the streamed frontend reproduces it exactly."""
  x = feats[..., None].to(cfg.dtype)                     # (b, t, f, 1)
  k1, f1 = params.conv1.shape[:2]
  x = conv_relu(x, params.conv1, (CONV1_TIME_STRIDE, CONV_FREQ_STRIDE),
                conv_time_pads(x.shape[1], k1, CONV1_TIME_STRIDE),
                _freq_pads(x.shape[2], f1, CONV_FREQ_STRIDE))
  k2, f2 = params.conv2.shape[:2]
  x = conv_relu(x, params.conv2, (cfg.time_stride, CONV_FREQ_STRIDE),
                conv_time_pads(x.shape[1], k2, cfg.time_stride),
                _freq_pads(x.shape[2], f2, CONV_FREQ_STRIDE))
  b, t, f, c = x.shape
  return x.reshape(b, t, f * c)


def _head(params: DeepSpeech2, h: torch.Tensor, policy) -> torch.Tensor:
  h = torch.relu(gemm(params.fc, h, policy).float()).to(h.dtype)
  logits = gemm(params.out, h, policy)
  return torch.log_softmax(logits.float(), dim=-1)


def forward(params: DeepSpeech2, feats: torch.Tensor, cfg: ModelConfig,
            policy=None, cs: Constraint = identity_constraint
            ) -> torch.Tensor:
  """feats (b, t, feat_dim) -> log_probs (b, t', vocab)."""
  x = _frontend(params, feats, cfg)
  for i in range(len(cfg.gru_dims)):
    x = gru_forward(params.grus[f"gru{i}"], x, policy, cs)
  return _head(params, x, policy)


def output_lengths(input_lengths: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
  s1 = CONV1_TIME_STRIDE
  t1 = (input_lengths + s1 - 1) // s1
  return (t1 + cfg.time_stride - 1) // cfg.time_stride


def loss_fn(params: DeepSpeech2, batch: dict, cfg: ModelConfig,
            cs: Constraint = identity_constraint
            ) -> tuple[torch.Tensor, dict]:
  """The CTC loss of a batch — feats (b, t, f), feat_lengths (b,),
  labels (b, l), label_lengths (b,), tensors or numpy arrays — through
  the full-utterance forward with no kernel policy (no kernel has a
  backward). Returns (loss, {"ctc": loss})."""
  dev = params.conv1.device
  feats, feat_lens, labels, label_lens = (
      torch.as_tensor(batch[k], device=dev) for k in
      ("feats", "feat_lengths", "labels", "label_lengths"))
  log_probs = forward(params, feats, cfg, cs=cs)
  loss = ctc_loss(log_probs, output_lengths(feat_lens, cfg), labels,
                  label_lens)
  return loss, {"ctc": loss}


# -- streaming inference (the paper's embedded deployment mode) --------------


def init_decode_state(cfg: ModelConfig, batch: int,
                      device=None) -> dict[str, torch.Tensor]:
  """Streaming GRU hidden states, zero, one per layer."""
  device = resolve_device(device)
  return {f"gru{i}": torch.zeros((batch, h), dtype=cfg.dtype, device=device)
          for i, h in enumerate(cfg.gru_dims)}


def _write_state(dst: torch.Tensor, h: torch.Tensor,
                 active: torch.Tensor = None) -> None:
  """Write a layer's new hidden state `h` into the state's own tensor
  `dst` (the torch form of the reference's donated state); where
  `active` (b,) is False, the row keeps its old value."""
  if active is not None:
    h = torch.where(active[:, None], h, dst)
  assign(dst, h)


def decode_step(params: DeepSpeech2, state: dict, x_t: torch.Tensor,
                cfg: ModelConfig, policy=None, active=None
                ) -> tuple[torch.Tensor, dict]:
  """One post-frontend frame x_t (b, gru_in) -> (log_probs (b, v),
  state). The paper's low-batch regime: a decode policy routes the GRU
  steps and the FC through the kernels. Each layer's new hidden state is
  written into `state`'s own tensor, in place, and `state` is returned;
  with `active` (b,) bool, rows where it is False keep their old hidden
  state (every layer still feeds the next its new one, as the fleet's
  masked step did)."""
  h = x_t
  for i in range(len(cfg.gru_dims)):
    key = f"gru{i}"
    h = gru_decode(params.grus[key], h, state[key], policy)
    _write_state(state[key], h, active)
  return _head(params, h, policy), state


def decode_state_batch_axes(cfg: ModelConfig) -> dict:
  """Batch axis of every decode-state leaf: the GRU hidden states carry
  batch leading."""
  return {f"gru{i}": 0 for i in range(len(cfg.gru_dims))}


def api_decode_step(params: DeepSpeech2, state: dict, feat: torch.Tensor,
                    positions: torch.Tensor, cfg: ModelConfig, policy=None
                    ) -> tuple[torch.Tensor, dict]:
  """The `ModelApi` form of the frame step: feat (b, 1, gru_in) ->
  (log-probs (b, 1, v), new state). `positions` is ignored: the state is
  purely recurrent."""
  del positions
  log_probs, new_state = decode_step(params, state, feat[:, 0], cfg, policy)
  return log_probs[:, None], new_state


def decode_state_carry(cfg: ModelConfig) -> dict:
  """Speculative-rewind contract: every GRU hidden state is a read-
  modify-write carry, so a rewind restores a pre-draft snapshot and
  replays the accepted prefix."""
  return {f"gru{i}": True for i in range(len(cfg.gru_dims))}


def api_decode_window(params: DeepSpeech2, state: dict, feat: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, policy=None
                      ) -> tuple[torch.Tensor, dict]:
  """Batched window of frame steps: feat (b, W, gru_in) -> (log-probs
  (b, W, v), state after the W frames). Per layer the non-recurrent
  W_{z,r,h} GEMM takes the whole window as b*W rows in one weight pass
  (paper §4's Wx batching); only the recurrence (`gru_cell`) steps over
  the window, seeded from the streaming carry, and the FC and output
  GEMMs take the window's rows together. Each layer's carry after the
  window is written into `state`'s own tensor, in place, and `state` is
  returned. `positions` is ignored, as in the frame step."""
  del positions
  h = feat
  for i, hidden in enumerate(cfg.gru_dims):
    p = params.grus[f"gru{i}"]
    xw = gemm(p.nonrec, h, policy)                      # (b, W, 3H)
    hc, hs = state[f"gru{i}"], []
    with dispatch.scanned():            # the reference's recurrence scan
      for t in range(feat.shape[1]):
        hc = gru_cell(xw[:, t], hc, p.rec, p.bias, hidden, policy)
        hs.append(hc)
    h = torch.stack(hs, dim=1)
    _write_state(state[f"gru{i}"], hc)
  return _head(params, h, policy), state
