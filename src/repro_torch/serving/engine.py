"""Streaming DS2 speech serving — the speech half of `repro.serving.engine`.

`StreamingSpeechServer` keeps the reference's two surfaces (a
continuous-batching fleet, and the lockstep chunk API) over one masked
frame step. PyTorch runs eagerly, so there is nothing to compile: the
reference's `compile_stats()` and its pow2 conv-window buckets exist for
`jax.jit` and have no counterpart here. Conv windows run at their exact
length (a VALID-in-time conv is local, so the outputs are the same).
Stream buffers stay on the server's device.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import resolve_policy
from repro_torch.layers.common import ModelConfig
from repro_torch.models import deepspeech


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
  """XLA/TF SAME padding split for a fixed, fully visible axis length."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


class _ConvStream:
  """One strided-conv stage streamed over time.

  Implements the `deepspeech.conv_time_pads` convention: a fixed left
  pad of (k - s) // 2 zeros is materialized once at stream start, pushed
  frames are buffered (time on axis 1), and output frame j is emitted as
  soon as its receptive field [j*s - pl, j*s - pl + k) is complete.
  `flush` right-pads exactly the zeros that complete ceil(n_in / s)
  output frames, so chunked emission equals the full-utterance conv for
  any length.
  """

  def __init__(self, kernel: int, stride: int, apply_fn):
    self.k, self.s = kernel, stride
    self.pad_l = (kernel - stride) // 2
    self.apply = apply_fn        # (b, t, ...) -> outputs, VALID in time
    self.buf: Optional[torch.Tensor] = None
    self.n_in = 0                # frames received, padding excluded
    self.n_out = 0               # frames emitted so far
    self.flushed = False

  def _zeros(self, like: torch.Tensor, t: int) -> torch.Tensor:
    return like.new_zeros((like.shape[0], t) + tuple(like.shape[2:]))

  def _emit(self) -> Optional[torch.Tensor]:
    n = self.buf.shape[1]
    m = (n - self.k) // self.s + 1 if n >= self.k else 0
    if m <= 0:
      return None
    window = self.buf[:, :(m - 1) * self.s + self.k]
    self.buf = self.buf[:, m * self.s:]
    self.n_out += m
    return self.apply(window)

  def push(self, x: torch.Tensor) -> Optional[torch.Tensor]:
    if self.flushed:
      raise RuntimeError("conv stream already flushed; reset() first")
    if x.shape[1] == 0:
      return None
    if self.buf is None:
      self.buf = torch.cat([self._zeros(x, self.pad_l), x], dim=1)
    else:
      self.buf = torch.cat([self.buf, x.to(self.buf.dtype)], dim=1)
    self.n_in += x.shape[1]
    return self._emit()

  def flush(self) -> Optional[torch.Tensor]:
    # idempotent: re-flushing must not re-pad the residual buffer
    if self.buf is None or self.flushed:
      self.flushed = True
      return None
    self.flushed = True
    out_total = -(-self.n_in // self.s)
    pad_r = (out_total - 1) * self.s + self.k - self.pad_l - self.n_in
    if pad_r > 0:
      self.buf = torch.cat([self.buf, self._zeros(self.buf, pad_r)], dim=1)
    return self._emit()

  def reset(self) -> None:
    self.buf = None
    self.n_in = 0
    self.n_out = 0
    self.flushed = False


@dataclasses.dataclass
class SpeechResult:
  """One retired utterance from the speech fleet."""
  uid: int
  labels: list                  # collapsed greedy-CTC label sequence
  frames: int                   # raw mel frames consumed


class _SpeechSlot:
  """Host-side record of one speech stream: its conv streams (`s1`,
  `s2`), its own CTC collapse state (`prev`, reset on admit), the
  post-frontend frames awaiting a decode step (`pending`), and the labels
  emitted so far."""

  __slots__ = ("uid", "feats", "fed", "labels", "prev", "s1", "s2",
               "pending", "flushed")

  def __init__(self, uid, feats, s1, s2):
    self.uid = uid
    self.feats = feats            # (t, feat_dim) on the device, or None
    self.fed = 0                  # raw frames pushed into s1 so far
    self.labels: list = []
    self.prev = -1
    self.s1, self.s2 = s1, s2
    self.pending = collections.deque()   # (gru_in,) frames to decode
    self.flushed = False          # frontend drained (right edge padded)

  @property
  def done(self) -> bool:
    return self.flushed and not self.pending


class StreamingSpeechServer:
  """Continuous-batching frame-synchronous DS2 fleet (paper §4 regime).

  * **Fleet** (`submit` + `run`): admit / chunk / retire over
    `batch_size` slots. Each utterance owns a `_SpeechSlot` with its own
    pair of `_ConvStream`s and its own CTC collapse state. Every decode
    step is one masked `frame_step` over all slots; slots without a frame
    keep their state through the mask. Admission zeroes the slot's GRU
    rows in place (a plain row write).
  * **Lockstep** (`process_chunk` / `flush`): all `batch_size` streams
    advance through the same chunk boundaries.

  `params` (a `DeepSpeech2`) is moved to `device` in place (default: the
  GPU). `kernel_policy` "cuda" routes the frame step through the CUDA
  kernels; "plain" (or None) runs plain PyTorch.
  """

  def __init__(self, model_cfg: ModelConfig, params: deepspeech.DeepSpeech2,
               *, batch_size: int = 1, kernel_policy=None, device=None):
    self.device = resolve_device(device)
    self.cfg = cfg = model_cfg
    self.params = params.to(self.device)
    self.batch = batch_size
    self.kernel_policy = resolve_policy(kernel_policy, batch_size)
    self.state = deepspeech.init_decode_state(cfg, batch_size, self.device)

    # geometry from the conv weights (HWIO) and the shared strides
    k1t, k1f = self.params.conv1.shape[:2]
    k2t, k2f = self.params.conv2.shape[:2]
    sf = deepspeech.CONV_FREQ_STRIDE
    self._geom = (k1t, deepspeech.CONV1_TIME_STRIDE, k2t, cfg.time_stride)
    self._freq_pads = (_same_pad(cfg.feat_dim, k1f, sf),
                       _same_pad(-(-cfg.feat_dim // sf), k2f, sf))
    freq_after = ((cfg.feat_dim + 1) // 2 + 1) // 2
    self._gru_in = freq_after * cfg.conv_channels

    self._slots: list = [None] * batch_size
    self._queue: collections.deque = collections.deque()
    self._next_uid = 0
    self._mode: Optional[str] = None     # None | "lockstep" | "fleet"
    self._finished = False               # lockstep: utterance finalized
    self.decode_steps = 0                # masked frame_step invocations
    self.busy_steps = 0                  # live (slot, frame) pairs stepped

  # -- shared machinery -----------------------------------------------------

  def _conv1(self, x: torch.Tensor) -> torch.Tensor:
    """Raw mel window (b, t, f) -> (b, t', f', ch), VALID in time."""
    return deepspeech.conv_relu(
        x[..., None].to(self.cfg.dtype), self.params.conv1,
        (self._geom[1], deepspeech.CONV_FREQ_STRIDE), (0, 0),
        self._freq_pads[0])

  def _conv2(self, x: torch.Tensor) -> torch.Tensor:
    """(b, t, f', ch) window -> (b, t'', gru_in), VALID in time."""
    y = deepspeech.conv_relu(
        x, self.params.conv2, (self._geom[3], deepspeech.CONV_FREQ_STRIDE),
        (0, 0), self._freq_pads[1])
    b, t, f, c = y.shape
    return y.reshape(b, t, f * c)

  def _make_streams(self):
    return (_ConvStream(self._geom[0], self._geom[1], self._conv1),
            _ConvStream(self._geom[2], self._geom[3], self._conv2))

  def _feed_slot(self, slot: _SpeechSlot, feats: Optional[torch.Tensor], *,
                 final: bool) -> None:
    """Push raw mel frames (1, t, f) through the slot's conv streams;
    queue every completed post-frontend frame for decoding."""
    outs = []
    if feats is not None and feats.shape[1]:
      y1 = slot.s1.push(feats)
      if y1 is not None and y1.shape[1]:
        outs.append(slot.s2.push(y1))
    if final and not slot.flushed:
      y1 = slot.s1.flush()
      if y1 is not None and y1.shape[1]:
        outs.append(slot.s2.push(y1))
      outs.append(slot.s2.flush())
      slot.flushed = True
    for o in outs:
      if o is not None and o.shape[1]:
        slot.pending.extend(o[0].unbind(0))

  def _frame_step(self, x: torch.Tensor, active: torch.Tensor
                  ) -> torch.Tensor:
    """One masked decode step over all slots: rows where `active` is
    False keep their GRU state. Returns log-probs (batch, vocab)."""
    log_probs, new = deepspeech.decode_step(self.params, self.state, x,
                                            self.cfg, self.kernel_policy)
    mask = active[:, None]
    self.state = {k: torch.where(mask, new[k], old)
                  for k, old in self.state.items()}
    return log_probs

  def _decode_pending(self) -> list:
    """Masked frame steps until no live slot has a pending frame; greedy
    CTC collapse per live slot against its own `prev`. Returns per-slot
    newly emitted labels (lockstep API)."""
    emitted = [[] for _ in range(self.batch)]
    while True:
      live = [i for i, s in enumerate(self._slots)
              if s is not None and s.pending]
      if not live:
        return emitted
      x = torch.zeros((self.batch, self._gru_in), dtype=self.cfg.dtype,
                      device=self.device)
      x[live] = torch.stack([self._slots[i].pending.popleft() for i in live])
      mask = torch.zeros((self.batch,), dtype=torch.bool)
      mask[live] = True
      log_probs = self._frame_step(x, mask.to(self.device))
      best = log_probs.argmax(dim=-1).cpu().tolist()
      for i in live:
        slot, b = self._slots[i], best[i]
        if b != 0 and b != slot.prev:
          slot.labels.append(b)
          emitted[i].append(b)
        slot.prev = b
      self.decode_steps += 1
      self.busy_steps += len(live)

  # -- fleet lifecycle ------------------------------------------------------

  def submit(self, feats) -> int:
    """Queue one utterance (t, feat_dim) of any length; returns its uid."""
    if self._mode == "lockstep":
      raise RuntimeError("server is mid-lockstep-utterance; reset() first")
    feats = torch.as_tensor(np.asarray(feats, dtype=np.float32))
    if feats.ndim != 2 or feats.shape[-1] != self.cfg.feat_dim:
      raise ValueError(f"expected (t, {self.cfg.feat_dim}) mel features, "
                       f"got {tuple(feats.shape)}")
    self._mode = "fleet"
    uid = self._next_uid
    self._next_uid += 1
    self._queue.append((uid, feats.to(self.device)))
    return uid

  def _admit(self) -> None:
    for i in range(self.batch):
      if self._slots[i] is None and self._queue:
        uid, feats = self._queue.popleft()
        self._slots[i] = _SpeechSlot(uid, feats, *self._make_streams())
        # a reused slot must not inherit the previous utterance's state
        for h in self.state.values():
          h[i].zero_()

  def run(self, chunk_frames: int = 16) -> list:
    """Drain the submitted queue; returns `SpeechResult`s in retire
    order. Each iteration admits into free slots, feeds every live slot
    its next `chunk_frames` raw frames, masked-steps all pending frames,
    and retires finished slots so the queue refills them."""
    if self._mode == "lockstep":
      raise RuntimeError("server is mid-lockstep-utterance; reset() first")
    results = []
    while self._queue or any(s is not None for s in self._slots):
      self._admit()
      for slot in self._slots:
        if slot is None or slot.flushed:
          continue
        end = min(slot.fed + chunk_frames, slot.feats.shape[0])
        chunk = slot.feats[None, slot.fed:end]
        slot.fed = end
        self._feed_slot(slot, chunk, final=end == slot.feats.shape[0])
      self._decode_pending()
      for i, slot in enumerate(self._slots):
        if slot is not None and slot.done:
          results.append(SpeechResult(uid=slot.uid, labels=slot.labels,
                                      frames=int(slot.feats.shape[0])))
          self._slots[i] = None
    self._mode = None
    return results

  @property
  def occupancy(self) -> float:
    """Live (slot, frame) pairs per decode step, over batch capacity."""
    total = self.decode_steps * self.batch
    return self.busy_steps / total if total else 0.0

  # -- lockstep API ---------------------------------------------------------

  def reset(self) -> None:
    self.state = deepspeech.init_decode_state(self.cfg, self.batch,
                                              self.device)
    self._slots = [None] * self.batch
    self._queue.clear()
    self._mode = None
    self._finished = False

  def _lockstep_slots(self) -> list:
    if self._mode == "fleet":
      raise RuntimeError("server is mid-fleet-run; reset() first")
    self._mode = "lockstep"
    if all(s is None for s in self._slots):
      for i in range(self.batch):
        self._slots[i] = _SpeechSlot(None, None, *self._make_streams())
    return self._slots

  def process_chunk(self, feats, *, final: bool = False) -> list:
    """feats (b, t, feat_dim) raw mel chunk -> newly emitted labels per
    stream. Pass final=True (or call flush()) after the last chunk; new
    frames after it require reset()."""
    feats = torch.as_tensor(np.asarray(feats, dtype=np.float32))
    if self._finished:
      if feats.shape[1]:
        raise RuntimeError("utterance already finalized; reset() first")
      return [[] for _ in range(self.batch)]
    slots = self._lockstep_slots()
    feats = feats.to(self.device)
    for i, slot in enumerate(slots):
      self._feed_slot(slot, feats[i:i + 1] if feats.shape[1] else None,
                      final=final)
    if final:
      self._finished = True
    return self._decode_pending()

  def flush(self) -> list:
    """Drain the right-edge conv context at end of utterance."""
    return self.process_chunk(
        np.zeros((self.batch, 0, self.cfg.feat_dim), np.float32),
        final=True)
