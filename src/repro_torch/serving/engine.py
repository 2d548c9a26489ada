"""Serving: the continuous-batching LM engine and the streaming DS2
speech server — counterpart of `repro.serving.engine`.

`LMEngine` — continuous batching over a persistent KV cache, vanilla or
self-speculative. The engine owns `batch_size` slots, each with its own
request lifecycle

    admit -> prefill -> decode -> retire (EOS / token budget / max_len)

and a host-side request queue. Admission prefills the prompt into a
fresh batch-1 state, one `decode_step` per prompt token, and splices it
into its slot (`ModelApi.insert_slot`). Decoding is one masked step for
the whole batch: retired slots keep stepping at position 0 with token 0
(their rows are overwritten at the next admit). `max_len` is a hard
boundary: `submit` rejects prompts that do not fit, and a slot whose
cache is full retires with reason "max_len".

With `speculate=k` each iteration drafts k tokens a slot with the
paper's truncated-SVD copy of the weights (`serving.speculative`),
verifies them in one (b x (k+1))-row `decode_window` of the target and
commits the accepted prefix plus one token, through the same retirement
rules. A family whose decode state has carry leaves (zamba's SSM states)
takes the reference's carry branch: the draft's and the target's carries
are cloned before the draft and the window, and a rejected suffix is
undone by `merge_rewind` and a masked replay of the accepted prefix
(every slot's carries kept past its own accepted length); when every
live slot accepts its whole window, the target's carries stand and the
draft catches up with one step. The prefix cache and meshes come with
later slices and raise if asked for; `compile_stats` has no counterpart
(nothing is compiled).

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
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import resolve_policy
from repro_torch.layers.common import ModelConfig
from repro_torch.models import deepspeech
from repro_torch.models.api import cast_kv_cache, get_model
from repro_torch.serving.speculative import (RankController,
                                             accept_longest_prefix,
                                             accept_sampled,
                                             make_draft_params, merge_rewind)

_INHERIT = object()   # submit(eos_id=...) sentinel: use the engine's eos_id


@dataclasses.dataclass
class GenerationResult:
  tokens: np.ndarray            # (b, steps); rows past their length are 0
  steps: int
  lengths: Optional[np.ndarray] = None   # (b,) generated tokens per row
  accept_rate: Optional[float] = None    # speculative: accepted / drafted


@dataclasses.dataclass
class Request:
  uid: int
  prompt: np.ndarray            # (p,) int32
  max_new_tokens: Optional[int]  # None = until EOS or max_len
  eos_id: Optional[int]


@dataclasses.dataclass
class FinishedRequest:
  uid: int
  prompt: np.ndarray
  tokens: np.ndarray            # generated tokens, prompt excluded
  finish_reason: str            # "eos" | "length" | "max_len"
  # admission-to-first-token wall seconds (prefill latency; queue wait
  # excluded)
  ttft_s: Optional[float] = None


@dataclasses.dataclass
class _SlotState:
  """Host-side record of one decode slot: request lifecycle, emitted
  tokens, and the next token to feed (inactive slots hold a blank one)."""
  req: Optional[Request] = None
  tokens: list = dataclasses.field(default_factory=list)
  remaining: Optional[int] = None
  active: bool = False
  next_tok: int = 0
  ttft_s: Optional[float] = None


#: LMEngine options of the reference that later slices port
_LATER = {"prefix_cache": "the prefix cache",
          "publish_on_retire": "the prefix cache", "mesh": "distribution"}


def _host_probs(logits: torch.Tensor, temperature: float) -> np.ndarray:
  """softmax(logits / temperature) on the host in float64: the
  acceptance-side view of the distribution `_draw` samples from."""
  x = logits.float().cpu().numpy().astype(np.float64) / temperature
  x -= x.max(axis=-1, keepdims=True)
  np.exp(x, out=x)
  x /= x.sum(axis=-1, keepdims=True)
  return x


class LMEngine:
  """Continuous-batching LM decode engine, vanilla or self-speculative.

  `params` is moved to `device` (default: the GPU). `kernel_policy`
  "cuda" routes every decode-regime GEMM through the CUDA kernels;
  "plain" (or None) runs plain PyTorch. Sampling at temperature > 0
  draws from `rng`, a `torch.Generator` on the engine's device (other
  bits than the reference's `jax.random`); greedy is `torch.argmax`,
  which takes the first maximum as `jnp.argmax` does.

  `speculate=k` drafts k tokens an iteration with `draft_params`
  (default: `make_draft_params(params, rank=draft_rank)`, which shares
  every unfactored tensor with `params`) and verifies them in one
  window; the policy's `decode_matvec` bound widens to b * (k+1) rows
  (at most 16). `rank_controller` walks `draft_rank` against an
  accept-rate band, rebuilding the draft."""

  def __init__(self, model_cfg: ModelConfig, params: Any, *,
               batch_size: int, max_len: int, cache_dtype=None,
               rng: Optional[torch.Generator] = None, kernel_policy=None,
               eos_id: Optional[int] = None, speculate: int = 0,
               draft_params: Any = None, draft_rank: Optional[int] = None,
               rank_controller: Optional[RankController] = None,
               device=None, **later):
    for key, val in later.items():
      if key not in _LATER:
        raise TypeError(f"LMEngine got an unexpected argument {key!r}")
      if val:
        raise NotImplementedError(
            f"LMEngine({key}=...) is not ported yet; it comes with "
            f"{_LATER[key]}")
    self.device = resolve_device(device)
    self.cfg = model_cfg
    self.params = params.to(self.device)
    self.api = get_model(model_cfg)
    if not self.api.decodable:
      raise ValueError(f"{model_cfg.name} has no decode path")
    self.batch = batch_size
    self.max_len = max_len
    self.cache_dtype = cache_dtype
    self.eos_id = eos_id
    if speculate < 0:
      raise ValueError(f"speculate must be >= 0, got {speculate}")
    self.speculate = int(speculate)
    self.kernel_policy = resolve_policy(kernel_policy, batch_size,
                                        window=self.speculate + 1)
    # per-family rewind: carry leaves are snapshot and replayed, the rest
    # (attention KV) rewind with the position counter
    self._axes = self.api.decode_state_batch_axes(model_cfg)
    self._carry = self.api.decode_state_carry(model_cfg)
    self._has_carry = _any_leaf(self._carry)
    if rng is None:
      rng = torch.Generator(device=self.device).manual_seed(0)
    self.rng = rng
    self._rng0 = rng.get_state()
    self.state = self._init_state(batch_size)
    self.positions = np.zeros((batch_size,), np.int64)   # host-side
    if rank_controller is not None:
      if not self.speculate:
        raise ValueError("rank_controller requires speculate > 0")
      if draft_rank is None:
        raise ValueError(
            "rank_controller needs a starting draft_rank to walk from "
            "(the explained-variance draft has no single rank)")
    # the self-speculative draft: the same model, matched GEMMs factored
    # at the draft rank, decoding against its own state
    self.draft_params = self.draft_state = None
    if self.speculate:
      if draft_params is None:
        draft_params = make_draft_params(self.params, rank=draft_rank)
      self.draft_params = draft_params.to(self.device)
      self.draft_state = self._init_state(batch_size)
    self.rank_controller = rank_controller
    self.draft_rank = draft_rank
    self.rank_history: list = []   # (decode_steps, old_rank, new_rank)
    self._queue: collections.deque = collections.deque()
    self._slots: list = [_SlotState() for _ in range(batch_size)]
    self._finished: dict = {}
    self._next_uid = 0
    self._reset_counters()

  def _reset_counters(self) -> None:
    # occupancy accounting: busy slot-steps / slot-steps
    self.decode_steps = 0
    self.busy_slot_steps = 0
    # speculative accounting: accept_rate = accepted / drafted
    self.drafted_tokens = 0
    self.accepted_tokens = 0
    self._ctrl_step0 = self._ctrl_drafted0 = self._ctrl_accepted0 = 0

  def _init_state(self, batch: int) -> dict:
    state = self.api.init_decode_state(self.cfg, batch, self.max_len,
                                       device=self.device)
    # KV-cache leaves only: recurrent carries keep their precision
    return cast_kv_cache(state, self.cache_dtype)

  def _step(self, state: dict, tokens: torch.Tensor,
            positions: torch.Tensor):
    return self.api.decode_step(self.params, state, tokens, positions,
                                self.cfg, self.kernel_policy)

  def _draft_step(self, state: dict, tokens: torch.Tensor,
                  positions: torch.Tensor):
    return self.api.decode_step(self.draft_params, state, tokens, positions,
                                self.cfg, self.kernel_policy)

  def _window(self, state: dict, tokens: torch.Tensor,
              positions: torch.Tensor):
    return self.api.decode_window(self.params, state, tokens, positions,
                                  self.cfg, self.kernel_policy)

  def reset(self) -> None:
    self.state = self._init_state(self.batch)
    if self.speculate:
      self.draft_state = self._init_state(self.batch)
    self.positions = np.zeros((self.batch,), np.int64)
    self.rng.set_state(self._rng0)   # seeded sampling restarts with reset
    self._queue.clear()
    self._slots = [_SlotState() for _ in range(self.batch)]
    self._finished = {}
    self._reset_counters()

  # -- request lifecycle ----------------------------------------------------

  def _active_mask(self) -> np.ndarray:
    return np.array([s.active for s in self._slots], bool)

  def _next_tokens(self) -> np.ndarray:
    return np.array([[s.next_tok] for s in self._slots], np.int64)

  @property
  def num_active(self) -> int:
    return sum(s.active for s in self._slots)

  @property
  def accept_rate(self) -> Optional[float]:
    """Accepted draft tokens / drafted tokens since init or reset(), or
    None when nothing has been drafted yet ("no data", not "every draft
    rejected")."""
    return (self.accepted_tokens / self.drafted_tokens
            if self.drafted_tokens else None)

  @property
  def occupancy(self) -> float:
    """Mean fraction of slots doing useful work per engine iteration
    (one masked step, or one speculative draft + verify + commit round),
    since init or reset(); admission prefill is excluded. 0.0 before any
    decoding."""
    total = self.decode_steps * self.batch
    return self.busy_slot_steps / total if total else 0.0

  def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
             eos_id=_INHERIT) -> int:
    """Queue one request; returns its uid. `eos_id=None` disables EOS
    retirement for this request (the engine default applies otherwise)."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if prompt.size == 0:
      raise ValueError("empty prompt")
    if prompt.size > self.max_len:
      raise ValueError(
          f"prompt length {prompt.size} exceeds max_len {self.max_len}")
    if max_new_tokens is not None and max_new_tokens < 1:
      raise ValueError("max_new_tokens must be >= 1")
    uid = self._next_uid
    self._next_uid += 1
    eos = self.eos_id if eos_id is _INHERIT else eos_id
    self._queue.append(Request(uid=uid, prompt=prompt,
                               max_new_tokens=max_new_tokens, eos_id=eos))
    return uid

  def _retire(self, slot: int, reason: str) -> None:
    s = self._slots[slot]
    self._finished[s.req.uid] = FinishedRequest(
        uid=s.req.uid, prompt=s.req.prompt,
        tokens=np.asarray(s.tokens, np.int32), finish_reason=reason,
        ttft_s=s.ttft_s)
    # no state scrub: the slot keeps stepping masked (position 0) and the
    # next admit writes a whole fresh prefilled state over its rows
    self._slots[slot] = _SlotState()

  def _record_token(self, slot: int, tok: int, pos: int) -> bool:
    """Append a sampled token; retire the slot if the request is done.
    `pos` is the slot's cache write count. Returns True while the slot
    stays active."""
    s = self._slots[slot]
    s.tokens.append(tok)
    if s.remaining is not None:
      s.remaining -= 1
    if s.req.eos_id is not None and tok == s.req.eos_id:
      self._retire(slot, "eos")
      return False
    if s.remaining == 0:
      self._retire(slot, "length")
      return False
    if pos >= self.max_len:
      # cache full: one more step would write past max_len — retire
      self._retire(slot, "max_len")
      return False
    return True

  def _prefill_slot(self, prompt: np.ndarray, step=None
                    ) -> tuple[torch.Tensor, dict]:
    """Feed `prompt` into a fresh batch-1 state, one decode step per
    token (`step`: the target's, or the draft's); returns (last logits
    (1, 1, v) f32, state). The reference pads the prompt to a pow2 bucket
    (one jit program per bucket) and masks the steps past its length
    back to the old state; eager PyTorch feeds exactly the prompt's
    tokens, which leaves the same state."""
    step = step or self._step
    state = self._init_state(1)
    toks = torch.as_tensor(prompt, dtype=torch.int64,
                           device=self.device).view(1, -1)
    pos = torch.arange(prompt.size, device=self.device)
    logits = None
    for t in range(prompt.size):
      logits, state = step(state, toks[:, t:t + 1], pos[t:t + 1])
    return logits.to(torch.float32), state

  def _admit(self, req: Request, slot: int, temperature: float) -> None:
    """Prefill `req` into a fresh batch-1 state, splice it into `slot`,
    and sample its first token from the prefill's last logits."""
    t_admit = time.perf_counter()
    plen = req.prompt.size
    last, slot_state = self._prefill_slot(req.prompt)
    self.state = self.api.insert_slot(self.cfg, self.state, slot_state, slot)
    self.positions[slot] = plen
    self._slots[slot] = _SlotState(req=req, remaining=req.max_new_tokens,
                                   active=True)
    # the first token comes from the target's prefill, as in vanilla
    # admission: the draft only ever proposes
    tok = int(self._sample(last, temperature)[0, 0])
    self._slots[slot].ttft_s = time.perf_counter() - t_admit
    if self._record_token(slot, tok, plen):
      self._slots[slot].next_tok = tok
      if self.speculate:
        # only a slot that survives admission drafts: the draft consumes
        # the prompt into its own state
        _, draft_slot = self._prefill_slot(req.prompt, self._draft_step)
        self.api.insert_slot(self.cfg, self.draft_state, draft_slot, slot)

  def _admit_from_queue(self, temperature: float) -> None:
    slot = 0
    while self._queue and slot < self.batch:
      if self._slots[slot].active:
        slot += 1
        continue
      # a request may finish during admission (EOS in the prefill logits,
      # budget 1, or a full cache) — then the slot is still free
      self._admit(self._queue.popleft(), slot, temperature)

  def _decode_all(self, temperature: float) -> None:
    """One masked decode step for every slot. Inactive slots step at
    position 0 with token 0; their rows are garbage until the next admit
    overwrites them."""
    active = self._active_mask()
    safe_pos = np.where(active, self.positions, 0)
    logits, self.state = self._step(
        self.state, torch.as_tensor(self._next_tokens(), device=self.device),
        torch.as_tensor(safe_pos, device=self.device))
    self.positions = np.where(active, self.positions + 1, self.positions)
    self.decode_steps += 1
    self.busy_slot_steps += int(active.sum())
    toks = self._sample(logits, temperature)        # one host sync per step
    for i in range(self.batch):
      if self._slots[i].active and self._record_token(
          i, int(toks[i, 0]), int(self.positions[i])):
        self._slots[i].next_tok = int(toks[i, 0])

  def _decode_all_speculative(self, temperature: float) -> None:
    """One speculative iteration for every slot: draft k, verify k+1 in
    one window, commit the accepted prefix + one token. Temperature 0
    accepts greedily (token for token vanilla greedy); temperature > 0
    rejection-samples against the draft distribution (`accept_sampled`).

    Window layout per slot: inputs [t0, d_1..d_k] fed at positions
    p..p+k (t0 = the committed-but-unfed token) give target distributions
    p_1..p_{k+1}; after accepting `a` drafts the slot commits d_1..d_a
    plus one more token and its position moves to p+a+1. KV rows past
    the new position are dead until overwritten (the causal mask never
    reads them), so the rejected suffix rewinds with the position alone.
    Rows at or past max_len are dropped by the attention layer, and the
    commit loop retires the slot at the boundary first.

    Carry families (`decode_state_carry`) clone their carries before the
    draft and before the window; a surviving slot that rejected part of
    its window has both states' carries restored (`merge_rewind`) and the
    accepted prefix replayed, masked per slot (`_replay`). If every
    surviving slot accepted its whole window, the target's carries stand
    and the draft takes the one step that consumes d_k."""
    k = self.speculate
    sampled = temperature > 0.0
    active = self._active_mask()
    pos_np = self.positions.copy()
    pos0 = torch.as_tensor(np.where(active, self.positions, 0),
                           device=self.device)

    # draft: k proposals against the draft's own state
    if self._has_carry:
      draft_snap = self._snapshot(self.draft_state)
    cur = torch.as_tensor(self._next_tokens(), device=self.device)
    cols, draft_lgs = [cur], []
    for j in range(k):
      lg, self.draft_state = self._draft_step(self.draft_state, cur,
                                              pos0 + j)
      cur = self._draw(lg, temperature)
      cols.append(cur)
      if sampled:
        draft_lgs.append(lg[:, -1:])
    if not self._has_carry:
      # one more draft step consumes d_k, so a fully accepted window
      # leaves the draft's cache complete through p+k (carry families do
      # it, or the replay, after the commit)
      _, self.draft_state = self._draft_step(self.draft_state, cur,
                                             pos0 + k)
    window = torch.cat(cols, dim=1)                       # (b, k+1)

    # verify: all k+1 positions in one window of the target
    if self._has_carry:
      snap = self._snapshot(self.state)
    logits_w, self.state = self._window(self.state, window, pos0)
    window_np = window.cpu().numpy()
    if sampled:
      q = _host_probs(torch.cat(draft_lgs, dim=1), temperature)
      p = _host_probs(logits_w, temperature)
      if not active.all():
        # idle slots step garbage rows; their (discarded) acceptance
        # math must still see finite probabilities
        q[~active] = 1.0 / q.shape[-1]
        p[~active] = 1.0 / p.shape[-1]
      accept, out_toks, out_len = accept_sampled(window_np[:, 1:], q, p,
                                                 self._host_rng())
    else:
      target = torch.argmax(logits_w, dim=-1).cpu().numpy()
      accept, out_toks, out_len = accept_longest_prefix(window_np[:, 1:],
                                                        target)
    self.decode_steps += 1
    self.busy_slot_steps += int(active.sum())

    # commit: accepted prefix + one token, by the vanilla retirement rules
    commit = np.ones((self.batch,), np.int64)   # window tokens consumed
    for i in range(self.batch):
      s = self._slots[i]
      if not s.active:
        continue
      self.drafted_tokens += k
      alive = True
      for j in range(int(out_len[i])):
        commit[i] = j + 1
        alive = self._record_token(i, int(out_toks[i, j]),
                                   int(pos_np[i]) + j + 1)
        if not alive:
          break                      # EOS / budget / max_len mid-window
      if alive:
        s.next_tok = int(out_toks[i, int(out_len[i]) - 1])
      # realized acceptance only: drafts a mid-window retirement never
      # emitted do not count
      self.accepted_tokens += min(int(accept[i]), int(commit[i]))
    self.positions = np.where(active, self.positions + commit,
                              self.positions)
    if self._has_carry:
      # retired slots take garbage (their next admit writes a whole
      # fresh state), so only the surviving slots decide the rewind
      live = [i for i in range(self.batch) if self._slots[i].active]
      if any(commit[i] != k + 1 for i in live):
        self.state = self._replay(
            self._step, merge_rewind(self.state, snap, self._carry),
            window, commit, pos0)
        self.draft_state = self._replay(
            self._draft_step,
            merge_rewind(self.draft_state, draft_snap, self._carry),
            window, commit, pos0)
      elif live:
        # every surviving slot took its whole window: the target's
        # carries are the committed ones, and the draft (which never fed
        # d_k) catches up with one step
        _, self.draft_state = self._draft_step(self.draft_state, cur,
                                               pos0 + k)
    self._maybe_adapt_rank()

  def _snapshot(self, state: dict) -> dict:
    """Clones of `state`'s carry leaves (None for the others): the
    decode steps write in place, so a rewind needs copies."""
    return _map_carry(lambda x: x.clone(), state, self._carry)

  def _replay(self, step, state: dict, window: torch.Tensor,
              commit: np.ndarray, pos0: torch.Tensor) -> dict:
    """Feed window[:, t] at pos0 + t for t < commit[i] into slot i (the
    reference's masked prefill program): all slots step together, and
    where t >= commit[i] slot i's carries are put back to their values
    before the step. KV rows written there lie past the slot's new
    position, where the causal mask never reads them."""
    for t in range(int(commit.max())):
      live = commit > t
      old = None if live.all() else self._snapshot(state)
      _, state = step(state, window[:, t:t + 1], pos0 + t)
      if old is not None:
        keep = torch.as_tensor(live, device=self.device)
        _keep_rows(state, old, keep, self._carry, self._axes)
    return state

  def _host_rng(self) -> np.random.Generator:
    """One host RNG per sampled acceptance round, seeded from the
    engine's generator: `reset()` and `run(rng=...)` reproduce the
    rejection draws as they reproduce the sampled tokens."""
    seed = torch.randint(0, np.iinfo(np.int32).max, (2,), generator=self.rng,
                         device=self.rng.device)
    return np.random.default_rng(seed.tolist())

  def _maybe_adapt_rank(self) -> None:
    """Rank-controller tick: every `interval` iterations, measure the
    window's accept rate and apply the controller's proposal by
    rebuilding the draft at the new rank. The draft's decode state
    carries over (factoring weights never changes state shapes): stale
    draft caches cost accept rate for a few iterations, never
    correctness (the target verifies everything)."""
    rc = self.rank_controller
    if rc is None or self.decode_steps - self._ctrl_step0 < rc.interval:
      return
    d = self.drafted_tokens - self._ctrl_drafted0
    a = self.accepted_tokens - self._ctrl_accepted0
    new = rc.propose(self.draft_rank, a / d if d else None)
    if new != self.draft_rank:
      self.rank_history.append((self.decode_steps, self.draft_rank, new))
      self.draft_rank = new
      self.draft_params = make_draft_params(self.params, rank=new)
    self._ctrl_step0 = self.decode_steps
    self._ctrl_drafted0 = self.drafted_tokens
    self._ctrl_accepted0 = self.accepted_tokens

  def run(self, *, temperature: float = 0.0,
          rng: Optional[torch.Generator] = None) -> list:
    """Drain the queue: admit, decode, retire, refill until idle. Returns
    the requests finished since the last call, in submission order. `rng`
    replaces the sampling generator (temperature > 0; speculative
    rejection sampling seeds its host RNG from it too)."""
    if rng is not None:
      self.rng = rng
    while self._queue or self.num_active:
      self._admit_from_queue(temperature)
      if self.num_active:
        if self.speculate:
          self._decode_all_speculative(temperature)
        else:
          self._decode_all(temperature)
    out = [self._finished[uid] for uid in sorted(self._finished)]
    self._finished = {}
    return out

  # -- static-batch surface -------------------------------------------------

  def prefill(self, prompts) -> torch.Tensor:
    """Feed prompts (b, p) at the slots' current positions; returns the
    last logits (b, 1, v) f32. b must equal batch_size."""
    prompts = np.asarray(prompts)
    b, p = prompts.shape
    if b != self.batch:
      raise ValueError(f"prefill batch {b} != engine batch {self.batch}")
    if p == 0:
      raise ValueError("empty prompts")
    start = int(self.positions.max())
    if start + p > self.max_len:
      raise ValueError(
          f"prefill would pass max_len={self.max_len} "
          f"(start {start} + prompt {p})")
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
    pos = torch.as_tensor(self.positions, device=self.device)
    logits = None
    for t in range(p):
      logits, self.state = self._step(self.state, toks[:, t:t + 1], pos + t)
    self.positions = self.positions + p
    return logits.to(torch.float32)

  def generate(self, prompts, *, steps: int, temperature: float = 0.0,
               rng: Optional[torch.Generator] = None) -> GenerationResult:
    """Static-batch wrapper over the continuous engine: every row becomes
    a request with a `steps` token budget and no EOS exit. Rows retired
    early at the max_len boundary come back shorter; see `lengths`.
    Accepts more rows than slots — extras queue. A speculative engine
    reports the call's accept rate."""
    prompts = np.asarray(prompts)
    drafted0, accepted0 = self.drafted_tokens, self.accepted_tokens
    uids = [self.submit(row, max_new_tokens=steps, eos_id=None)
            for row in prompts]
    by_uid = {f.uid: f for f in self.run(temperature=temperature, rng=rng)}
    tokens = np.zeros((len(uids), steps), np.int32)
    lengths = np.zeros((len(uids),), np.int32)
    for r, uid in enumerate(uids):
      t = by_uid[uid].tokens
      tokens[r, :t.size] = t
      lengths[r] = t.size
    drafted = self.drafted_tokens - drafted0
    rate = ((self.accepted_tokens - accepted0) / drafted
            if self.speculate and drafted else None)
    return GenerationResult(tokens=tokens, steps=steps, lengths=lengths,
                            accept_rate=rate)

  def _draw(self, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """(b, 1) int64 tokens on the logits' device from the last position's
    logits (no host sync)."""
    lg = logits[:, -1].to(torch.float32)
    if temperature <= 0.0:
      return torch.argmax(lg, dim=-1, keepdim=True)
    probs = torch.softmax(lg / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=self.rng)

  def _sample(self, logits: torch.Tensor, temperature: float) -> np.ndarray:
    """(b, 1) int tokens on the host from the last position's logits."""
    return self._draw(logits, temperature).cpu().numpy().astype(np.int32)


# ----------------------------------------------------------------------------
# Streaming speech.
# ----------------------------------------------------------------------------


def _any_leaf(tree) -> bool:
  if isinstance(tree, dict):
    return any(_any_leaf(v) for v in tree.values())
  return bool(tree)


def _map_carry(fn, state: dict, carry) -> dict:
  """fn(leaf) of every carry leaf of `state`, None for the others."""
  if isinstance(carry, dict):
    return {k: _map_carry(fn, state[k], c) for k, c in carry.items()}
  return fn(state) if carry else None


def _keep_rows(state: dict, old: dict, keep: torch.Tensor, carry,
               axes) -> None:
  """In place: every carry leaf of `state` takes `old`'s rows where
  `keep` (b,) is False, along the leaf's batch axis."""
  if isinstance(carry, dict):
    for k, c in carry.items():
      _keep_rows(state[k], old[k], keep, c, axes[k])
    return
  if carry:
    shape = [1] * state.ndim
    shape[axes] = keep.shape[0]
    state.copy_(torch.where(keep.view(shape), state, old))


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
