"""Lifecycle checks: real serve cycles of the engines, at smoke scale.

Counterpart of `repro/analysis/lifecycle.py`, with its four check names,
scenarios and geometry. The reference counts jit cache sizes after the
cycles; eager PyTorch compiles nothing (the port's engines say so), so
each check keeps its name with an eager meaning:

retrace_stability — across the admit / decode / retire / refill cycle
  (prompt lengths `_PROMPT_LENS` = (3, 6, 3), budget `_BUDGET` = 3,
  batch 2: three requests through two slots), the engine's batch decode
  state keeps every tensor's shape, dtype and storage at every step
  (nothing is rebuilt or re-laid out, the eager counterpart of "one
  decode signature"), and every step launches the same kernels the same
  number of times (under the kernel policy on the card; on the CPU the
  wrappers run their plain versions and launch nothing).

prefix_splice_stability — the shared-prefix scenario served cold and
  through a `PrefixCache`: spliced greedy output equals cold greedy
  output token for token, and the cache hit (otherwise the splice never
  ran and the equality is vacuous).

spec_window_stability — a speculative engine (k = 2, a rank-8 draft
  under a rank controller whose band cannot be met, so the draft's rank
  walks mid-serve) emits the tokens of the vanilla engine in greedy
  decoding, and the rank walked at least once.

speech_fleet_stability — the continuous-batching speech fleet with
  mixed non-stride-multiple utterance lengths (23, 9, 17 frames through
  2 slots) gives each utterance the labels a batch-1 server gives it
  alone.

Families: the three token-driven LMs (qwen3, zamba2, xlstm) run the
LMEngine checks; deepspeech runs the speech-fleet check; Whisper
decodes against encoder memory the engine does not synthesize and is
not audited here, as in the reference.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.analysis.report import Finding
from repro_torch.analysis.targets import state_signature, normalize_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.api import get_model
from repro_torch.serving.engine import LMEngine, StreamingSpeechServer
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.speculative import RankController

#: configs whose family runs the full LMEngine lifecycle
LIFECYCLE_CONFIGS = ("qwen3-4b", "zamba2-7b", "xlstm-350m")

_VOCAB = 64
_BATCH = 2
_MAX_LEN = 16
#: lengths 3 and 6 pad into distinct pow2 buckets in the reference
_PROMPT_LENS = (3, 6, 3)
_BUDGET = 3


def _kernel_policy(policy: str):
  return None if policy == "jnp" else "cuda"


def _model(name: str, device, **overrides):
  cfg = configs.get_smoke(name).with_(**overrides)
  params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0),
                               device=device)
  for p in params.parameters():
    p.requires_grad_(False)
  return cfg, params


def _serve_cycle(cfg, params, policy: str, device) -> Tuple[list, list]:
  """The serve cycle with every batch decode step watched; returns
  (state signature after each step, launches per kernel of each)."""
  eng = LMEngine(cfg, params, batch_size=_BATCH, max_len=_MAX_LEN,
                 kernel_policy=_kernel_policy(policy), device=device)
  sigs, launches = [state_signature(eng.state)], []
  step = eng._step

  def watched(state, tokens, positions):
    before = dict(ops.LAUNCHES)
    out = step(state, tokens, positions)
    if tokens.shape[0] == _BATCH:          # not a batch-1 admission step
      sigs.append(state_signature(out[1]))
      launches.append({k: v - before[k] for k, v in ops.LAUNCHES.items()
                       if v != before[k]})
    return out
  eng._step = watched
  rs = np.random.RandomState(0)
  for n in _PROMPT_LENS:      # 3 requests, 2 slots -> retire + refill
    eng.submit(rs.randint(1, _VOCAB, size=(n,)), max_new_tokens=_BUDGET)
  done = eng.run()
  assert len(done) == len(_PROMPT_LENS)
  return sigs, launches


def check_retrace_stability(
    config_names: Iterable[str], policies: Iterable[str], *,
    device=None) -> Tuple[List[Finding], List[dict]]:
  """Run the serve cycle for every requested lifecycle config x policy;
  return (findings, per-run info rows)."""
  device = resolve_device(device)
  findings: List[Finding] = []
  infos: List[dict] = []
  for name in config_names:
    name = normalize_config(name)
    if name not in LIFECYCLE_CONFIGS:
      continue
    cfg, params = _model(name, device, vocab_size=_VOCAB)
    for policy in policies:
      sigs, launches = _serve_cycle(cfg, params, policy, device)
      infos.append(dict(config=name, policy=policy, quant="-",
                        program="lifecycle", check="retrace_stability",
                        steps=len(launches), step_launches=launches[:1]))

      def fail(key: str, detail: str) -> None:
        findings.append(Finding(
            check="retrace_stability", config=name, policy=policy,
            program="lifecycle", key=key, detail=detail))

      for k in sorted(set().union(*sigs)):
        seen = [s.get(k) for s in sigs]
        if any(x is None or x[:2] != seen[0][:2] for x in seen):
          fail(f"state-signature:{k}",
               f"decode-state leaf {k!r} changed shape or dtype across a "
               f"serve cycle: {sorted({str(x and x[:2]) for x in seen})}")
        elif len({x[2] for x in seen}) > 1:
          fail(f"state-storage:{k}",
               f"decode-state leaf {k!r} moved to {len({x[2] for x in seen})}"
               f" storages across a serve cycle (admit/decode/retire/"
               f"refill): the state is rebuilt, not written in place")
      if any(x != launches[0] for x in launches):
        fail("step-launches",
             f"the decode steps launched different kernels: "
             f"{sorted({str(sorted(x.items())) for x in launches})}")
  return findings, infos


# ---------------------------------------------------------------------------
# prefix_splice_stability
# ---------------------------------------------------------------------------

#: the reference's: two shared-prefix prompts forking after 4 tokens, a
#: third through the fork's entry, and an unrelated one
_SPLICE_PROMPTS = (
    (1, 2, 3, 4, 5, 6, 7, 8),
    (1, 2, 3, 4, 9, 10, 11, 12),
    (1, 2, 3, 4, 13, 14, 15, 16),
    (20, 21, 22, 23),
)


def _splice_cycle(cfg, params, policy: str, cache, device) -> dict:
  """Serve the splice scenario; returns {uid: tokens}."""
  eng = LMEngine(cfg, params, batch_size=_BATCH, max_len=_MAX_LEN,
                 kernel_policy=_kernel_policy(policy), prefix_cache=cache,
                 device=device)
  for p in _SPLICE_PROMPTS:   # 4 requests, 2 slots -> retire + refill
    eng.submit(np.asarray(p, np.int32), max_new_tokens=_BUDGET)
  done = eng.run()
  assert len(done) == len(_SPLICE_PROMPTS)
  return {f.uid: tuple(int(t) for t in f.tokens) for f in done}


def check_prefix_splice_stability(
    config_names: Iterable[str], policies: Iterable[str], *,
    device=None) -> Tuple[List[Finding], List[dict]]:
  """Cold vs cached-splice serve cycles over shared-prefix traffic:
  warm greedy tokens equal cold greedy tokens for every request, and
  the cache hit."""
  device = resolve_device(device)
  findings: List[Finding] = []
  infos: List[dict] = []
  for name in config_names:
    name = normalize_config(name)
    if name not in LIFECYCLE_CONFIGS:
      continue
    cfg, params = _model(name, device, vocab_size=_VOCAB)
    for policy in policies:
      cache = PrefixCache(capacity_mb=64)
      cold = _splice_cycle(cfg, params, policy, None, device)
      warm = _splice_cycle(cfg, params, policy, cache, device)
      st = cache.stats()
      infos.append(dict(config=name, policy=policy, quant="-",
                        program="lifecycle",
                        check="prefix_splice_stability", cache_stats=st))

      def fail(key: str, detail: str) -> None:
        findings.append(Finding(
            check="prefix_splice_stability", config=name, policy=policy,
            program="lifecycle", key=key, detail=detail))

      if warm != cold:
        fail("token-parity",
             f"cached-splice greedy tokens diverged from cold serving "
             f"(cold {cold} vs warm {warm}): the spliced state is not the "
             f"cold prefill's")
      if st["hits"] < 1:
        fail("no-hits",
             f"the shared-prefix scenario produced no cache hits ({st}): "
             f"the splice path never ran")
  return findings, infos


# ---------------------------------------------------------------------------
# spec_window_stability
# ---------------------------------------------------------------------------

_SPEC_K = 2
_SPEC_RANK = 8
_SPEC_BUDGET = 4


def _greedy_tokens(eng: LMEngine) -> dict:
  rs = np.random.RandomState(0)
  for n in _PROMPT_LENS:
    eng.submit(rs.randint(1, _VOCAB, size=(n,)), max_new_tokens=_SPEC_BUDGET)
  return {f.uid: tuple(int(t) for t in f.tokens)
          for f in eng.run(temperature=0.0)}


def check_spec_window_stability(
    config_names: Iterable[str], policies: Iterable[str], *,
    device=None) -> Tuple[List[Finding], List[dict]]:
  """A speculative engine whose draft rank walks mid-serve emits the
  vanilla engine's greedy tokens."""
  device = resolve_device(device)
  findings: List[Finding] = []
  infos: List[dict] = []
  for name in config_names:
    name = normalize_config(name)
    if name not in LIFECYCLE_CONFIGS:
      continue
    cfg, params = _model(name, device, vocab_size=_VOCAB)
    for policy in policies:
      rc = RankController(band=(0.99, 1.0), step=32, interval=2,
                          min_rank=_SPEC_RANK, max_rank=_SPEC_RANK + 64)
      spec = LMEngine(cfg, params, batch_size=_BATCH, max_len=_MAX_LEN,
                      kernel_policy=_kernel_policy(policy),
                      speculate=_SPEC_K, draft_rank=_SPEC_RANK,
                      rank_controller=rc, device=device)
      got = _greedy_tokens(spec)
      want = _greedy_tokens(LMEngine(
          cfg, params, batch_size=_BATCH, max_len=_MAX_LEN,
          kernel_policy=_kernel_policy(policy), device=device))
      walks = len(spec.rank_history)
      infos.append(dict(config=name, policy=policy, quant="-",
                        program="lifecycle", check="spec_window_stability",
                        rank_walks=walks, accept_rate=spec.accept_rate))

      def fail(key: str, detail: str) -> None:
        findings.append(Finding(
            check="spec_window_stability", config=name, policy=policy,
            program="lifecycle", key=key, detail=detail))

      if got != want:
        fail("greedy-parity",
             f"speculative greedy tokens {got} differ from vanilla greedy "
             f"{want}: the verify window is not lossless")
      if walks < 1:
        fail("no-rank-walk",
             f"the rank controller never adjusted the draft rank (rank "
             f"{_SPEC_RANK}): the window was not held across a draft "
             f"rebuild")
  return findings, infos


# ---------------------------------------------------------------------------
# speech_fleet_stability
# ---------------------------------------------------------------------------

#: configs whose family serves through the continuous-batching speech fleet
SPEECH_FLEET_CONFIGS = ("deepspeech2-wsj",)

#: mixed, deliberately non-stride-multiple utterance lengths; 3 utterances
#: through 2 slots force a retire -> refill
_UTT_LENS = (23, 9, 17)


def _fleet_labels(cfg, params, policy: str, batch: int, device) -> dict:
  srv = StreamingSpeechServer(cfg, params, batch_size=batch,
                              kernel_policy=_kernel_policy(policy),
                              device=device)
  rs = np.random.RandomState(0)
  uids = [srv.submit(rs.randn(t, cfg.feat_dim).astype(np.float32))
          for t in _UTT_LENS]
  results = srv.run(chunk_frames=8)
  assert sorted(r.uid for r in results) == sorted(uids)
  return {r.uid: tuple(r.labels) for r in results}


def check_speech_fleet_stability(
    config_names: Iterable[str], policies: Iterable[str], *,
    device=None) -> Tuple[List[Finding], List[dict]]:
  """Fleet labels equal each utterance's labels through a batch-1
  server (continuous batching is a scheduling change, not a numerics
  change)."""
  device = resolve_device(device)
  findings: List[Finding] = []
  infos: List[dict] = []
  for name in config_names:
    name = normalize_config(name)
    if name not in SPEECH_FLEET_CONFIGS:
      continue
    cfg, params = _model(name, device)
    for policy in policies:
      labels = _fleet_labels(cfg, params, policy, _BATCH, device)
      serial = _fleet_labels(cfg, params, policy, 1, device)
      infos.append(dict(config=name, policy=policy, quant="-",
                        program="lifecycle",
                        check="speech_fleet_stability"))
      if labels != serial:
        findings.append(Finding(
            check="speech_fleet_stability", config=name, policy=policy,
            program="lifecycle", key="fleet-serial-divergence",
            detail=(f"continuous-batched labels differ from serial per-"
                    f"utterance decoding: {labels} vs {serial}")))
  return findings, infos
