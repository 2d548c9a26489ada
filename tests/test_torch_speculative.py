"""Self-speculative decoding in the port against the reference, on the
CPU at the `llama3-8b` and `deepspeech2-wsj` smoke widths in f32, with
the reference's params carried across by `repro_torch.bridge` and inputs
drawn with numpy.

Tolerances: the acceptance rules, the rank controller and the rewind
contracts are equal; draft factors' products within 1e-4 (each
package's SVD picks its own signs, so u and v are compared only as
u @ v); window logits within 1e-4 of the reference's and of W
sequential steps of the port — f32 summation order: the port's window
GEMMs take b*W rows where a step takes b, and CPU matmuls block the two
differently (measured: ~1e-6), so the two agree to f32 rounding, not bit
for bit as on the reference. Speculative greedy tokens must equal
vanilla greedy's and the reference's speculative engine's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (jax_cfg, path_arrays,  # noqa: E402
                           reference_tree, torch_cfg)
from repro import configs as jconfigs  # noqa: E402
from repro.models import deepspeech as jds  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.serving import LMEngine as JaxEngine  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.core.compress import FactorizationPlan  # noqa: E402
from repro_torch.core.factored import iter_factored_leaves  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.quant import quantize_params  # noqa: E402
from repro_torch.serving import LMEngine  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402

ARCH = "llama3-8b"
TOL = dict(atol=1e-4, rtol=1e-4)
K = 3
# near full rank on the 128-wide smoke GEMMs (accept -> 1), and the
# reference's pathological rank (flat random spectra: accept -> 0)
SANE_RANK, PATHOLOGICAL_RANK = 128, 8
# mixed prompt lengths and budgets, 2x the slots: slots refill mid-run
PROMPT_LENS = (3, 7, 2, 5, 8, 4)
BUDGETS = (4, 8, 3, 6, 2, 5)
SLOTS, MAX_LEN = 2, 32


def jcfg():
  return jconfigs.get_smoke(ARCH).with_(dtype=jnp.float32)


def tcfg():
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """Torch on one thread for this module: parallel test runs put several
  worker processes on a few cores, and torch's default of a thread a
  core in each process turns every small eager op of the engine loops
  into a wait for the others (the module ran ~15x slower that way)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tparams():
  return get_model(tcfg()).init(tcfg(), generator=torch.Generator(
      ).manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def jparams(tparams):
  return reference_tree(tparams, lambda key: jtf.init_lm(key, jcfg()))


@pytest.fixture(scope="module")
def ds2():
  """DS2 at the parity widths: (the reference's tree, the port's model)
  of the same weights."""
  params = get_model(torch_cfg()).init(
      torch_cfg(), generator=torch.Generator().manual_seed(0), device="cpu")
  return reference_tree(params, lambda key: jds.init_model(
      key, jax_cfg())), params


@pytest.fixture(scope="module")
def drafts(tparams):
  """rank -> the port's own draft."""
  return {r: tspec.make_draft_params(tparams, rank=r)
          for r in (SANE_RANK, PATHOLOGICAL_RANK)}


@pytest.fixture(scope="module")
def jdraft(jparams):
  """The reference's own draft at the pathological rank."""
  return jspec.make_draft_params(jparams, rank=PATHOLOGICAL_RANK)


def prompts(vocab):
  rng = np.random.RandomState(7)
  return [rng.randint(1, vocab, size=(n,)) for n in PROMPT_LENS]


def serve(engine, eos_id=None, budgets=BUDGETS):
  uids = [engine.submit(p, max_new_tokens=n, eos_id=eos_id)
          for p, n in zip(prompts(tcfg().vocab_size), budgets)]
  fin = {f.uid: f for f in engine.run()}
  return [(fin[u].tokens.tolist(), fin[u].finish_reason) for u in uids]


def engine(tparams, **kw):
  kw.setdefault("batch_size", SLOTS)
  kw.setdefault("max_len", MAX_LEN)
  return LMEngine(tcfg(), tparams, device="cpu", **kw)


def tree_dict(tree):
  """A JAX dict tree of leaves as nested dicts of Python values."""
  if isinstance(tree, dict):
    return {k: tree_dict(v) for k, v in tree.items()}
  return bool(tree)


# ----------------------------------------------------------------------------
# The pure pieces.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["greedy", "sampled"])
def test_acceptance_rules_match_reference(rule):
  """The same draws through both packages' acceptance rules give the
  same accept lengths and tokens; the sampled rule consumes the same
  `np.random.Generator` stream."""
  rng = np.random.RandomState(3)
  b, k, v = 5, 4, 12
  draft = rng.randint(0, v, size=(b, k))
  if rule == "greedy":
    target = draft.copy()
    target[0, 0] += 1                     # reject at once
    target[1, 2] = (target[1, 2] + 1) % v  # accept 2
    target = np.concatenate([target, rng.randint(0, v, size=(b, 1))], 1)
    got = tspec.accept_longest_prefix(draft, target)
    want = jspec.accept_longest_prefix(draft, target)
    assert got[0].tolist() == [0, 2, k, k, k]
  else:
    q = rng.dirichlet(np.ones(v), size=(b, k))
    p = rng.dirichlet(np.ones(v), size=(b, k + 1))
    got = tspec.accept_sampled(draft, q, p, np.random.default_rng(5))
    want = jspec.accept_sampled(draft, q, p, np.random.default_rng(5))
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
    assert g.dtype == w.dtype


def test_rank_controller_matches_reference():
  kw = dict(band=(0.4, 0.7), step=16, min_rank=8, max_rank=64, interval=2)
  tc, jc = tspec.RankController(**kw), jspec.RankController(**kw)
  rank_t = rank_j = 32
  for rate in (None, 0.1, 0.1, 0.1, 0.5, 0.9, 0.95, 0.99, 0.99, 0.3):
    rank_t, rank_j = tc.propose(rank_t, rate), jc.propose(rank_j, rate)
    assert rank_t == rank_j
  for bad in (dict(band=(0.9, 0.5)), dict(step=0), dict(max_rank=4)):
    with pytest.raises(ValueError):
      jspec.RankController(**bad)
    with pytest.raises(ValueError):
      tspec.RankController(**bad)


@pytest.mark.parametrize("arch", [ARCH, "deepspeech2-wsj", "zamba2-7b"])
def test_decode_state_carry_matches_reference(arch):
  """Transformer: all KV, no carry; DS2: every GRU hidden a carry;
  zamba: the SSM states and conv tails carries, the shared block's KV
  rows positional. The contract and the batch axes equal the
  reference's, and the rewind split follows the contract: carry leaves
  from the snapshot, the others from the window's state."""
  jc, tc = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
  api, japi = get_model(tc), jget_model(jc)
  carry = api.decode_state_carry(tc)
  assert carry == tree_dict(japi.decode_state_carry(jc))
  axes = api.decode_state_batch_axes(tc)
  assert axes == japi.decode_state_batch_axes(jc)
  assert set(carry) == set(axes)

  def fill(tree, fn):
    return {k: fill(c, fn) if isinstance(c, dict) else fn(c)
            for k, c in tree.items()}
  window, snap = fill(carry, lambda c: 1), fill(carry, lambda c: 2)
  merged = tspec.merge_rewind(window, snap, carry)
  assert merged == fill(carry, lambda c: 2 if c else 1)
  assert merged == {ARCH: window, "deepspeech2-wsj": snap}.get(arch, merged)


# ----------------------------------------------------------------------------
# The draft.
# ----------------------------------------------------------------------------

def test_make_draft_params_matches_reference(drafts, jdraft):
  """The same leaves factored at the same ranks as the reference's
  rank-8 draft, each u @ v within 1e-4 of the reference's; unmatched
  leaves (wk and wv: 32 wide, under min_dim) stay whole, as there. At
  rank 128 every matched leaf is factored at min(128, m, n)."""
  want = from_reference(path_arrays(jdraft), tcfg(), device="cpu")
  ref = {leaf.name: leaf for leaf in iter_factored_leaves(want)}
  for rank, tdraft in drafts.items():
    got = {leaf.name: leaf for leaf in iter_factored_leaves(tdraft)}
    assert set(got) == set(ref)
    for name, leaf in got.items():
      assert leaf.is_factored == ref[name].is_factored, name
      if leaf.is_factored:
        assert leaf.rank == min(rank, leaf.in_dim, leaf.out_dim)
    assert sum(leaf.is_factored for leaf in got.values()) == 6
  for name, leaf in got.items():        # rank 8 against the reference's
    assert leaf.rank == ref[name].rank, name
    torch.testing.assert_close(leaf.product(), ref[name].product(), **TOL)


def test_make_draft_params_shares_the_target(tparams, drafts):
  """The draft's embedding, norms and unmatched GEMMs are the target's
  own storage, the target is left as it was, and a plan that matches no
  GEMM (or a PTQ'd model) raises."""
  before = {k: v.clone() for k, v in tparams.state_dict().items()}
  draft = tspec.make_draft_params(tparams, rank=PATHOLOGICAL_RANK)
  assert draft is not tparams
  shared = ("embedding.table", "final_norm", "dense_layers.ln1",
            "dense_layers.ln2", "dense_layers.attn.wk.w",
            "dense_layers.attn.wv.w")
  dsd, tsd = draft.state_dict(), tparams.state_dict()
  for key in shared:
    assert dsd[key].data_ptr() == tsd[key].data_ptr(), key
  assert "dense_layers.attn.wq.u" in dsd and "dense_layers.attn.wq.w" in tsd
  assert dsd["dense_layers.attn.wq.u"].shape == (2, 128, PATHOLOGICAL_RANK)
  assert tparams.dense_layers.attn.wq.is_factored is False
  after = tparams.state_dict()
  assert after.keys() == before.keys()
  assert all(torch.equal(after[k], before[k]) for k in before)
  with pytest.raises(ValueError, match="matched no GEMM leaf"):
    tspec.make_draft_params(
        tparams, plan=FactorizationPlan(include=("no-such-gemm",)))
  with pytest.raises(ValueError, match="matched no GEMM leaf"):
    tspec.make_draft_params(quantize_params(tparams), rank=8)


# ----------------------------------------------------------------------------
# The windows.
# ----------------------------------------------------------------------------

def _history(api, cfg, params, state, positions, seed, vocab=None,
             frames=None):
  """Feed two committed steps at `positions`; returns the state."""
  rng = np.random.RandomState(seed)
  for t in range(2):
    x = (rng.randint(1, vocab, size=(len(positions), 1)) if vocab else
         rng.randn(len(positions), 1, frames).astype(np.float32))
    _, state = api.decode_step(params, state, torch.from_numpy(x),
                               torch.from_numpy(positions + t), cfg)
  return state


@pytest.mark.parametrize("policy", ["plain", "cuda"])
def test_transformer_window_matches_reference_and_steps(jparams, tparams,
                                                        policy):
  """A 4-token window at ragged positions (one running past max_len,
  whose rows drop): logits and KV against the reference's window, and
  against 4 sequential steps of the port. Under "cuda" every window GEMM
  of 8 rows wide enough for the lane gate routes to decode_matvec."""
  cfg, api = tcfg(), get_model(tcfg())
  japi = jget_model(jcfg())
  b, w, s = 2, K + 1, 12
  pos = np.array([3, s - 2])
  toks = np.random.RandomState(1).randint(1, cfg.vocab_size, size=(b, w))
  pol = dispatch.resolve_policy(policy, b, window=w)
  tstate = _history(api, cfg, tparams, api.init_decode_state(
      cfg, b, s, device="cpu"), pos - 2, 2, vocab=cfg.vocab_size)
  jstate = japi.init_decode_state(jcfg(), b, s)
  rng = np.random.RandomState(2)
  for t in range(2):
    x = rng.randint(1, cfg.vocab_size, size=(b, 1))
    _, jstate = japi.decode_step(jparams, jstate, jnp.asarray(x),
                                 jnp.asarray(pos - 2 + t, jnp.int32),
                                 jcfg())
  steps_state = {"dense": {k: v.clone() for k, v in
                           tstate["dense"].items()}}
  want, jstate = japi.decode_window(jparams, jstate, jnp.asarray(toks),
                                    jnp.asarray(pos, jnp.int32), jcfg())
  with dispatch.record_dispatch() as log:
    got, tstate = api.decode_window(tparams, tstate, torch.from_numpy(toks),
                                    torch.from_numpy(pos), cfg, pol)
  seq, steps_state = api.decode_window_sequential(
      tparams, steps_state, torch.from_numpy(toks), torch.from_numpy(pos),
      cfg)
  assert got.shape == (b, w, cfg.vocab_size) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  torch.testing.assert_close(got, seq, **TOL)
  for key in ("k", "v"):
    np.testing.assert_allclose(tstate["dense"][key].numpy(),
                               np.asarray(jstate["dense"][key]), **TOL)
    torch.testing.assert_close(tstate["dense"][key],
                               steps_state["dense"][key], **TOL)
  if policy == "cuda":
    assert {r for n, r in log if n != "layers/attn_k" and
            n != "layers/attn_v"} == {"decode_matvec"}


@pytest.mark.parametrize("policy", ["plain", "cuda"])
def test_ds2_window_matches_reference_and_steps(ds2, policy):
  """DS2's `api_decode_window`: 4 frames from a streaming carry, against
  the reference's and against 4 `api_decode_step`s of the port; under
  "cuda" the recurrence takes the gru_cell regime."""
  jparams, params = ds2
  cfg, api, japi = torch_cfg(), get_model(torch_cfg()), jget_model(jax_cfg())
  b, w = 2, K + 1
  f = params.grus["gru0"].nonrec.in_dim
  state = _history(api, cfg, params, api.init_decode_state(
      cfg, b, device="cpu"), np.zeros(b, np.int64), 3, frames=f)
  jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
  x = np.random.RandomState(4).randn(b, w, f).astype(np.float32)
  pos = torch.zeros(b, dtype=torch.int64)
  want, jnew = japi.decode_window(jparams, jstate, jnp.asarray(x),
                                  jnp.zeros(b, jnp.int32), jax_cfg())
  pol = dispatch.resolve_policy(policy, b, window=w)
  with dispatch.record_dispatch() as log:
    got, new = api.decode_window(params, state, torch.from_numpy(x), pos,
                                 cfg, pol)
  seq, seq_state = api.decode_window_sequential(
      params, state, torch.from_numpy(x), pos, cfg)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  torch.testing.assert_close(got, seq, **TOL)
  for k in state:
    np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), **TOL)
    torch.testing.assert_close(new[k], seq_state[k], **TOL)
  if policy == "cuda":
    assert "gru_cell" in {r for _, r in log}


@pytest.mark.parametrize("accept_len", [0, 1, 2, 3])
@pytest.mark.parametrize("arch", [ARCH, "deepspeech2-wsj"])
def test_rewind_then_redecode_equals_never_drafted(tparams, ds2, arch,
                                                   accept_len):
  """Window k = 3 (as tests/test_speculative_properties.py does it for
  the reference): decode a 4-input window, rewind to `accept_len`
  accepted (the KV family by position alone, DS2 from a clone()d
  snapshot through `merge_rewind`), re-feed the accepted prefix, then 2
  probe inputs: logits and state bit for bit those of a run that only
  ever fed the prefix."""
  if arch == ARCH:
    cfg, params, vocab, frames = tcfg(), tparams, tcfg().vocab_size, None
  else:
    cfg, vocab, params = torch_cfg(), None, ds2[1]
    frames = params.grus["gru0"].nonrec.in_dim
  api, b = get_model(cfg), 2
  rng = np.random.RandomState(10 + accept_len)

  def inputs(n):
    if vocab:
      return torch.from_numpy(rng.randint(1, vocab, size=(b, n)))
    return torch.from_numpy(rng.randn(b, n, frames).astype(np.float32))

  def clone(state):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in state.items()}

  pos = np.zeros(b, np.int64)
  state0 = _history(api, cfg, params, api.init_decode_state(
      cfg, b, 16, device="cpu"), pos, 5, vocab=vocab, frames=frames)
  p = torch.from_numpy(pos + 2)
  window, probes = inputs(K + 1), inputs(2)
  lens = accept_len + 1
  snap = clone(state0)
  _, st_w = api.decode_window(params, clone(state0), window, p, cfg)
  st_spec = tspec.merge_rewind(st_w, snap, api.decode_state_carry(cfg))
  st_ref = clone(state0)
  for t in range(lens):
    lg_s, st_spec = api.decode_step(params, st_spec, window[:, t:t + 1],
                                    p + t, cfg)
    lg_r, st_ref = api.decode_step(params, st_ref, window[:, t:t + 1],
                                   p + t, cfg)
  assert torch.equal(lg_s, lg_r)
  for t in range(2):
    lg_s, st_spec = api.decode_step(params, st_spec, probes[:, t:t + 1],
                                    p + lens + t, cfg)
    lg_r, st_ref = api.decode_step(params, st_ref, probes[:, t:t + 1],
                                   p + lens + t, cfg)
    assert torch.equal(lg_s, lg_r)
  if arch != ARCH:      # the carry states are the never-drafted ones
    assert all(torch.equal(st_spec[k], st_ref[k]) for k in st_ref)


# ----------------------------------------------------------------------------
# The engine.
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vanilla(tparams):
  return serve(engine(tparams))


@pytest.mark.parametrize("policy", ["plain", "cuda"])
@pytest.mark.parametrize("rank", [SANE_RANK, PATHOLOGICAL_RANK])
def test_speculative_matches_vanilla_greedy(tparams, drafts, vanilla, rank,
                                            policy):
  """Mixed prompts through 2 slots with refill: the same tokens and
  finish reasons as vanilla greedy, at a near-full-rank draft (accept
  rate > 0.5, the reference's criterion; budgets of 2..8 cap what a
  window can commit) and the pathological rank 8. Under "cuda" the draft's
  factored GEMMs take the lowrank_gemm regime only at rank 128 (rank 8
  is under the lane gate) and the target's window decode_matvec."""
  eng = engine(tparams, speculate=K, draft_params=drafts[rank],
               kernel_policy=policy)
  assert eng.accept_rate is None
  with dispatch.record_dispatch() as log:
    got = serve(eng)
  assert got == vanilla
  assert eng.drafted_tokens > 0
  assert eng.accepted_tokens <= eng.drafted_tokens
  if rank == SANE_RANK:
    assert eng.accept_rate > 0.5
  regimes = {r for _, r in log}
  if policy == "cuda":
    assert "decode_matvec" in regimes
    assert ("lowrank_gemm" in regimes) == (rank == SANE_RANK)
  else:
    assert regimes == {"jnp"}


def test_speculative_matches_reference_engine(jparams, tparams, jdraft):
  """The reference's LMEngine(speculate=3) and the port's on bridged
  target and draft weights (the reference's own rank-8 draft): the same
  tokens, finish reasons and accept counts."""
  ref = JaxEngine(jcfg(), jparams, batch_size=SLOTS, max_len=MAX_LEN,
                  speculate=K, draft_params=jdraft)
  want = serve(ref)
  eng = engine(tparams, speculate=K, draft_params=from_reference(
      path_arrays(jdraft), tcfg(), device="cpu"))
  assert serve(eng) == want
  assert (eng.drafted_tokens, eng.accepted_tokens) == \
      (ref.drafted_tokens, ref.accepted_tokens)


def test_speculative_boundaries_and_accounting(tparams, drafts, vanilla):
  """EOS inside an accepted window retires at vanilla's step; a window
  running past max_len drops its rows and the slot retires at vanilla's
  "max_len" step; accepted tokens count only what a slot emitted."""
  draft = drafts[SANE_RANK]
  longest = max(vanilla, key=lambda r: len(r[0]))[0]
  eos = longest[2]
  want = serve(engine(tparams), eos_id=eos)
  got = serve(engine(tparams, speculate=K, draft_params=draft), eos_id=eos)
  assert got == want and "eos" in {r for _, r in got}
  prompt = np.array([1, 2, 3, 4])
  runs = []
  for spec in (0, 4):
    eng = engine(tparams, batch_size=1, max_len=8, speculate=spec,
                 draft_params=draft if spec else None)
    eng.submit(prompt, max_new_tokens=100)
    runs.append(eng.run()[0])
  assert [r.finish_reason for r in runs] == ["max_len", "max_len"]
  np.testing.assert_array_equal(runs[0].tokens, runs[1].tokens)
  # budget 2: prefill emits one token, the one window one more, although
  # the near-full-rank draft agrees on all 4
  eng = engine(tparams, batch_size=1, speculate=4, draft_params=draft)
  eng.submit(np.array([1, 2, 3]), max_new_tokens=2)
  assert len(eng.run()[0].tokens) == 2
  assert eng.drafted_tokens == 4 and eng.accepted_tokens <= 1


def test_rank_controller_walk_and_reset(tparams):
  """An unreachable band walks the rank up by `step` to `max_rank`,
  rebuilding the draft; greedy output stays vanilla's. reset()
  reproduces a sampled run (rejection draws included), and
  generate() reports the accept rate."""
  rc = tspec.RankController(band=(0.99, 1.0), step=32, interval=2,
                            min_rank=8, max_rank=80)
  eng = engine(tparams, speculate=2, draft_rank=16, rank_controller=rc,
               max_len=64)
  for _ in range(4):
    eng.submit(np.arange(1, 10), max_new_tokens=16)
  van = engine(tparams, max_len=64)
  for _ in range(4):
    van.submit(np.arange(1, 10), max_new_tokens=16)
  assert [f.tokens.tolist() for f in eng.run()] == \
      [f.tokens.tolist() for f in van.run()]
  assert eng.draft_rank == 80
  ranks = [old for _, old, _ in eng.rank_history] + [eng.draft_rank]
  assert ranks == sorted(ranks) and len(ranks) >= 3
  assert eng.draft_params.dense_layers.attn.wq.u.shape[-1] == 80
  eng = engine(tparams, speculate=2, draft_params=tspec.make_draft_params(
      tparams, rank=SANE_RANK))
  two = np.array([[1, 2, 3], [4, 5, 6]])
  a = eng.generate(two, steps=8, temperature=0.8)
  eng.reset()
  b = eng.generate(two, steps=8, temperature=0.8)
  np.testing.assert_array_equal(a.tokens, b.tokens)
  assert (a.lengths == 8).all()
  assert a.accept_rate is not None and a.accept_rate == b.accept_rate
  assert engine(tparams).generate(two, steps=2).accept_rate is None
  with pytest.raises(ValueError, match="speculate"):
    engine(tparams, rank_controller=tspec.RankController())
  with pytest.raises(ValueError, match="draft_rank"):
    engine(tparams, speculate=2, rank_controller=tspec.RankController())


def test_serve_cli_speculates(capsys):
  from repro_torch.launch import serve
  serve.main(["--arch", ARCH, "--device", "cpu", "--speculate", "3",
              "--draft-rank", "8", "--temperature", "0"])
  out = capsys.readouterr().out
  assert "speculating 3 tokens a step" in out
  assert "accept rate 0." in out or "accept rate 1." in out
