"""The prefix cache of the port against the reference, on the CPU: the
radix trie (`PrefixCache`) driven through the same insert, lookup and
evict sequences as the reference's, with equal results, `stats()` and
bytes; the snapshot contract of `ModelApi` (`decode_state_length_axes`,
`prefix_view`, `splice_prefix`) for every ported family — the
transformer (GQA and DeepSeek's MLA latents), zamba, xlstm, Whisper and
DS2 — leaf for leaf against the reference's on the same numpy state; and
`LMEngine(prefix_cache=, publish_on_retire=)`: cached-splice greedy
equals cold greedy token for token on the xlstm, transformer and zamba
smoke configs with hits, under eviction churn, across a multi-turn hit,
a fork's publish, and a speculative engine that keeps draft snapshots.

Tolerances: none. The trie is integer bookkeeping; a snapshot is a copy;
a spliced state is the cold state at the same length bit for bit (the
same steps on the same shapes), so greedy tokens are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JCache  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serving import LMEngine  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402
from repro_torch.serving.prefix_cache import (PrefixCache,  # noqa: E402
                                              snapshot_bytes)

FAMILIES = ["llama3-8b", "deepseek-v2-lite", "zamba2-7b", "xlstm-350m",
            "whisper-small", "deepspeech2-wsj"]
SERVED = ["xlstm-350m", "llama3-8b", "zamba2-7b"]
MAX_LEN = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


# ----------------------------------------------------------------------------
# The trie.
# ----------------------------------------------------------------------------

def op_sequence(seed: int, n: int = 400) -> list:
  """Random inserts (short keys over a 4-token alphabet, so that keys
  share prefixes and split edges), lookups, matches and common-prefix
  queries, with payloads of 0..3 KB."""
  rng = np.random.RandomState(seed)
  ops = []
  for _ in range(n):
    key = rng.randint(0, 4, size=(rng.randint(1, 9),))
    kind = rng.choice(["insert", "lookup", "match", "common"],
                      p=[0.4, 0.3, 0.15, 0.15])
    ops.append((kind, key, int(rng.randint(0, 3)) * 1024))
  return ops


@pytest.mark.parametrize("capacity_kb", [4.0, 64.0])
def test_trie_matches_reference(capacity_kb):
  """The same 400 operations on both caches (a capacity that evicts on
  most inserts, and one that rarely does): every return value, and
  `stats()`, `bytes` and the entry count after each."""
  mb = capacity_kb / 1024
  port, ref = PrefixCache(mb), JCache(mb)
  for kind, key, size in op_sequence(int(capacity_kb)):
    if kind == "insert":
      got = port.insert(key, (torch.zeros(size // 4), None))
      want = ref.insert(key, (np.zeros(size // 4, np.float32), None))
    else:
      fn = {"lookup": "lookup", "match": "match_longest_prefix",
            "common": "common_prefix_len"}[kind]
      got, want = getattr(port, fn)(key), getattr(ref, fn)(key)
      if kind != "common":
        assert (got[1] is None) == (want[1] is None)
        got, want = got[0], want[0]
    assert got == want, (kind, key)
    assert port.stats() == ref.stats() and len(port) == len(ref)
  assert port.stats()["evictions"] > 0
  assert port.stats()["hits"] > 0


def test_trie_refuses_what_the_reference_refuses():
  with pytest.raises(ValueError):
    PrefixCache(0)
  with pytest.raises(ValueError):
    PrefixCache(1, fork_min_tokens=0)
  cache = PrefixCache(1e-3)                    # 1048 bytes
  with pytest.raises(ValueError, match="empty"):
    cache.insert([], None)
  assert not cache.insert([1, 2], torch.zeros(512))
  assert cache.stats()["rejected_oversize"] == 1 and len(cache) == 0
  assert snapshot_bytes({"a": torch.zeros(3, dtype=torch.bfloat16),
                         "b": [np.zeros(2), None]}) == 6 + 16


# ----------------------------------------------------------------------------
# The snapshot contract, family by family.
# ----------------------------------------------------------------------------

def filled(state: dict, seed: int) -> dict:
  """`state` (nested dicts of tensors) with every leaf drawn at random,
  as numpy (integer leaves as small ints)."""
  rng = np.random.RandomState(seed)
  return {k: filled(v, seed + 1) if isinstance(v, dict) else
          rng.randn(*v.shape).astype(np.float32)
          for k, v in state.items()}


def as_torch(tree):
  if isinstance(tree, dict):
    return {k: as_torch(v) for k, v in tree.items()}
  return torch.from_numpy(tree)


def as_jax(tree):
  if isinstance(tree, dict):
    return {k: as_jax(v) for k, v in tree.items()}
  return jnp.asarray(tree)


def tensors(tree, path=""):
  """(path, leaf) of nested dicts, depth first in insertion order."""
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from tensors(v, f"{path}/{k}")
  else:
    yield path, tree


def leaves(tree):
  """`tensors`, each leaf as a numpy array."""
  for path, x in tensors(tree):
    yield path, np.asarray(x)


def same(got, want) -> None:
  """Leaf for leaf equal, matched by path (JAX walks a dict's keys
  sorted)."""
  got, want = dict(leaves(got)), dict(leaves(want))
  assert sorted(got) == sorted(want)
  for p, w in want.items():
    np.testing.assert_array_equal(got[p], w, err_msg=p)


def cfgs(arch: str):
  return (tconfigs.get_smoke(arch).with_(dtype=torch.float32),
          jconfigs.get_smoke(arch).with_(dtype=jnp.float32))


@pytest.mark.parametrize("arch", FAMILIES)
def test_snapshot_contract_matches_reference(arch):
  """A batch-1 state (every leaf random) after m = 5 tokens: the length
  axes equal the reference's (KV and MLA latent rows: the axis after the
  batch; carries, GRU hiddens and Whisper's memory: -1); `prefix_view`
  and `splice_prefix` into a fresh state give the reference's leaves;
  a state whose KV rows past m are zero, as a cold prefill leaves them,
  comes back from a round trip bit for bit, and a snapshot is a copy."""
  tc, jc = cfgs(arch)
  api, japi = get_model(tc), jget_model(jc)
  m = 5
  axes = api.decode_state_length_axes(tc)
  assert axes == japi.decode_state_length_axes(jc)
  assert any(a >= 0 for _, a in leaves(axes)) == (
      arch not in ("xlstm-350m", "deepspeech2-wsj"))
  state = filled(api.init_decode_state(tc, 1, 16, device="cpu"), 1)
  jsnap = japi.prefix_view(jc, as_jax(state), m)
  tsnap = api.prefix_view(tc, as_torch(state), m)
  same(tsnap, jsnap)
  want = japi.splice_prefix(jc, japi.init_decode_state(jc, 1, 16), jsnap)
  got = api.splice_prefix(tc, api.init_decode_state(tc, 1, 16, device="cpu"),
                          tsnap)
  same(got, want)
  # a cold state at m: its KV rows past m are zero
  cold = as_torch(state)
  for (_, x), (_, ax) in zip(tensors(cold), leaves(axes)):
    if ax >= 0:
      x.narrow(int(ax), m, x.shape[int(ax)] - m).zero_()
  snap = api.prefix_view(tc, cold, m)
  back = api.splice_prefix(tc, api.init_decode_state(tc, 1, 16, device="cpu"),
                           snap)
  same(back, cold)
  kept = [x.clone() for _, x in tensors(snap)]
  for _, x in tensors(cold):
    x.fill_(7.0)
  assert all(torch.equal(a, b) for a, (_, b) in zip(kept, tensors(snap)))


# ----------------------------------------------------------------------------
# The engine.
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
  out = {}
  for arch in SERVED:
    tc = tconfigs.get_smoke(arch).with_(dtype=torch.float32)
    out[arch] = (tc, get_model(tc).init(
        tc, generator=torch.Generator().manual_seed(0), device="cpu"))
  return out


def shared_prompts(seed: int = 3, n: int = 5) -> list:
  """n prompts, four of them opening with one 9-token template."""
  rng = np.random.RandomState(seed)
  template = rng.randint(1, 512, size=(9,))
  out = []
  for i in range(n):
    tail = rng.randint(1, 512, size=(rng.randint(2, 6),))
    out.append(tail if i == 2 else np.concatenate([template, tail]))
  return out


def serve(cfg, params, prompts, cache=None, budget=5, **kw):
  eng = LMEngine(cfg, params, batch_size=2, max_len=MAX_LEN, device="cpu",
                 prefix_cache=cache, **kw)
  uids = [eng.submit(p, max_new_tokens=budget, eos_id=None) for p in prompts]
  fin = {f.uid: f for f in eng.run()}
  return [fin[u].tokens.tolist() for u in uids], eng


@pytest.fixture(scope="module")
def cold(models):
  return {arch: serve(*models[arch], shared_prompts())[0] for arch in SERVED}


@pytest.mark.parametrize("arch", SERVED)
def test_cached_splice_greedy_equals_cold(models, cold, arch):
  """Greedy tokens with a cache equal the cold engine's, token for token:
  the second template request publishes the fork, the later ones hit it
  (and their own prompts' entries); an engine without a cache gives the
  same stats keys, zero."""
  cache = PrefixCache(64)
  got, eng = serve(*models[arch], shared_prompts(), cache)
  assert got == cold[arch]
  stats = eng.cache_stats()
  assert stats["hits"] >= 2 and stats["inserts"] >= len(got)
  assert 0.0 < stats["hit_rate"] < 1.0
  assert 9 in {len(k) for k in cache._entries}          # the fork
  zero = serve(*models[arch], shared_prompts()[:1])[1].cache_stats()
  assert set(zero) == set(stats) and zero["hits"] == 0


def test_eviction_churn_keeps_the_tokens(models, cold):
  """A capacity of ~2.5 xlstm snapshots: entries are evicted while the
  engine serves, and the tokens stay the cold engine's."""
  cfg, params = models["xlstm-350m"]
  probe = PrefixCache(64)
  serve(cfg, params, shared_prompts()[:1], probe)
  tiny = PrefixCache(2.5 * probe.bytes / (1 << 20))
  got, _ = serve(cfg, params, shared_prompts(), tiny)
  assert got == cold["xlstm-350m"]
  assert tiny.stats()["evictions"] > 0 and tiny.bytes <= tiny.capacity_bytes


@pytest.mark.parametrize("arch", ["xlstm-350m", "llama3-8b"])
def test_publish_on_retire_gives_a_multiturn_hit(models, arch):
  """Turn 2 = the turn-1 prompt, its generated tokens and 2 new ones:
  with `publish_on_retire` the served conversation (all but the last,
  never-fed token) is an entry, turn 2 hits it at that length, and its
  tokens equal a cold engine's."""
  cfg, params = models[arch]
  rng = np.random.RandomState(1)
  cache = PrefixCache(64)
  eng = LMEngine(cfg, params, batch_size=2, max_len=MAX_LEN, device="cpu",
                 prefix_cache=cache, publish_on_retire=True)
  eng.submit(rng.randint(1, 512, size=(6,)), max_new_tokens=4)
  f1 = eng.run()[0]
  turn2 = np.concatenate([f1.prompt, f1.tokens, rng.randint(1, 512, size=2)])
  fed = len(f1.prompt) + len(f1.tokens) - 1
  assert cache.match_longest_prefix(turn2[:-1])[0] == fed
  h0 = cache.hits
  eng.submit(turn2, max_new_tokens=4)
  got = eng.run()[0].tokens.tolist()
  assert cache.hits == h0 + 1
  assert got == serve(cfg, params, [turn2], budget=4)[0][0]


def test_fork_is_published_at_the_shared_prefix(models):
  """Two prompts that share 9 tokens and part: the second's admission
  stops its steps at the fork and publishes a 9-token entry (xlstm's
  carries are valid only at the length a prefill stopped at), which a
  third sibling then hits at 9."""
  cfg, params = models["xlstm-350m"]
  p = shared_prompts()
  cache = PrefixCache(64)
  serve(cfg, params, [p[0]], cache)
  assert len(cache) == 1
  serve(cfg, params, [p[1]], cache)
  assert sorted(len(k) for k in cache._entries) == sorted(
      [9, len(p[0]), len(p[1])])
  assert cache.match_longest_prefix(p[3][:-1])[0] == 9
  got, _ = serve(cfg, params, [p[3]], cache)
  assert got == serve(cfg, params, [p[3]])[0]


@pytest.mark.parametrize("arch", ["xlstm-350m", "llama3-8b"])
def test_speculative_engine_keeps_draft_snapshots(models, cold, arch):
  """`speculate=2` with a rank-8 draft and a cache: every admitted
  prompt's entry holds the draft's snapshot beside the target's, later
  admissions splice both, and the greedy tokens are vanilla's."""
  cfg, params = models[arch]
  draft = tspec.make_draft_params(params, rank=8)
  cache = PrefixCache(64)
  got, eng = serve(cfg, params, shared_prompts(), cache, speculate=2,
                   draft_params=draft)
  assert got == cold[arch]
  full = [cache._entries[tuple(int(t) for t in p)].payload
          for p in shared_prompts() if tuple(int(t) for t in p)
          in cache._entries]
  assert full and all(d is not None for _, d in full)
  assert eng.cache_stats()["hits"] >= 2


def test_serve_cli_takes_the_prefix_cache(capsys):
  from repro_torch.launch import serve as serve_cli
  serve_cli.main(["--arch", "xlstm-350m", "--device", "cpu",
                  "--prefix-cache", "--prefix-cache-mb", "16",
                  "--temperature", "0", "--num-requests", "6"])
  out = capsys.readouterr().out
  assert "cache hit rate" in out and "evictions" in out
