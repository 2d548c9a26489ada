"""Serving the zamba family in the port, on the CPU at the `zamba2-7b`
SMOKE config in f32 (5 layers, d 128: two groups of two Mamba2 blocks
behind the shared attention block, and a one-layer tail): `LMEngine`
against a greedy loop over the reference's jitted `decode_step` (the
port's weights carried into the reference's tree), and the speculative
engine's carry branch (snapshots, `merge_rewind`, the masked replay of
the accepted prefix, the full-accept fast path) against vanilla decoding.

Tolerances: greedy tokens exactly (the reference's loop and the engine
agree to f32 rounding, ~1e-5 in a logit, and no argmax of these weights
sits that close to a tie); speculative greedy equals vanilla greedy
token for token; a carry after an iteration within 1e-5 of the same
tokens fed through `decode_step` one at a time (the window and the
replay sum their GEMMs in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import reference_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import zamba as jz  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import zamba  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serving import LMEngine  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402

ARCH = "zamba2-7b"
SLOTS, MAX_LEN = 2, 40
PROMPT_LENS = (3, 7, 2, 5)
BUDGETS = (6, 4, 8, 5)
K = 2
# a full-rank draft of the 128-wide smoke GEMMs (accepts nearly all, so
# the full-accept fast path runs) and a rank-8 one (rejects nearly all,
# so the masked replay runs)
SANE_RANK, LOW_RANK = 128, 8
CARRY_TOL = dict(atol=1e-5, rtol=1e-5)

J_DECODE = jax.jit(jz.decode_step, static_argnums=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def tcfg():
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32)


def jcfg():
  return jconfigs.get_smoke(ARCH).with_(dtype=jnp.float32)


@pytest.fixture(scope="module")
def params():
  return zamba.init_lm(tcfg(), generator=torch.Generator().manual_seed(0),
                       device="cpu")


@pytest.fixture(scope="module")
def drafts(params):
  return {r: tspec.make_draft_params(params, rank=r)
          for r in (SANE_RANK, LOW_RANK)}


def prompts():
  rng = np.random.RandomState(11)
  return [rng.randint(1, 512, size=(n,)) for n in PROMPT_LENS]


def serve(eng, temperature=0.0):
  uids = [eng.submit(p, max_new_tokens=n, eos_id=None)
          for p, n in zip(prompts(), BUDGETS)]
  fin = {f.uid: f for f in eng.run(temperature=temperature)}
  return [fin[u].tokens.tolist() for u in uids]


def engine(params, **kw):
  return LMEngine(tcfg(), params, batch_size=SLOTS, max_len=MAX_LEN,
                  device="cpu", **kw)


@pytest.fixture(scope="module")
def vanilla(params):
  return serve(engine(params))


def test_engine_greedy_matches_reference_loop(params, vanilla):
  """Each request's greedy tokens from the 2-slot engine (4 requests:
  slots refill mid-run) equal a batch-1 greedy loop over the reference's
  decode_step from a fresh state."""
  jp = reference_tree(params, lambda k: jz.init_lm(k, jcfg()))
  for prompt, budget, got in zip(prompts(), BUDGETS, vanilla):
    state = jz.init_decode_state(jcfg(), 1, MAX_LEN)
    out, tok = [], None
    for t in range(len(prompt) + budget - 1):
      tok = prompt[t] if t < len(prompt) else out[-1]
      logits, state = J_DECODE(jp, state, jnp.asarray([[tok]]),
                               jnp.asarray([t]), jcfg())
      if t >= len(prompt) - 1:
        out.append(int(jnp.argmax(logits[0, -1])))
    assert got == out


@pytest.mark.parametrize("rank", [SANE_RANK, LOW_RANK])
def test_speculative_greedy_equals_vanilla(params, drafts, vanilla, rank):
  """`LMEngine(speculate=2)` greedy emits vanilla greedy's tokens, token
  for token. The full-rank draft takes the full-accept fast path, the
  rank-8 draft the masked replay; each run sees the path it is meant
  for."""
  eng = engine(params, speculate=K, draft_params=drafts[rank])
  replays = []
  replay = eng._replay
  eng._replay = lambda *a: replays.append(1) or replay(*a)
  assert eng._has_carry
  assert serve(eng) == vanilla
  rate = eng.accept_rate
  iters = eng.decode_steps
  if rank == SANE_RANK:
    assert rate > 0.5 and len(replays) < 2 * iters
  else:
    assert rate < 0.5 and len(replays) > 0


def fed_state(eng, params, slot: int) -> dict:
  """Slot `slot`'s fed tokens (its prompt and every emitted token but the
  pending one) through decode_step one at a time, from a fresh batch-1
  state."""
  s = eng._slots[slot]
  fed = list(s.req.prompt) + s.tokens[:-1]
  assert len(fed) == eng.positions[slot]
  api = get_model(tcfg())
  state = api.init_decode_state(tcfg(), 1, MAX_LEN, device="cpu")
  with torch.no_grad():
    for t, tok in enumerate(fed):
      _, state = api.decode_step(params, state, torch.tensor([[tok]]),
                                 torch.tensor([t]), tcfg())
  return state


def test_sampled_speculation_keeps_each_slots_carries(params, drafts):
  """Temperature 0.8 with the rank-8 draft (partial accepts, different
  accepted lengths across the slots): after every iteration each live
  slot's carries, in the target's state and in the draft's, equal its
  committed tokens fed one step at a time."""
  eng = engine(params, speculate=K, draft_params=drafts[LOW_RANK],
               rng=torch.Generator().manual_seed(3))
  axes = get_model(tcfg()).decode_state_batch_axes(tcfg())
  step = eng._decode_all_speculative
  checked = []

  def checked_step(temperature):
    step(temperature)
    for i, s in enumerate(eng._slots):
      if not s.active:
        continue
      for p, state in ((eng.params, eng.state),
                       (eng.draft_params, eng.draft_state)):
        want = fed_state(eng, p, i)
        for key in ("main_ssm", "tail_ssm"):
          for leaf, ax in axes[key].items():
            got = state[key][leaf].select(ax, i)
            np.testing.assert_allclose(
                got.numpy(), want[key][leaf].select(ax, 0).numpy(),
                **CARRY_TOL)
      checked.append(len(s.tokens))
  eng._decode_all_speculative = checked_step
  uids = [eng.submit(p, max_new_tokens=n, eos_id=None)
          for p, n in zip(prompts()[:SLOTS], BUDGETS[:SLOTS])]
  fin = eng.run(temperature=0.8)
  assert sorted(f.uid for f in fin) == uids
  assert len(checked) >= 4 and eng.accept_rate < 1.0


def test_serve_cli_speculates(capsys):
  from repro_torch.launch import serve as serve_cli
  serve_cli.main(["--arch", ARCH, "--device", "cpu", "--speculate", "2",
                  "--temperature", "0", "--steps", "6"])
  out = capsys.readouterr().out
  assert "speculating 2 tokens a step" in out and "accept rate" in out
