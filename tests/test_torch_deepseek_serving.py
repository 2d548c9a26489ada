"""The DeepSeek family served by the port's `LMEngine` against the
reference's engine, on the CPU at the `deepseek-v3-671b` SMOKE config
(q-LoRA, 1 dense + 3 MoE layers) in f32, the port's seeded weights
carried into the reference's tree (`_torch_parity.reference_tree`):
greedy tokens and finish reasons under both policies (mixed prompt
lengths through 2 slots, one request retired by EOS), self-speculative
greedy decoding equal to vanilla greedy with a draft whose expert
stacks are truncated and whose router is the target's, and
`launch/serve.py`.

Tolerances: none, tokens must be equal. Routes are continuous draws with
no exact ties (see `test_torch_deepseek.py`); 2 slots x 4 window rows
cannot overflow an expert's 8 slots, so verification windows route as
the steps they stand for.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import reference_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import LMEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.compress import FactorizationPlan  # noqa: E402
from repro_torch.core.svd import TruncationSpec  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import LMEngine  # noqa: E402
from repro_torch.serving.speculative import make_draft_params  # noqa: E402

ARCH = "deepseek-v3-671b"
SLOTS, MAX_LEN, N_REQ = 2, 48, 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def jcfg():
  return jconfigs.get_smoke(ARCH).with_(dtype=jnp.float32)


def tcfg():
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32)


@pytest.fixture(scope="module")
def tparams():
  return transformer.init_lm(tcfg(), device="cpu",
                             generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def jparams(tparams):
  """The port's weights in the reference's tree (no JAX init is run)."""
  return reference_tree(tparams, lambda k: jtf.init_lm(k, jcfg()))


def requests(vocab):
  """Prompts of 4..16 tokens and budgets of 1..8, drawn as
  `launch/serve.py` draws them."""
  rng = np.random.RandomState(0)
  return [(rng.randint(1, vocab, size=(rng.randint(4, 17),)),
           int(rng.randint(1, 9))) for _ in range(N_REQ)]


def serve(engine, reqs, eos_id):
  """[(tokens, finish reason)] in submission order."""
  uids = [engine.submit(prompt, max_new_tokens=budget, eos_id=eos_id)
          for prompt, budget in reqs]
  done = {f.uid: (f.tokens.tolist(), f.finish_reason) for f in engine.run()}
  return [done[u] for u in uids]


@pytest.fixture(scope="module")
def reference_serving(jparams):
  """The reference engine's greedy results, with an EOS id picked so
  that it retires one request early."""
  reqs = requests(jcfg().vocab_size)
  eng = JaxEngine(jcfg(), jparams, batch_size=SLOTS, max_len=MAX_LEN)
  first = serve(eng, reqs, None)
  longest = max(first, key=lambda r: len(r[0]))[0]
  eos = longest[1]
  eng.reset()                 # its compiled steps serve the second run
  return reqs, eos, serve(eng, reqs, eos)


@pytest.mark.parametrize("policy", ["plain", "cuda"])
def test_engine_matches_reference(tparams, reference_serving, policy):
  """The same greedy tokens and finish reasons as the reference's
  engine; under "cuda" every GEMM routes to decode_matvec or the plain
  path (the smoke widths' 128-lane gate; the CPU runs the plain
  versions) and nothing launches."""
  reqs, eos, want = reference_serving
  assert "eos" in {r for _, r in want}
  eng = LMEngine(tcfg(), tparams, batch_size=SLOTS, max_len=MAX_LEN,
                 kernel_policy=policy, device="cpu")
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    got = serve(eng, reqs, eos)
  assert got == want
  assert not any(ops.LAUNCHES.values())
  routes = {r for _, r in log}
  assert routes == ({"decode_matvec", "jnp"} if policy == "cuda"
                    else {"jnp"})
  if policy == "cuda":
    assert ("layers/ffn_gate", "decode_matvec") in log   # 128 -> 256
    assert ("layers/mla_q_b", "jnp") in log              # 48 -> 128
    assert ("layers/shared/ffn_gate", "jnp") in log      # 128 -> 64


@pytest.mark.parametrize("policy", ["plain", "cuda"])
def test_speculative_greedy_equals_vanilla(tparams, reference_serving,
                                           policy):
  """`speculate=3` with a rank-8 draft of every GEMM of at least 32 wide,
  the (L, E, m, n) expert stacks included, while the draft shares the
  router, norms and embedding with the target: greedy tokens equal
  vanilla greedy's (which equal the reference's)."""
  reqs, eos, want = reference_serving
  plan = FactorizationPlan(min_dim=32,
                           truncation=TruncationSpec(fixed_rank=8))
  draft = make_draft_params(tparams, plan=plan)
  experts = draft.moe_layers.moe.w_gate
  assert experts.is_factored and experts.u.shape == (3, 8, 128, 8)
  assert draft.moe_layers.moe.router is tparams.moe_layers.moe.router
  assert draft.embedding.table is tparams.embedding.table
  eng = LMEngine(tcfg(), tparams, batch_size=SLOTS, max_len=MAX_LEN,
                 kernel_policy=policy, speculate=3, draft_params=draft,
                 device="cpu")
  assert serve(eng, reqs, eos) == want
  assert eng.accept_rate is not None


def test_launch_serve_speculates(capsys):
  """`launch.serve --arch deepseek-v2-lite --device cpu --speculate 3
  --draft-rank 8 --temperature 0` end to end."""
  serve_cli.main(["--arch", "deepseek-v2-lite", "--device", "cpu",
                  "--speculate", "3", "--draft-rank", "8",
                  "--temperature", "0", "--steps", "6"])
  text = capsys.readouterr().out
  assert "speculating 3 tokens" in text and "accept rate" in text
  assert "served 4 requests" in text
