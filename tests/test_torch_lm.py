"""The dense-transformer slice of the port against the reference, on the
CPU at the `llama3-8b` SMOKE widths (2 layers, d 128, 8 heads, 2 kv
heads, attention blocks of 32) in f32, with the reference's params
carried across by `repro_torch.bridge` and inputs drawn with numpy.

Tolerances: the layers (rms_norm, rope, SwiGLU, embedding and head) at
1e-6 — the same f32 ops, only the libraries' roundings differ; whole
models (logits, KV) at 1e-4 — summation order in the GEMMs and the
blockwise softmax. The engine's greedy tokens must be equal.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.layers import embedding as jemb  # noqa: E402
from repro.layers import ffn as jffn  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.layers import rope as jrope  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import LMEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.layers import embedding, ffn, norms, rope  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.api import cast_kv_cache, get_model  # noqa: E402
from repro_torch.quant import quantize_params  # noqa: E402
from repro_torch.serving import LMEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


ARCH = "llama3-8b"
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
#: the routing entry the port adds (see kernels/dispatch.py)
FLASH = ("layers/attn", "flash_attention")


def jcfg():
  return jconfigs.get_smoke(ARCH).with_(dtype=jnp.float32)


def tcfg():
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32)


@pytest.fixture(scope="module")
def jparams():
  return jtf.init_lm(jax.random.PRNGKey(0), jcfg())


@pytest.fixture(scope="module")
def tparams(jparams):
  return from_reference(path_arrays(jparams), tcfg(), device="cpu")


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def tokens(seed, shape, vocab):
  return np.random.RandomState(seed).randint(1, vocab, size=shape)


def close(got, want, tol):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ----------------------------------------------------------------------------
# Layers.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["rms_norm", "rope", "swiglu", "embed"])
def test_layer_matches_reference(jparams, tparams, layer):
  cfg = tcfg()
  x = rnd(0, (2, 16, cfg.d_model))
  if layer == "rms_norm":
    scale = rnd(1, (cfg.d_model,), 0.5) + 1.0
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
  elif layer == "rope":
    xh = rnd(2, (2, 16, 4, 64))
    pos = tokens(3, (2, 16), 40)                # positions up to 40
    got = rope.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos),
                          cfg.rope_theta)
    want = jrope.apply_rope(jnp.asarray(xh), jnp.asarray(pos),
                            cfg.rope_theta)
  elif layer == "swiglu":
    lp = tparams.dense_layers.layers()[1]["ffn"]
    jp = jax.tree.map(lambda a: a[1], jparams["dense_layers"]["ffn"])
    got = ffn.swiglu_forward(lp, torch.from_numpy(x))
    want = jffn.swiglu_forward(jp, jnp.asarray(x))
  else:
    toks = tokens(4, (2, 16), cfg.vocab_size)
    got = embedding.logits(tparams.embedding, embedding.embed(
        tparams.embedding, torch.from_numpy(toks)))
    want = jemb.logits(jparams["embedding"], jemb.embed(
        jparams["embedding"], jnp.asarray(toks)))
  close(got, want, LAYER_TOL)


# ----------------------------------------------------------------------------
# The model.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_reference(jparams, tparams, last_only):
  """s = 64: two q blocks of 32, the diagonal tile and a skipped one."""
  toks = tokens(5, (2, 64), tcfg().vocab_size)
  want, _ = jtf.forward(jparams, jnp.asarray(toks), jcfg(),
                        last_only=last_only)
  got = transformer.forward(tparams, torch.from_numpy(toks), tcfg(),
                            last_only=last_only)
  assert got.shape == want.shape == (2, 1 if last_only else 64, 512)
  close(got, want, MODEL_TOL)


def test_forward_routing_matches_reference(jparams, tparams):
  """Under the kernel policies the prefill GEMMs (flat batch 128 > 16)
  stay plain in both packages. The smoke config's head width (16) is
  not one the flash kernel is built for, so the port declines it too and
  adds no flash entry: the two logs are equal."""
  toks = tokens(6, (2, 64), tcfg().vocab_size)
  with jdispatch.record_dispatch() as jlog:
    want, _ = jtf.forward(jparams, jnp.asarray(toks), jcfg(),
                          policy=jdispatch.resolve_policy("pallas"))
  with dispatch.record_dispatch() as tlog:
    got = transformer.forward(tparams, torch.from_numpy(toks), tcfg(),
                              policy=dispatch.resolve_policy("cuda"))
  close(got, want, MODEL_TOL)
  routes = set(tlog)
  assert tcfg().resolved_head_dim == 16
  assert FLASH not in routes
  assert routes == {tuple(r) for r in jlog}


def test_decode_step_matches_reference(jparams, tparams):
  cfg_j, cfg_t = jcfg(), tcfg()
  b, steps, max_len = 2, 6, 12
  toks = tokens(7, (b, steps), cfg_t.vocab_size)
  pos0 = np.array([0, 3])                       # ragged positions
  jstate = jtf.init_decode_state(cfg_j, b, max_len)
  tstate = transformer.init_decode_state(cfg_t, b, max_len, device="cpu")
  for t in range(steps):
    pos = pos0 + t
    jl, jstate = jtf.decode_step(jparams, jstate, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos, jnp.int32), cfg_j)
    tl, tstate = transformer.decode_step(
        tparams, tstate, torch.from_numpy(toks[:, t:t + 1]),
        torch.from_numpy(pos), cfg_t)
    close(tl, jl, MODEL_TOL)
  for key in ("k", "v"):
    close(tstate["dense"][key], jstate["dense"][key], MODEL_TOL)


def test_decode_matches_forward(tparams):
  """Step-by-step cached decoding reproduces the full forward's
  log-probs (tests/test_serving.py's check, on the port alone)."""
  cfg = tcfg()
  b, s = 2, 16
  toks = torch.from_numpy(tokens(0, (b, s), cfg.vocab_size))
  full = transformer.forward(tparams, toks, cfg)
  state = transformer.init_decode_state(cfg, b, s + 4, device="cpu")
  pos = torch.zeros((b,), dtype=torch.int64)
  steps = []
  for t in range(s):
    lg, state = transformer.decode_step(tparams, state, toks[:, t:t + 1],
                                        pos, cfg)
    steps.append(lg[:, 0])
    pos = pos + 1
  got = torch.stack(steps, dim=1)
  close(torch.log_softmax(got, -1), torch.log_softmax(full, -1),
        dict(atol=2e-2, rtol=2e-2))


def test_api_slot_surgery_and_kv_cast():
  cfg = tcfg()
  api = get_model(cfg)
  state = api.init_decode_state(cfg, 3, 8, device="cpu")
  one = api.init_decode_state(cfg, 1, 8, device="cpu")
  one["dense"]["k"].fill_(2.0)
  out = api.insert_slot(cfg, state, one, 1)
  assert out is state
  assert torch.equal(state["dense"]["k"][:, 1], one["dense"]["k"][:, 0])
  assert not state["dense"]["k"][:, [0, 2]].any()
  narrow = cast_kv_cache(state, torch.bfloat16)
  assert narrow["dense"]["v"].dtype == torch.bfloat16
  with pytest.raises(ValueError, match="not a transformer"):
    transformer.check_supported(type("C", (), dict(
        name="x", family="whisper"))())


def test_layer_leaves_are_views_cached_per_storage(tparams):
  """LayerStack.layers(): views of layer i, built once, rebuilt after a
  leaf is replaced or the params move, never carried into a copy."""
  stack = tparams.dense_layers
  views = stack.layers()
  wq = views[1]["attn"]["wq"]
  assert len(views) == 2 and wq.w.shape == stack.attn.wq.w.shape[1:]
  assert wq.w.data_ptr() == stack.attn.wq.w[1].data_ptr()
  assert views[1]["ln1"].data_ptr() == stack.ln1[1].data_ptr()
  assert stack.layers() is views
  qstack = quantize_params(tparams).dense_layers   # a copy, leaves replaced
  qv = qstack.layers()[0]["attn"]["wq"]
  assert qv.w_q.ndim == 2 and qv.w_scale.ndim == 1
  assert qv.w_q.data_ptr() == qstack.attn.wq.w_q[0].data_ptr()
  moved = copy.deepcopy(stack)
  up = moved.layers()[0]["ffn"]["w_up"].w
  assert up.data_ptr() == moved.ffn.w_up.w.data_ptr()
  assert up.data_ptr() != stack.ffn.w_up.w.data_ptr()
  moved.to(torch.float64)
  assert moved.layers()[0]["ffn"]["w_up"].w.dtype == torch.float64
  assert stack.layers() is views


# ----------------------------------------------------------------------------
# Serving.
# ----------------------------------------------------------------------------

SLOTS, MAX_LEN, N_REQ = 2, 48, 5


def requests(vocab):
  """Prompts of 4..16 tokens and budgets of 1..8, drawn as
  `launch/serve.py` draws them."""
  rng = np.random.RandomState(0)
  out = []
  for _ in range(N_REQ):
    prompt = rng.randint(1, vocab, size=(rng.randint(4, 17),))
    out.append((prompt, int(rng.randint(1, 9))))
  return out


def serve(engine, reqs, eos_id):
  for prompt, budget in reqs:
    engine.submit(prompt, max_new_tokens=budget, eos_id=eos_id)
  return {f.uid: (f.tokens.tolist(), f.finish_reason) for f in engine.run()}


@pytest.fixture(scope="module")
def reference_serving(jparams):
  """The reference engine's greedy results under both policies, with an
  EOS id picked so that it retires one request early."""
  reqs = requests(jcfg().vocab_size)
  first = serve(JaxEngine(jcfg(), jparams, batch_size=SLOTS,
                          max_len=MAX_LEN), reqs, None)
  longest = max(first.values(), key=lambda r: len(r[0]))[0]
  eos = longest[1]
  out = {}
  for policy in ("jnp", "pallas"):
    eng = JaxEngine(jcfg(), jparams, batch_size=SLOTS, max_len=MAX_LEN,
                    kernel_policy=policy)
    with jdispatch.record_dispatch() as log:
      out[policy] = serve(eng, reqs, eos), {tuple(r) for r in log}
  return reqs, eos, out


@pytest.mark.parametrize("policy", ["plain", "cuda"])
def test_engine_matches_reference(tparams, reference_serving, policy):
  """Mixed prompt lengths through 2 slots (so slots refill), one request
  retired by EOS: the same greedy tokens and finish reasons as the
  reference's engine, and under "cuda" the same routing as its
  "pallas" one (on the CPU the wrappers run the plain versions)."""
  reqs, eos, out = reference_serving
  want, want_routes = out["jnp" if policy == "plain" else "pallas"]
  assert "eos" in {r for _, r in want.values()}
  eng = LMEngine(tcfg(), tparams, batch_size=SLOTS, max_len=MAX_LEN,
                 kernel_policy=policy, device="cpu")
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    got = serve(eng, reqs, eos)
  assert got == want
  assert set(log) == want_routes
  assert not any(ops.LAUNCHES.values())
  if policy == "cuda":
    assert {r for _, r in log} == {"decode_matvec", "jnp"}


def test_engine_static_surface_and_limits(tparams):
  cfg = tcfg()
  eng = LMEngine(cfg, tparams, batch_size=2, max_len=10, device="cpu")
  prompts = tokens(8, (2, 4), cfg.vocab_size)
  a = eng.generate(prompts, steps=3)
  eng.reset()
  b = eng.generate(prompts, steps=3)
  np.testing.assert_array_equal(a.tokens, b.tokens)
  assert a.tokens.shape == (2, 3) and a.lengths.tolist() == [3, 3]
  # a 9-token prompt leaves room for one cache write: max_len retires it
  eng.reset()
  uid = eng.submit(tokens(9, (9,), cfg.vocab_size), max_new_tokens=5)
  (fin,) = eng.run()
  assert fin.uid == uid and fin.finish_reason == "max_len"
  assert len(fin.tokens) == 2
  with pytest.raises(ValueError, match="max_len"):
    eng.submit(np.ones(11, np.int32))
  eng.reset()
  logits = eng.prefill(prompts)
  assert logits.shape == (2, 1, cfg.vocab_size)
  np.testing.assert_array_equal(eng.positions, [4, 4])
  with pytest.raises(NotImplementedError, match="the prefix cache"):
    LMEngine(cfg, tparams, batch_size=2, max_len=10, device="cpu",
             prefix_cache=object())


def test_quantized_engine_is_policy_invariant(tparams):
  """PTQ'd layer stacks serve through the int8_gemm regime under "cuda"
  with the plain int8 arithmetic: tokens equal the plain policy's."""
  q = quantize_params(tparams)
  reqs = requests(tcfg().vocab_size)[:3]
  got = {}
  for policy in ("plain", "cuda"):
    eng = LMEngine(tcfg(), q, batch_size=SLOTS, max_len=MAX_LEN,
                   kernel_policy=policy, device="cpu")
    with dispatch.record_dispatch() as log:
      got[policy] = serve(eng, reqs, None)
    if policy == "cuda":
      assert {r for _, r in log} == {"int8_gemm"}
  assert got["plain"] == got["cuda"]


def test_bridge_raises_on_unknown_or_missing_key(jparams):
  arrays = path_arrays(jparams)
  extra = dict(arrays, **{"dense_layers/attn/q_norm": np.ones(2)})
  with pytest.raises(KeyError, match="unused"):
    from_reference(extra, tcfg(), device="cpu")
  missing = {k: v for k, v in arrays.items() if k != "final_norm"}
  with pytest.raises(KeyError, match="final_norm"):
    from_reference(missing, tcfg(), device="cpu")
  no_head = {k: v for k, v in arrays.items()
             if not k.startswith("embedding/head")}
  with pytest.raises(KeyError, match="embedding/head"):
    from_reference(no_head, tcfg(), device="cpu")
