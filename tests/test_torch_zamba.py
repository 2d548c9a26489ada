"""The zamba family of the port against the reference, on the CPU at the
`zamba2-7b` SMOKE config in f32 (5 layers, d 128, attn_every 2: two
groups of two Mamba2 blocks behind the shared attention block, then a
one-layer tail), with the port's seeded weights carried into the
reference's tree (`_torch_parity.reference_tree`) and inputs drawn with
numpy: the Mamba2 layer (the chunked SSD scan with its inter-chunk
recurrence, the causal conv with and without its state, the block's
forward, decode step and window), the whole model's forward at one and
at two chunks of 256, decode steps and windows, the state contracts,
the bridge and checkpoints both ways, the prefill's routing at the
full model's head width (112), and training: `loss_fn` and its
gradients (every Mamba2 block checkpointed, as the reference remats
them), the paper's recipe on the (groups, attn_every, m, n) stacks (the
stage-1 factorization, the trace-norm penalty, the truncation to stage
2, each held to the math in float64 and to the reference's own rank
rule and penalty), stage-2 checkpoints crossing between the packages
both ways, and `launch/train.py` end to end. In bf16, the Mamba2 block
and the forward stage by stage against the reference's own bf16
rounding.

The port's A_log, dt_bias, D, conv and norm leaves are redrawn at random
before they are carried across (the init's zeros and ones would leave
A = -1, D = 1 and every norm untested).

Tolerances: layers at 1e-5 (f32, summation order in the GEMMs and the
scan's products). Whole models (logits, states) at 2e-4: on these
weights the reference's own decode window and its steps differ by up to
1.2e-4 at a logit, each package is ~4e-5 from a float64 run, and the
two packages' logits differ by up to 1.5e-4 (measured over 4 seeds;
5 layers of f32 products at activations a few units wide). At 512
positions 5e-4: there both packages sit ~2e-4 from a float64 run
(measured: the reference 1.8e-4, the port 2.8e-4, each other 1.6e-4;
f32 rounding of the scan's decay products over 256-position chunks), so
the test also holds the port's own float64 distance to twice the
reference's. Training: the loss within 1e-5 relative and each leaf's
gradient within 1e-4 relative in norm; a stage-1 product u @ v within
1e-4 of its weight, a stage-2 leaf's error ||W - UV||_F within 1e-3
relative of the discarded singular values' (Eckart-Young; f32 SVDs
against float64), the trace-norm penalty within 1e-5 relative of the
weights' nuclear norms (Lemma 1: the balanced split attains it).
Configs, contracts, ranks, bridged leaves and checkpoints exactly.
"""
import copy
import dataclasses
import json

import numpy as np
from threadpoolctl import threadpool_limits
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays, reference_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.core import tracenorm as jtn  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.layers import mamba2 as jm2  # noqa: E402
from repro.models import zamba as jz  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import compress, svd, tracenorm  # noqa: E402
from repro_torch.core.factored import param_tree, trainable  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.layers import mamba2 as m2  # noqa: E402
from repro_torch.layers.common import ModelConfig  # noqa: E402
from repro_torch.models import zamba  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

ARCH = "zamba2-7b"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
LONG_TOL = dict(atol=5e-4, rtol=5e-4)
LAMBDA = 1e-4
#: bf16 against the reference's bf16 (`bf16_gap`): at most BF16_ULPS of
#: the output's largest binade (one bf16 rounding apart) anywhere, and,
#: at a Mamba2 block, at most BF16_SHARE of the elements different at all.
#: Measured over 8 seeds: a block (forward, steps, window) at most 1 ulp
#: and a share of 0.026, a stage of the forward at most 1 ulp. A stage's
#: share is not held: there one element rounded differently spreads (the
#: shared block's attention mixes positions) to up to 0.47 of the
#: elements, each within an ulp. A rounding moved inside the block (the
#: conv summed in f32, the gate in f32, or x * dt in bf16) showed in 0.55
#: to 0.77 of the block's elements
BF16_ULPS = 1.0
BF16_SHARE = 2.0 ** -4

# the reference's functions, jitted once with their config static (run
# eagerly, each of their scans would be traced and compiled anew)
J_FORWARD = jax.jit(jz.forward, static_argnums=2)
J_DECODE = jax.jit(jz.decode_step, static_argnums=4)
J_WINDOW = jax.jit(jz.decode_window, static_argnums=4)
J_SSD = jax.jit(jm2.ssd_chunked, static_argnames="chunk")
J_CONV = jax.jit(jm2._causal_conv)
J_M2 = jax.jit(jm2.mamba2_forward, static_argnums=2)
J_M2_DECODE = jax.jit(jm2.mamba2_decode, static_argnums=3)
J_M2_WINDOW = jax.jit(jm2.mamba2_decode_window, static_argnums=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch and the BLAS pools on one thread: the suite runs files in
  parallel workers, where spinning pool threads slow every worker."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(limits=1):   # the BLAS pools of host SVDs
    yield
  torch.set_num_threads(n)


def jcfg(**kw):
  return jconfigs.get_smoke(ARCH).with_(dtype=jnp.float32, **kw)


def tcfg(**kw):
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32, **kw)


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def tokens(seed, shape, vocab=512):
  return np.random.RandomState(seed).randint(1, vocab, size=shape)


def close(got, want, tol=MODEL_TOL):
  if isinstance(got, torch.Tensor):
    got = got.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(want), **tol)


#: the f32 leaves redrawn before the weights cross: (scale, offset)
REDRAWN = {"A_log": (0.5, 0.0), "dt_bias": (0.5, -1.0), "D": (0.5, 1.0),
           "conv_w": (0.3, 0.0), "norm": (0.1, 1.0), "norm_in": (0.1, 1.0),
           "ln1": (0.1, 1.0), "ln2": (0.1, 1.0), "final_norm": (0.1, 1.0)}


def port_model(cfg: ModelConfig, seed: int = 0):
  """The port's model from a seeded CPU generator, its f32 leaves
  redrawn (REDRAWN)."""
  tp = zamba.init_lm(cfg, generator=torch.Generator().manual_seed(seed),
                     device="cpu")
  rng = np.random.RandomState(seed + 100)
  with torch.no_grad():
    for name, p in tp.named_parameters():
      leaf = name.split(".")[-1]
      if leaf in REDRAWN:
        scale, offset = REDRAWN[leaf]
        p.copy_(torch.from_numpy(
            rng.randn(*p.shape).astype(np.float32) * scale + offset))
  return tp


def build(cfg: ModelConfig, seed: int = 0):
  """`port_model`, and the same weights as the reference's tree."""
  tp = port_model(cfg, seed)
  jc = jconfigs.get_smoke(ARCH).with_(
      dtype=jnp.float32, **{f: getattr(cfg, f) for f in (
          "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "ssm_state", "attn_every")})
  return reference_tree(tp, lambda k: jz.init_lm(k, jc)), tp, jc


@pytest.fixture(scope="module")
def model():
  return build(tcfg())


def layer(jp, tp, stack="tail", idx=(0,)):
  """One Mamba2 layer: the reference's slice and the port's view."""
  jl = jax.tree.map(lambda a: a[idx], jp[stack])
  views = getattr(tp, stack).layers()
  for i in idx:
    views = views[i]
  return jl, views


# ----------------------------------------------------------------------------
# Config.
# ----------------------------------------------------------------------------

def test_config_matches_reference():
  names = [f.name for f in dataclasses.fields(ModelConfig)
           if f.name != "dtype"]
  for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                       (tconfigs.get_smoke, jconfigs.get_smoke)):
    t, j = get_t(ARCH), get_j(ARCH)
    assert {n: getattr(t, n) for n in names} == \
        {n: getattr(j, n) for n in names}
  full = tconfigs.get_config(ARCH)
  assert full.resolved_head_dim == 112 and zamba._plan(full) == (6, 13, 3)
  assert zamba._plan(tconfigs.get_smoke(ARCH)) == (2, 2, 1)
  assert tconfigs.ARCH_NAMES.index(ARCH) == \
      tconfigs.ARCH_NAMES.index("qwen3-4b") + 1


# ----------------------------------------------------------------------------
# The Mamba2 layer.
# ----------------------------------------------------------------------------

def ssd_inputs(seed, b=2, s=64, h=3, p=8, n=5):
  x = rnd(seed, (b, s, h, p))
  dt = np.log1p(np.exp(rnd(seed + 1, (b, s, h))))     # softplus > 0
  A = -np.exp(rnd(seed + 2, (h,), 0.5))
  B, C = rnd(seed + 3, (b, s, n)), rnd(seed + 4, (b, s, n))
  return x, dt.astype(np.float32), A.astype(np.float32), B, C


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_reference(chunk):
  """s = 64 in chunks of 16 (the inter-chunk recurrence runs 4 chunks)
  and in one chunk: y and the final state; both chunkings agree."""
  args = ssd_inputs(1)
  want_y, want_h = J_SSD(*map(jnp.asarray, args), chunk=chunk)
  got_y, got_h = m2.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
  close(got_y, want_y, LAYER_TOL)
  close(got_h, want_h, LAYER_TOL)
  one_y, one_h = m2.ssd_chunked(*map(torch.from_numpy, args), chunk=64)
  close(got_y, one_y.numpy(), LAYER_TOL)
  close(got_h, one_h.numpy(), LAYER_TOL)


def test_ssd_gradients_are_finite():
  """The segment sum masks to -inf before the exp: the backward pass of
  the chunked scan has no NaN (masking after it would give inf * 0)."""
  x, dt, A, B, C = (torch.from_numpy(a).requires_grad_(True)
                    for a in ssd_inputs(2, s=32))
  y, h = m2.ssd_chunked(x, dt, A, B, C, chunk=16)
  (y.square().sum() + h.sum()).backward()
  for t in (x, dt, A, B, C):
    assert bool(torch.isfinite(t.grad).all())


def test_causal_conv_matches_reference():
  """Without a state (a prefill) and with one (streaming): outputs and
  the next state; a sequence split in two streams like one pass."""
  x, w = rnd(3, (2, 7, 12)), rnd(4, (m2.CONV_WIDTH, 12), 0.3)
  state = rnd(5, (2, m2.CONV_WIDTH - 1, 12))
  for st in (None, state):
    want_y, want_s = J_CONV(jnp.asarray(x), jnp.asarray(w),
                            None if st is None else jnp.asarray(st))
    got_y, got_s = m2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if st is None else
                                   torch.from_numpy(st))
    close(got_y, want_y, LAYER_TOL)
    close(got_s, want_s, dict(atol=0, rtol=0))
  whole, _ = m2._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
  a, sa = m2._causal_conv(torch.from_numpy(x[:, :3]), torch.from_numpy(w))
  b, _ = m2._causal_conv(torch.from_numpy(x[:, 3:]), torch.from_numpy(w), sa)
  close(torch.cat([a, b], 1), whole.numpy(), dict(atol=0, rtol=0))


def test_mamba2_layer_matches_reference(model):
  """One block (the tail's): forward over 64 positions; 3 decode steps
  from a zero state; then a 4-token window from the state they left:
  outputs and both carry leaves."""
  jp, tp, jc = model
  jl, tl = layer(jp, tp)
  tc = tcfg()
  x = rnd(6, (2, 64, 128))
  with torch.no_grad():
    close(m2.mamba2_forward(tl, torch.from_numpy(x), tc),
          J_M2(jl, jnp.asarray(x), jc), LAYER_TOL)
    js = jm2.init_mamba2_state(jc, 2)
    ts = m2.init_mamba2_state(tc, 2, device="cpu")
    for t in range(3):
      want, js = J_M2_DECODE(jl, jnp.asarray(x[:, t:t + 1]), js, jc)
      got, ts = m2.mamba2_decode(tl, torch.from_numpy(x[:, t:t + 1]), ts, tc)
      close(got, want, LAYER_TOL)
    want, js = J_M2_WINDOW(jl, jnp.asarray(x[:, 3:7]), js, jc)
    got, ts = m2.mamba2_decode_window(tl, torch.from_numpy(x[:, 3:7]), ts,
                                      tc)
  close(got, want, LAYER_TOL)
  for k in ("ssm", "conv"):
    close(ts[k], js[k], LAYER_TOL)


# ----------------------------------------------------------------------------
# The model.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("s", [64, 512])
def test_forward_matches_reference(model, s):
  """Logits at 64 positions (one chunk) and at 512 (two chunks of
  256), and the last position alone (`last_only`). At 512 the port's
  distance to its own float64 run is at most twice the reference's."""
  jp, tp, jc = model
  toks = tokens(7, (1, s))
  want = np.asarray(J_FORWARD(jp, jnp.asarray(toks), jc)[0])
  with torch.no_grad():
    got = zamba.forward(tp, torch.from_numpy(toks), tcfg())
    last = zamba.forward(tp, torch.from_numpy(toks), tcfg(), last_only=True)
  tol = MODEL_TOL if s <= m2.CHUNK else LONG_TOL
  close(got, want, tol)
  close(last, want[:, -1:], tol)
  if s > m2.CHUNK:
    with torch.no_grad():
      exact = zamba.forward(copy.deepcopy(tp).double(),
                            torch.from_numpy(toks),
                            tconfigs.get_smoke(ARCH).with_(
                                dtype=torch.float64)).numpy()
    assert np.abs(got.numpy() - exact).max() <= \
        2 * np.abs(want - exact).max()


def test_forward_refuses_a_length_off_the_chunk(model):
  """300 positions: more than CHUNK and not a multiple of it (the
  reference's reshape would fail)."""
  _, tp, _ = model
  with pytest.raises(ValueError, match="CHUNK = 256"):
    zamba.forward(tp, torch.ones((1, 300), dtype=torch.long), tcfg())


def test_decode_steps_and_window_match_reference(model):
  """8 decode steps at staggered positions: logits and every state leaf;
  then, from fresh states, the first 4 tokens as one window against the
  reference's window and the port's own first 4 steps."""
  jp, tp, jc = model
  tc = tcfg()
  api = get_model(tc)
  b, max_len = 2, 16
  toks = tokens(8, (b, 8))
  start = np.array([0, 5])
  js = jz.init_decode_state(jc, b, max_len)
  ts = api.init_decode_state(tc, b, max_len, device="cpu")
  steps = []
  with torch.no_grad():
    for t in range(8):
      pos = start + t
      want, js = J_DECODE(jp, js, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(pos), jc)
      got, ts = api.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos), tc)
      close(got, want)
      steps.append(got[:, 0])
  for key, leaves in ts.items():
    for k, v in leaves.items():
      close(v, js[key][k])
  jw = jz.init_decode_state(jc, b, max_len)
  want, jw = J_WINDOW(jp, jw, jnp.asarray(toks[:, :4]), jnp.asarray(start),
                      jc)
  tw = api.init_decode_state(tc, b, max_len, device="cpu")
  with torch.no_grad():
    got, tw = api.decode_window(tp, tw, torch.from_numpy(toks[:, :4]),
                                torch.from_numpy(start), tc)
    seq, tq = api.decode_window_sequential(
        tp, api.init_decode_state(tc, b, max_len, device="cpu"),
        torch.from_numpy(toks[:, :4]), torch.from_numpy(start), tc)
  close(got, want)
  close(got, seq.numpy())
  for key, leaves in tw.items():
    for k, v in leaves.items():
      close(v, jw[key][k])
      close(v, tq[key][k].numpy())


# ----------------------------------------------------------------------------
# bf16: where each package rounds.
# ----------------------------------------------------------------------------

def bf16_build(seed: int = 0):
  """The SMOKE model in bf16 (the GEMMs, the embedding and the conv carry
  in bf16; conv_w, A_log, D, dt_bias and the norms f32, as the
  reference's init keeps them): the reference's tree of the port's
  weights, the port's model, and both configs."""
  tc = tconfigs.get_smoke(ARCH).with_(dtype=torch.bfloat16)
  jc = jconfigs.get_smoke(ARCH).with_(dtype=jnp.bfloat16)
  tp = port_model(tc, seed)
  return reference_tree(tp, lambda k: jz.init_lm(k, jc)), tp, jc, tc


@pytest.fixture(scope="module")
def bf16_model():
  return bf16_build()


def f32(a) -> np.ndarray:
  if isinstance(a, torch.Tensor):
    return a.detach().float().numpy()
  return np.asarray(a, np.float32)


def bf16_tensor(a) -> torch.Tensor:
  """A reference bf16 array as the same bf16 tensor (through f32, which
  holds every bf16 value)."""
  return torch.from_numpy(f32(a)).bfloat16()


def bf16_gap(got, want) -> tuple[float, float]:
  """(the largest difference in bf16 ulps of the reference's largest
  |value|, the share of the elements that differ)."""
  got, want = f32(got), f32(want)
  ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
  return (float(np.abs(got - want).max() / ulp),
          float((got != want).mean()))


def within_bf16(gaps: dict, share: float = 1.0) -> bool:
  return all(u <= BF16_ULPS and sh <= share for u, sh in gaps.values())


def rounded_jit(fn, *args):
  """`fn` compiled for `args` with XLA's excess precision off, so that it
  rounds to bf16 wherever the code casts, as the code run eagerly does
  (jitted as is, XLA on the CPU keeps such intermediates in f32)."""
  return jax.jit(fn).lower(*args).compile(
      compiler_options={"xla_allow_excess_precision": False})


def bf16_layer_gaps(jp, tp, jc, tc) -> tuple[dict, dict]:
  """The tail's Mamba2 block in bf16, port against reference
  (`rounded_jit`): the forward over 64 positions, 3 decode steps from a
  zero state, then a 4-token window. Returns ({output: `bf16_gap`}, the
  carries: the SSM's largest difference, the conv's dtypes and whether
  they are equal)."""
  jl, tl = layer(jp, tp)
  xj = jnp.asarray(rnd(6, (2, 64, 128)), jnp.bfloat16)
  xt = bf16_tensor(xj)
  js = jm2.init_mamba2_state(jc, 2)
  forward = rounded_jit(lambda p, x: jm2.mamba2_forward(p, x, jc), jl, xj)
  step = rounded_jit(lambda p, x, st: jm2.mamba2_decode(p, x, st, jc), jl,
                     xj[:, :1], js)
  window = rounded_jit(
      lambda p, x, st: jm2.mamba2_decode_window(p, x, st, jc), jl,
      xj[:, 3:7], js)
  ts = m2.init_mamba2_state(tc, 2, device="cpu")
  with torch.no_grad():
    out = {"forward": bf16_gap(m2.mamba2_forward(tl, xt, tc),
                               forward(jl, xj))}
    for t in range(3):
      want, js = step(jl, xj[:, t:t + 1], js)
      got, ts = m2.mamba2_decode(tl, xt[:, t:t + 1], ts, tc)
      out[f"decode {t}"] = bf16_gap(got, want)
    want, js = window(jl, xj[:, 3:7], js)
    got, ts = m2.mamba2_decode_window(tl, xt[:, 3:7], ts, tc)
  out["window"] = bf16_gap(got, want)
  return out, dict(
      ssm=float(np.abs(f32(ts["ssm"]) - f32(js["ssm"])).max()),
      conv_dtypes=(ts["conv"].dtype, js["conv"].dtype),
      conv_equal=bool(np.array_equal(f32(ts["conv"]), f32(js["conv"]))))


def bf16_stage_gaps(jp, tp, jc, tc, s: int = 64) -> tuple[dict, bool]:
  """A bf16 forward over `s` tokens stage by stage: the shared block
  before each group, each Mamba2 block with its residual, the tail's,
  then the final norm with the head. Each port stage is fed the
  reference's own bf16 output of the stage before it (`rounded_jit`).
  Returns ({stage: `bf16_gap`}, whether the port's stages, chained on
  their own outputs, give its `forward` bit for bit)."""
  from repro.layers.common import identity_constraint
  from repro.layers.embedding import embed as jembed, logits as jlogits
  from repro.layers.norms import rms_norm as jrms
  from repro_torch.layers.embedding import embed, logits
  from repro_torch.layers.norms import rms_norm
  toks = tokens(7, (1, s))
  xj = jembed(jp["embedding"], jnp.asarray(toks))
  main = [[jax.tree.map(lambda a: a[g, j], jp["main"])
           for j in range(tc.attn_every)] for g in range(len(jp["main"]["D"]))]
  tail = [jax.tree.map(lambda a: a[t], jp["tail"])
          for t in range(len(jp["tail"]["D"]))]
  block = rounded_jit(lambda x, lp: x + jm2.mamba2_forward(
      lp, jrms(x, lp["norm_in"], jc.norm_eps), jc), xj, tail[0])
  shared = rounded_jit(lambda x, sp: jz._shared_block(
      x, sp, jc, identity_constraint, None), xj, jp["shared_attn"])
  head = rounded_jit(lambda x, e, n: jlogits(e, jrms(x, n, jc.norm_eps)),
                     xj, jp["embedding"], jp["final_norm"])
  sp = tp.shared_attn.view()
  stages = []
  for g, group in enumerate(tp.main.layers()):
    stages.append((f"shared {g}", shared, jp["shared_attn"],
                   lambda x: zamba._shared_block(x, sp, tc)))
    stages += [(f"main {g}.{j}", block, main[g][j],
                lambda x, lp=lp: zamba._mamba_block(x, lp, tc))
               for j, lp in enumerate(group)]
  stages += [(f"tail {t}", block, tail[t],
              lambda x, lp=lp: zamba._mamba_block(x, lp, tc))
             for t, lp in enumerate(tp.tail.layers())]
  gaps = {}
  with torch.no_grad():
    xt = embed(tp.embedding, torch.from_numpy(toks))
    gaps["embedding"] = bf16_gap(xt, xj)
    for name, ref, leaves, port in stages:
      want = ref(xj, leaves)
      gaps[name] = bf16_gap(port(bf16_tensor(xj)), want)
      xj, xt = want, port(xt)
    gaps["head"] = bf16_gap(
        logits(tp.embedding, rms_norm(bf16_tensor(xj), tp.final_norm,
                                      tc.norm_eps)),
        head(xj, jp["embedding"], jp["final_norm"]))
    xt = logits(tp.embedding, rms_norm(xt, tp.final_norm, tc.norm_eps))
    whole = torch.equal(xt, zamba.forward(tp, torch.from_numpy(toks), tc))
  return gaps, whole


def test_mamba2_layer_in_bf16_rounds_as_the_reference(bf16_model):
  """The block in bf16 rounds where the reference does: the conv sums in
  bf16 and keeps a bf16 carry, y is cast to bf16 before the gate, the
  SSD scan and the SSM carry are f32. Every output within BF16_ULPS and
  BF16_SHARE of the reference's bf16 run; the SSM carry within LAYER_TOL;
  the conv carries equal, both bf16."""
  gaps, carry = bf16_layer_gaps(*bf16_model)
  assert within_bf16(gaps, BF16_SHARE), gaps
  assert carry["ssm"] <= LAYER_TOL["atol"], carry
  assert carry["conv_dtypes"] == (torch.bfloat16, jnp.bfloat16) and \
      carry["conv_equal"], carry


def test_forward_in_bf16_matches_reference_stage_by_stage(bf16_model):
  """The bf16 forward, stage by stage (`bf16_stage_gaps`): every stage
  within BF16_ULPS of the reference's bf16 output on the same input, and
  the stages chained are the port's `forward`. The
  whole model's logits are not held: the model carries a difference
  forward from stage to stage, and in bf16 one rounding starts it an ulp
  wide, so two bf16 runs end far apart (on these weights the
  reference's bf16 and f32 logits differ by 0.11-0.22 of their largest
  value)."""
  gaps, whole = bf16_stage_gaps(*bf16_model)
  assert whole
  assert len(gaps) == 1 + 2 + 4 + 1 + 1 and gaps["embedding"] == (0.0, 0.0)
  assert within_bf16(gaps), gaps


def test_state_contracts_match_reference():
  """Batch axes (main_ssm's on axis 2 under its (groups, attn_every)
  stack), the carry split and the state's shapes equal the reference's;
  `insert_slot` writes along each leaf's own batch axis; `cast_kv_cache`
  narrows k and v, never ssm or conv."""
  from repro_torch.models.api import cast_kv_cache
  tc, jc = tcfg(), jcfg()
  api, japi = get_model(tc), jget_model(jc)
  assert api.decode_state_batch_axes(tc) == japi.decode_state_batch_axes(jc)
  assert api.decode_state_carry(tc) == japi.decode_state_carry(jc)
  ts = api.init_decode_state(tc, 3, 8, device="cpu")
  js = japi.init_decode_state(jc, 3, 8)
  assert {k: {n: tuple(v.shape) for n, v in d.items()}
          for k, d in ts.items()} == \
      {k: {n: tuple(v.shape) for n, v in d.items()} for k, d in js.items()}
  one = api.init_decode_state(tc, 1, 8, device="cpu")
  one["main_ssm"]["ssm"].fill_(2.0)
  one["tail_ssm"]["conv"].fill_(3.0)
  api.insert_slot(tc, ts, one, 1)
  assert torch.equal(ts["main_ssm"]["ssm"][:, :, 1],
                     one["main_ssm"]["ssm"][:, :, 0])
  assert not ts["main_ssm"]["ssm"][:, :, [0, 2]].any()
  assert not ts["tail_ssm"]["conv"][:, [0, 2]].any()
  cast = cast_kv_cache(ts, torch.bfloat16)
  assert cast["shared_kv"]["k"].dtype == torch.bfloat16
  assert cast["main_ssm"]["ssm"].dtype == torch.float32
  assert cast["tail_ssm"]["conv"].dtype == torch.float32


def test_prefill_routes_flash_at_head_width_112():
  """The shared block at the full model's head width (d 224, 2 heads of
  112) under the "cuda" policy: one flash route a group (on the CPU the
  wrapper runs its plain version and launches nothing); logits equal
  the model's with no policy (the blockwise attention, held to the
  reference's at d = 112 in `test_torch_dense.py`)."""
  tc = tcfg(d_model=224, num_heads=2, num_kv_heads=2, d_ff=64)
  tp = port_model(tc, seed=1)
  assert tc.resolved_head_dim == 112
  toks = torch.from_numpy(tokens(9, (1, 64)))
  ops.reset_launches()
  with dispatch.record_dispatch() as log, torch.no_grad():
    got = zamba.forward(tp, toks, tc, policy=dispatch.resolve_policy("cuda"))
    want = zamba.forward(tp, toks, tc)
  assert log.count(("layers/attn", "flash_attention")) == 2
  assert not any(ops.LAUNCHES.values())
  close(got, want.numpy())


# ----------------------------------------------------------------------------
# Bridge and checkpoints.
# ----------------------------------------------------------------------------

def test_bridge_round_trips_bit_for_bit(model):
  """The two-level `main` stacks, the one-level `tail` and the unstacked
  shared block keep the reference's paths and bits both ways; the GEMM
  leaves' names follow the reference's init."""
  jp, tp, _ = model
  want = path_arrays(jp)
  got = bridge.to_reference(tp)
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  assert got["main/in_zx/w"].shape == (2, 2, 128, 512)
  assert got["main/conv_w"].shape == (2, 2, m2.CONV_WIDTH, 256)
  assert got["tail/in_bcdt/w"].shape == (1, 128, 2 * 16 + 4)
  back = bridge.from_reference(want, tcfg(), device="cpu")
  assert back.main.out_proj.name == "mamba/ssm_out"
  assert back.shared_attn.attn.wq.name == "shared/attn_q"
  assert back.shared_attn.ffn.w_down.name == "shared/ffn_down"
  again = bridge.to_reference(back)
  for k, v in want.items():
    np.testing.assert_array_equal(again[k], v, err_msg=k)
  # layer (g, j) of a two-level stack is a view of the stacked leaf
  lp = back.main.layers()[1][0]
  assert lp["in_zx"].w.data_ptr() == back.main.in_zx.w[1, 0].data_ptr()
  missing = {k: v for k, v in want.items() if k != "main/A_log"}
  with pytest.raises(KeyError, match="A_log"):
    bridge.from_reference(missing, tcfg(), device="cpu")


def test_checkpoints_load_across_packages(model, tmp_path):
  jp, tp, _ = model
  want = path_arrays(jp)
  JManager(str(tmp_path / "ref")).save(0, {"params": jp})
  loaded = bridge.to_reference(bridge.load_checkpoint(
      str(tmp_path / "ref"), tcfg(), device="cpu"))
  CheckpointManager(str(tmp_path / "port")).save(0, {"params": tp})
  tree, _ = JManager(str(tmp_path / "port")).restore({"params": jp})
  back = path_arrays(tree["params"])
  for k, v in want.items():
    np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    np.testing.assert_array_equal(back[k], v, err_msg=k)


# ----------------------------------------------------------------------------
# Training: the loss, its gradients and the paper's recipe on the stacks.
# ----------------------------------------------------------------------------

def nest(arrays: dict) -> dict:
  """{"a/b/c": x} as {"a": {"b": {"c": x}}}, a tree the reference's
  CheckpointManager takes."""
  out: dict = {}
  for path, x in arrays.items():
    *head, leaf = path.split("/")
    node = out
    for k in head:
      node = node.setdefault(k, {})
    node[leaf] = x
  return out


def layers_of(w: np.ndarray) -> torch.Tensor:
  """A stack's layers (L, m, n) in float64 (torch on this module's one
  thread: numpy's BLAS threads would compete with the other workers)."""
  return torch.from_numpy(w.reshape((-1,) + w.shape[-2:])).double()


def test_loss_and_gradients_match_reference(model):
  jp, tp, jc = model
  batch = jlm.batch_at(jlm.LMDataConfig(vocab_size=512, seq_len=32,
                                        global_batch=2), 0)

  def loss(p):
    return jz.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                      jc)[0]
  want_loss, want = jax.jit(jax.value_and_grad(loss))(jp)
  want = path_arrays(want)
  params = trainable(bridge.from_reference(path_arrays(jp), tcfg(),
                                           device="cpu"))
  got_loss, metrics = zamba.loss_fn(params, batch, tcfg())
  assert metrics == {"xent": got_loss}
  np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                             rtol=1e-5)
  tree = param_tree(params)
  grads = dict(zip(tree, torch.autograd.grad(got_loss, list(tree.values()))))
  assert sorted(grads) == sorted(want)
  for k, g in want.items():
    rel = np.linalg.norm(grads[k].numpy() - g) / max(np.linalg.norm(g), 1e-30)
    assert rel < 1e-4, (k, rel)
  assert float(grads["main/A_log"].abs().max()) > 0


@pytest.fixture(scope="module")
def stages(model):
  """The dense weights, and the port's stage-1 and stage-2 trees (the
  truncation at explained variance 0.5), as path-keyed arrays."""
  _, tp, _ = model
  plan = compress.FactorizationPlan(min_dim=32, exclude=("*embed*",))
  t1 = compress.to_stage1(tp, plan)
  t2 = compress.to_stage2(t1, plan, svd.TruncationSpec(
      variance_threshold=0.5))
  return dict(dense=bridge.to_reference(tp), t1=t1, t2=t2,
              a1=bridge.to_reference(t1), a2=bridge.to_reference(t2))


def factored_paths(arrays: dict) -> list:
  return sorted(k[:-2] for k in arrays if k.endswith("/u"))


def test_stage1_and_stage2_take_the_group_stacks(stages):
  """Every GEMM of at least 32 wide is factored (3 Mamba2 GEMMs in
  `main` and in `tail`, the shared block's 7, the head), the (groups,
  attn_every, m, n) stacks into (groups, attn_every, m, r) and
  (..., r, n) factors. Stage 1 keeps each weight (u @ v = W); stage 2
  takes each stack at one rank, the largest the reference's own rule
  (`repro.core.svd.TruncationSpec.pick`) gives a layer, and each layer's
  error is the discarded singular values' (Eckart-Young)."""
  dense, a1, a2 = stages["dense"], stages["a1"], stages["a2"]
  paths = factored_paths(a1)
  assert paths == factored_paths(a2) == sorted(
      k[:-2] for k in dense if k.endswith("/w")) and len(paths) == 14
  assert a1["main/in_zx/u"].shape == (2, 2, 128, 128)
  assert a1["main/in_bcdt/v"].shape == (2, 2, 36, 36)
  rule = jsvd.TruncationSpec(variance_threshold=0.5)
  for p in paths:
    w = layers_of(dense[p + "/w"])
    np.testing.assert_allclose(
        torch.from_numpy(a1[p + "/u"]) @ torch.from_numpy(a1[p + "/v"]),
        dense[p + "/w"], atol=1e-4, rtol=1e-4, err_msg=p)
    s = torch.linalg.svdvals(w).numpy()
    r = max(rule.pick(row) for row in s)
    u, v = a2[p + "/u"], a2[p + "/v"]
    assert u.shape[-1] == v.shape[-2] == r, p
    uv = layers_of(u) @ layers_of(v)
    err = torch.linalg.matrix_norm(w - uv).numpy()
    np.testing.assert_allclose(err, np.sqrt((s[:, r:] ** 2).sum(-1)),
                               rtol=1e-3, err_msg=p)


def test_trace_norm_penalty_matches_reference(stages):
  """The variational penalty over the stacked stage-1 factors equals
  lambda times the weights' nuclear norms (the balanced split attains
  it, Lemma 1); a (groups, attn_every) stack's penalty equals the
  reference's of the same factors."""
  cfg = tracenorm.RegularizerConfig(kind="trace", lambda_rec=LAMBDA,
                                    lambda_nonrec=LAMBDA)
  dense, a1 = stages["dense"], stages["a1"]
  nuclear = sum(float(torch.linalg.svdvals(layers_of(dense[p + "/w"])).sum())
                for p in factored_paths(a1))
  got = float(tracenorm.regularization_loss(stages["t1"], cfg))
  np.testing.assert_allclose(got, LAMBDA * nuclear, rtol=1e-5)
  u, v = a1["main/in_zx/u"], a1["main/in_zx/v"]
  np.testing.assert_allclose(
      float(tracenorm.variational_trace_norm_penalty(torch.from_numpy(u),
                                                     torch.from_numpy(v))),
      float(jtn.variational_trace_norm_penalty(u, v)), rtol=1e-6)


def test_stage2_checkpoints_cross_both_ways(stages, tmp_path):
  """The port's stage-2 checkpoint restores through the reference's
  CheckpointManager into a template of the stage-2 paths bit for bit,
  and one the reference wrote loads into the port."""
  t2, want = stages["t2"], stages["a2"]
  CheckpointManager(str(tmp_path / "port")).save(3, {"params": t2})
  template = nest({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                   for k, v in want.items()})
  tree, _ = JManager(str(tmp_path / "port")).restore({"params": template})
  back = path_arrays(tree["params"])
  assert sorted(back) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(back[k], v, err_msg=k)
  JManager(str(tmp_path / "ref")).save(3, {"params": nest(want)})
  loaded = bridge.to_reference(bridge.load_checkpoint(
      str(tmp_path / "ref"), tcfg(), device="cpu"))
  assert sorted(loaded) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_launch_train_runs_both_stages(capsys):
  """`launch.train --arch zamba2-7b --device cpu --two-stage` end to
  end: loss lines for both stages, the trace-norm diagnostics, a finite
  final loss."""
  out = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                        "--batch", "2", "--seq", "16", "--two-stage",
                        "--transition", "2"])
  text = capsys.readouterr().out
  assert "stage 1" in text and "stage 2" in text
  assert "trace-norm diagnostics" in text and "rank90=" in text
  assert json.loads(text.strip().splitlines()[-1]) == out
  assert np.isfinite(out["final_loss"])
