"""The xlstm family of the port against the reference, on the CPU at the
`xlstm-350m` SMOKE config in f32 (4 layers = 2 (mLSTM, sLSTM) pairs, d
128, 2 heads), with the port's seeded weights carried into the
reference's tree (`_torch_parity.reference_tree`) and inputs drawn with
numpy: the mLSTM's chunk (with a nonzero incoming state) and the two
blocks over 512 positions (two chunks of 256), the sLSTM with a factored
and with a quantized recurrent kernel, the model's forward, `loss_fn`
and its gradients, decode steps and windows leaf for leaf, the state
contracts, the bridge and checkpoints both ways, a decode step's routes
where the recurrent heads reach the 128-lane gate (d 512, 2 heads),
`LMEngine` vanilla and speculative (the all-carry replay), the paper's
recipe (the trace-norm term on the (pairs, heads) stack of `rh`, the
transition's ranks) and `launch.train`; in bf16, each block stage by
stage against the reference's own bf16 rounding.

The port's norms and the sLSTM's bias are redrawn at random before the
weights cross (the init's ones and zeros would leave them untested).

Tolerances: a layer at 1e-5 (f32 summation order). Whole models and
states at 2e-4 (2 pairs of f32 products; each package's logits sit
~1e-5 from the other's on these weights), 512 positions at 5e-4 (the
recurrences carry f32 rounding over 512 steps). Training: the loss
within 1e-5 relative and each leaf's gradient within 1e-4 relative in
norm; the trace-norm term within 1e-5 relative of the reference's on
the same factors. bf16: each block's output (forward, steps, window)
within BF16_ULPS of the reference's bf16 run on the same input; the f32
carries within 1e-5; a slot's carries after a speculative iteration
within CARRY_TOL of its lone steps'. Configs, contracts, routes, ranks,
bridged leaves, checkpoints and greedy tokens exactly.
"""
import dataclasses
import json

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays, reference_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.core import tracenorm as jtn  # noqa: E402
from repro.core.factored import FactoredLinear as JFactored  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.layers import xlstm as jxl  # noqa: E402
from repro.models import xlstm_model as jx  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.quant.leaf import QuantizedLinear as JQuant  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import compress, svd, tracenorm  # noqa: E402
from repro_torch.core.factored import (FactoredLinear, param_tree,  # noqa: E402
                                       trainable)
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.layers import xlstm as xl  # noqa: E402
from repro_torch.layers.common import ModelConfig  # noqa: E402
from repro_torch.models import xlstm_model as xm  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.quant.ptq import quantize_leaf  # noqa: E402
from repro_torch.serving import LMEngine  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402

ARCH = "xlstm-350m"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
LONG_TOL = dict(atol=5e-4, rtol=5e-4)
LAMBDA = 1e-4
#: a slot's carries after a speculative iteration against its tokens fed
#: one step at a time: the window and the replay sum their GEMMs in
#: another order than a lone step, and the mLSTM's matrix memory C (|C|
#: up to ~4 here) sums those rows' k v^T over the steps (measured: 1.3e-5
#: at most over 2 of 65536 entries)
CARRY_TOL = dict(atol=5e-5, rtol=1e-5)
#: bf16 against the reference's bf16: at most one ulp of the output's
#: largest binade (one rounding apart) anywhere
BF16_ULPS = 1.0
SLOTS, MAX_LEN, K = 2, 40, 2
PROMPT_LENS = (3, 7, 2, 5)
BUDGETS = (6, 4, 8, 5)
# a full-rank draft of the smoke GEMMs (at most 256 wide; accepts nearly
# all: the full-accept fast path) and a rank-8 one (rejects nearly all:
# the masked replay); the 64-wide recurrent heads stay the target's
SANE_RANK, LOW_RANK = 256, 8

# the reference's functions, jitted once with their config static
J_FORWARD = jax.jit(jx.forward, static_argnums=2)
J_DECODE = jax.jit(jx.decode_step, static_argnums=4)
J_WINDOW = jax.jit(jx.decode_window, static_argnums=4)
J_CHUNK = jax.jit(jxl._mlstm_chunk)
J_MLSTM = jax.jit(jxl.mlstm_forward, static_argnums=2)
J_SLSTM = jax.jit(jxl.slstm_forward, static_argnums=2)
J_SLSTM_STEP = jax.jit(jxl.slstm_decode, static_argnums=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch and the BLAS pools (the reference's host SVDs at the
  transition) on one thread: the suite runs files in parallel workers,
  and on busy cores a pool of threads runs several times slower."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(limits=1):
    yield
  torch.set_num_threads(n)


def tcfg(**kw):
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32, **kw)


def jcfg_like(cfg: ModelConfig, dtype=jnp.float32):
  return jconfigs.get_smoke(ARCH).with_(dtype=dtype, **{
      f: getattr(cfg, f) for f in ("num_layers", "d_model", "num_heads",
                                   "num_kv_heads", "vocab_size")})


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def tokens(seed, shape, vocab=512):
  return np.random.RandomState(seed).randint(1, vocab, size=shape)


def close(got, want, tol=MODEL_TOL):
  if isinstance(got, torch.Tensor):
    got = got.detach().float().numpy()
  np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


#: the f32 leaves redrawn before the weights cross: (scale, offset)
REDRAWN = {"m_norm": (0.1, 1.0), "s_norm": (0.1, 1.0), "norm": (0.1, 1.0),
           "final_norm": (0.1, 1.0), "bias": (0.5, 0.0)}


def port_model(cfg: ModelConfig, seed: int = 0):
  tp = xm.init_lm(cfg, generator=torch.Generator().manual_seed(seed),
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


def build(cfg: ModelConfig, seed: int = 0, dtype=jnp.float32):
  """`port_model`, the same weights as the reference's tree, and the
  reference's config."""
  tp = port_model(cfg, seed)
  jc = jcfg_like(cfg, dtype)
  return reference_tree(tp, lambda k: jx.init_lm(k, jc)), tp, jc


@pytest.fixture(scope="module")
def model():
  return build(tcfg())


def pair(jp, tp, i=0):
  """Pair i: the reference's slice and the port's view."""
  return jax.tree.map(lambda a: a[i], jp["pairs"]), tp.pairs.layers()[i]


def test_config_matches_reference():
  names = [f.name for f in dataclasses.fields(ModelConfig)
           if f.name != "dtype"]
  for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                       (tconfigs.get_smoke, jconfigs.get_smoke)):
    t, j = get_t(ARCH), get_j(ARCH)
    assert {n: getattr(t, n) for n in names} == \
        {n: getattr(j, n) for n in names}
  assert tconfigs.ARCH_NAMES.index(ARCH) == \
      tconfigs.ARCH_NAMES.index("zamba2-7b") + 1


# ----------------------------------------------------------------------------
# The blocks.
# ----------------------------------------------------------------------------

def test_mlstm_chunk_matches_reference():
  """One chunk of 64 positions from a nonzero incoming (C, n, m): y and
  the state at the chunk's end."""
  b, q, h, p = 2, 64, 2, 16
  args = [rnd(1, (b, q, h, p)), rnd(2, (b, q, h, p)), rnd(3, (b, q, h, p)),
          np.log(1 / (1 + np.exp(-rnd(4, (b, q, h), 2.0)))).astype(np.float32),
          rnd(5, (b, q, h)), rnd(6, (b, h, p, p)), rnd(7, (b, h, p)),
          rnd(8, (b, h))]
  want = J_CHUNK(*map(jnp.asarray, args))
  got = xl._mlstm_chunk(*map(torch.from_numpy, args))
  for g, w in zip(got, want):
    close(g, w, LAYER_TOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_forward_over_two_chunks_matches_reference(model, block):
  """Each block of pair 1 over 512 positions: the mLSTM's state crosses
  a chunk boundary, the sLSTM's recurrence runs 512 steps."""
  jp, tp, jc = model
  jl, tl = pair(jp, tp, 1)
  x = rnd(9, (1, 512, 128))
  fn = {"mlstm": (J_MLSTM, xl.mlstm_forward),
        "slstm": (J_SLSTM, xl.slstm_forward)}[block]
  want = fn[0](jl[block], jnp.asarray(x), jc)
  with torch.no_grad():
    got = fn[1](tl[block], torch.from_numpy(x), tcfg())
  close(got, want, LONG_TOL)


def test_mlstm_refuses_a_length_off_the_chunk(model):
  _, tp, _ = model
  with pytest.raises(ValueError, match="CHUNK = 256"):
    xl.mlstm_forward(tp.pairs.layers()[0]["mlstm"],
                     torch.zeros((1, 300, 128)), tcfg())


def rh_forms(tl, seed: int):
  """The sLSTM's recurrent kernel (heads, hd, 4 hd) of pair `tl` as a
  factored leaf (rank 16, random factors) and as its int8 form, each in
  both packages: {form: (port leaf, reference leaf)}."""
  h, hd, n = tl["rh"].w.shape
  u, v = rnd(seed, (h, hd, 16), 0.3), rnd(seed + 1, (h, 16, n), 0.3)
  kw = dict(name="pairs/slstm_rec", group="rec")
  fact = (FactoredLinear(u=torch.from_numpy(u), v=torch.from_numpy(v), **kw),
          JFactored(w=None, u=jnp.asarray(u), v=jnp.asarray(v), **kw))
  q = quantize_leaf(tl["rh"])
  quant = (q, JQuant(w_q=jnp.asarray(q.w_q.numpy()),
                     w_scale=jnp.asarray(q.w_scale.numpy()), u_q=None,
                     u_scale=None, v_q=None, v_scale=None, **kw))
  return {"factored": fact, "quantized": quant}


@pytest.mark.parametrize("form", ["factored", "quantized"])
def test_slstm_with_factored_and_quantized_rh(model, form):
  """The sLSTM (pair 0) with its recurrent kernel factored (applied head
  by head as (x @ U) @ V) or int8 (the w8a8 arithmetic): the forward over
  32 positions, then 3 decode steps from its zero state."""
  jp, tp, jc = model
  jl, tl = pair(jp, tp)
  t_rh, j_rh = rh_forms(tl["slstm"], 10)[form]
  jl = dict(jl["slstm"], rh=j_rh)
  tl = dict(tl["slstm"], rh=t_rh)
  tc = tcfg()
  x = rnd(11, (2, 32, 128))
  with torch.no_grad():
    close(xl.slstm_forward(tl, torch.from_numpy(x), tc),
          J_SLSTM(jl, jnp.asarray(x), jc), LAYER_TOL)
    js = jxl.init_slstm_state(jc, 2)
    ts = xl.init_slstm_state(tc, 2, device="cpu")
    for t in range(3):
      want, js = J_SLSTM_STEP(jl, jnp.asarray(x[:, t:t + 1]), js, jc)
      got, ts = xl.slstm_decode(tl, torch.from_numpy(x[:, t:t + 1]), ts, tc)
      close(got, want, LAYER_TOL)
  for k in ("h", "c", "n", "m"):
    close(ts[k], js[k], LAYER_TOL)


# ----------------------------------------------------------------------------
# The model.
# ----------------------------------------------------------------------------

def test_forward_matches_reference(model):
  """Logits at 64 positions, and the last position alone (`last_only`)."""
  jp, tp, jc = model
  toks = tokens(12, (2, 64))
  want = np.asarray(J_FORWARD(jp, jnp.asarray(toks), jc)[0])
  with torch.no_grad():
    got = xm.forward(tp, torch.from_numpy(toks), tcfg())
    last = xm.forward(tp, torch.from_numpy(toks), tcfg(), last_only=True)
  close(got, want)
  close(last, want[:, -1:])


def test_decode_steps_and_window_match_reference(model):
  """6 decode steps: logits and every carry leaf; then, from fresh
  states, the first 4 tokens as one window against the reference's window
  and the port's sequential oracle (`decode_window_sequential`)."""
  jp, tp, jc = model
  tc = tcfg()
  api = get_model(tc)
  b = 2
  toks = tokens(13, (b, 6))
  pos = np.zeros((b,), np.int64)
  js = jx.init_decode_state(jc, b, 16)
  ts = api.init_decode_state(tc, b, 16, device="cpu")
  with torch.no_grad():
    for t in range(6):
      want, js = J_DECODE(jp, js, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(pos + t), jc)
      got, ts = api.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos + t), tc)
      close(got, want)
  for key, leaves in ts.items():
    for k, v in leaves.items():
      close(v, js[key][k])
  want, jw = J_WINDOW(jp, jx.init_decode_state(jc, b, 16),
                      jnp.asarray(toks[:, :4]), jnp.asarray(pos), jc)
  with torch.no_grad():
    got, tw = api.decode_window(
        tp, api.init_decode_state(tc, b, 16, device="cpu"),
        torch.from_numpy(toks[:, :4]), torch.from_numpy(pos), tc)
    seq, tq = api.decode_window_sequential(
        tp, api.init_decode_state(tc, b, 16, device="cpu"),
        torch.from_numpy(toks[:, :4]), torch.from_numpy(pos), tc)
  close(got, want)
  close(got, seq.numpy(), LAYER_TOL)
  for key, leaves in tw.items():
    for k, v in leaves.items():
      close(v, jw[key][k])
      close(v, tq[key][k].numpy(), LAYER_TOL)


def test_state_contracts_match_reference():
  """Batch axes (axis 1 under the pair stack), every leaf a carry, and
  the state's shapes equal the reference's; `insert_slot`,
  `extract_slot` and `reset_slot` act on one slot along each leaf's
  batch axis."""
  tc, jc = tcfg(), jcfg_like(tcfg())
  api, japi = get_model(tc), jget_model(jc)
  assert api.decode_state_batch_axes(tc) == japi.decode_state_batch_axes(jc)
  assert api.decode_state_carry(tc) == japi.decode_state_carry(jc)
  ts = api.init_decode_state(tc, 3, 8, device="cpu")
  js = japi.init_decode_state(jc, 3, 8)
  assert {k: {n: (tuple(v.shape), float(v.flatten()[0]))
              for n, v in d.items()} for k, d in ts.items()} == \
      {k: {n: (tuple(v.shape), float(v.flatten()[0])) for n, v in d.items()}
       for k, d in js.items()}
  one = api.init_decode_state(tc, 1, 8, device="cpu")
  one["mlstm"]["C"].fill_(2.0)
  api.insert_slot(tc, ts, one, 1)
  assert torch.equal(ts["mlstm"]["C"][:, 1], one["mlstm"]["C"][:, 0])
  assert not ts["mlstm"]["C"][:, [0, 2]].any()
  got = api.extract_slot(tc, ts, 1)
  assert torch.equal(got["mlstm"]["C"], one["mlstm"]["C"])
  ts["mlstm"]["C"].fill_(5.0)                    # a copy, not a view
  assert torch.equal(got["mlstm"]["C"], one["mlstm"]["C"])
  api.reset_slot(tc, ts, 2)
  assert not ts["mlstm"]["C"][:, 2].any()
  assert (ts["mlstm"]["C"][:, :2] == 5.0).all()
  assert (ts["mlstm"]["m"][:, 2] == xl.M_START).all()


def test_decode_routes_match_reference():
  """One batch-2 decode step at d 512, 2 heads, where each recurrent head
  (256, 1024) passes the 128-lane gate: the port's routes under "cuda"
  are the reference's under "pallas" (traced with `jax.eval_shape`, one
  record a GEMM of the pair body, a head apiece), each a pair apart; the
  mLSTM's gate projection (1024 -> 4) stays plain. On the CPU the
  wrappers run their plain versions and launch nothing: logits as the
  step's with no policy."""
  tc = tcfg(d_model=512)
  jp, tp, jc = build(tc, seed=3)
  tok, pos = tokens(14, (2, 1)), np.array([0, 0])
  with jdispatch.record_dispatch() as jlog:
    jax.eval_shape(lambda p, s, t: jx.decode_step(
        p, s, t, jnp.asarray(pos), jc,
        policy=jdispatch.resolve_policy("pallas", 2)),
        jp, jx.init_decode_state(jc, 2, 8), jnp.asarray(tok))
  ops.reset_launches()
  with dispatch.record_dispatch() as log, torch.no_grad():
    got, _ = xm.decode_step(tp, xm.init_decode_state(tc, 2, device="cpu"),
                            torch.from_numpy(tok), None, tc,
                            dispatch.resolve_policy("cuda", 2))
    want, _ = xm.decode_step(tp, xm.init_decode_state(tc, 2, device="cpu"),
                             torch.from_numpy(tok), None, tc)
  jlog = [tuple(r) for r in jlog]
  pairs = tc.num_layers // 2
  body = [r for r in jlog if r[0] != "lm_head"]
  assert log == body * pairs + [r for r in jlog if r[0] == "lm_head"]
  assert log.count(("pairs/slstm_rec", "decode_matvec")) == 2 * pairs
  assert ("pairs/mlstm_ifg", "jnp") in log
  assert {r for _, r in log} == {"decode_matvec", "jnp"}
  assert not any(ops.LAUNCHES.values())
  close(got, want.numpy(), LAYER_TOL)


# ----------------------------------------------------------------------------
# bf16: where each package rounds.
# ----------------------------------------------------------------------------

def f32(a) -> np.ndarray:
  if isinstance(a, torch.Tensor):
    return a.detach().float().numpy()
  return np.asarray(a, np.float32)


def bf16_gap(got, want) -> float:
  """The largest difference in bf16 ulps of the reference's largest
  |value|."""
  got, want = f32(got), f32(want)
  ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
  return float(np.abs(got - want).max() / ulp)


def rounded_jit(fn, *args):
  """`fn` compiled for `args` with XLA's excess precision off, so that it
  rounds to bf16 wherever the code casts, as the code run eagerly does."""
  return jax.jit(fn).lower(*args).compile(
      compiler_options={"xla_allow_excess_precision": False})


def test_blocks_in_bf16_round_as_the_reference():
  """A bf16 pair, block by block, each fed the same bf16 input: the
  mLSTM's and the sLSTM's forward over 64 positions, then 2 decode steps
  and a 3-token window of each from the zero state. Every output within
  BF16_ULPS of the reference's bf16 run (`rounded_jit`); the f32 carries
  within LAYER_TOL."""
  tc = tconfigs.get_smoke(ARCH).with_(dtype=torch.bfloat16)
  jp, tp, jc = build(tc, seed=4, dtype=jnp.bfloat16)
  jl, tl = pair(jp, tp)
  xj = jnp.asarray(rnd(15, (2, 64, 128)), jnp.bfloat16)
  xt = torch.from_numpy(f32(xj)).bfloat16()
  gaps, carries = {}, {}
  for name, fwd, dec, win, init in (
      ("mlstm", jxl.mlstm_forward, jxl.mlstm_decode, jxl.mlstm_decode_window,
       jxl.init_mlstm_state),
      ("slstm", jxl.slstm_forward, jxl.slstm_decode, jxl.slstm_decode_window,
       jxl.init_slstm_state)):
    port = {"mlstm": (xl.mlstm_forward, xl.mlstm_decode,
                      xl.mlstm_decode_window, xl.init_mlstm_state),
            "slstm": (xl.slstm_forward, xl.slstm_decode,
                      xl.slstm_decode_window, xl.init_slstm_state)}[name]
    p = jl[name]
    js = init(jc, 2)
    f = rounded_jit(lambda p, x, fwd=fwd: fwd(p, x, jc), p, xj)
    step = rounded_jit(lambda p, x, s, dec=dec: dec(p, x, s, jc), p,
                       xj[:, :1], js)
    window = rounded_jit(lambda p, x, s, win=win: win(p, x, s, jc), p,
                         xj[:, 2:5], js)
    ts = port[3](tc, 2, device="cpu")
    with torch.no_grad():
      gaps[f"{name} forward"] = bf16_gap(port[0](tl[name], xt, tc), f(p, xj))
      for t in range(2):
        want, js = step(p, xj[:, t:t + 1], js)
        got, ts = port[1](tl[name], xt[:, t:t + 1], ts, tc)
        gaps[f"{name} step {t}"] = bf16_gap(got, want)
      want, js = window(p, xj[:, 2:5], js)
      got, ts = port[2](tl[name], xt[:, 2:5], ts, tc)
      gaps[f"{name} window"] = bf16_gap(got, want)
    carries[name] = max(float(np.abs(f32(ts[k]) - f32(js[k])).max())
                        for k in ts)
  assert all(g <= BF16_ULPS for g in gaps.values()), gaps
  assert all(c <= LAYER_TOL["atol"] for c in carries.values()), carries


# ----------------------------------------------------------------------------
# Bridge and checkpoints.
# ----------------------------------------------------------------------------

def test_bridge_round_trips_bit_for_bit(model, tmp_path):
  """The pair stacks ((pairs, heads, hd, 4 hd) for `rh`) keep the
  reference's paths and bits both ways, names and groups as its init
  gives them; checkpoints written by either package load in the other."""
  jp, tp, _ = model
  want = path_arrays(jp)
  got = bridge.to_reference(tp)
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  assert got["pairs/slstm/rh/w"].shape == (2, 2, 64, 256)
  back = bridge.from_reference(want, tcfg(), device="cpu")
  assert (back.pairs.slstm.rh.name, back.pairs.slstm.rh.group) == \
      ("pairs/slstm_rec", "rec")
  assert (back.pairs.slstm.wx.name, back.pairs.mlstm.ifg.name) == \
      ("pairs/slstm_nonrec", "pairs/mlstm_ifg")
  lp = back.pairs.layers()[1]
  assert lp["slstm"]["rh"].w.data_ptr() == \
      back.pairs.slstm.rh.w[1].data_ptr()
  JManager(str(tmp_path / "ref")).save(0, {"params": jp})
  loaded = bridge.to_reference(bridge.load_checkpoint(
      str(tmp_path / "ref"), tcfg(), device="cpu"))
  CheckpointManager(str(tmp_path / "port")).save(0, {"params": tp})
  tree, _ = JManager(str(tmp_path / "port")).restore({"params": jp})
  again = path_arrays(tree["params"])
  for k, v in want.items():
    np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    np.testing.assert_array_equal(again[k], v, err_msg=k)


# ----------------------------------------------------------------------------
# Training.
# ----------------------------------------------------------------------------

def test_loss_and_gradients_match_reference(model):
  jp, tp, jc = model
  batch = jlm.batch_at(jlm.LMDataConfig(vocab_size=512, seq_len=32,
                                        global_batch=2), 0)

  def loss(p):
    return jx.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                      jc)[0]
  want_loss, want = jax.jit(jax.value_and_grad(loss))(jp)
  want = path_arrays(want)
  params = trainable(bridge.from_reference(path_arrays(jp), tcfg(),
                                           device="cpu"))
  got_loss, metrics = xm.loss_fn(params, batch, tcfg())
  assert metrics == {"xent": got_loss}
  np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                             rtol=1e-5)
  tree = param_tree(params)
  grads = dict(zip(tree, torch.autograd.grad(got_loss, list(tree.values()))))
  assert sorted(grads) == sorted(want)
  for k, g in want.items():
    rel = np.linalg.norm(grads[k].numpy() - g) / max(np.linalg.norm(g), 1e-30)
    assert rel < 1e-4, (k, rel)
  assert float(grads["pairs/slstm/rh/w"].abs().max()) > 0


def test_trace_norm_and_transition_match_reference(model):
  """The paper's recipe on the stacks: the port's stage-1 model (every
  GEMM of at least 32 wide factored, the (pairs, heads, hd, 4 hd) `rh`
  into (pairs, heads, hd, r) and (..., r, 4 hd) factors) carried into the
  reference's stage-1 tree: its trace-norm term, lambda_rec on `rh` and
  lambda_nonrec elsewhere, equals the reference's `regularization_loss`
  of the same factors; the transition (explained variance 0.5) gives
  every leaf the rank the reference's `TruncationSpec` picks from the
  same products' spectra, and the `rec` stack the rank the reference's
  `to_stage2` gives it."""
  jp, tp, jc = model
  plan = compress.FactorizationPlan(min_dim=32, exclude=("*embed*",))
  jplan = jcompress.FactorizationPlan(min_dim=32, exclude=("*embed*",))
  t1 = compress.to_stage1(tp, plan)
  a1 = bridge.to_reference(t1)
  assert a1["pairs/slstm/rh/u"].shape == (2, 2, 64, 64)
  assert "pairs/mlstm/ifg/w" in a1          # (256, 4): below min_dim
  flat, tree = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
      lambda k: jcompress.to_stage1(jx.init_lm(k, jc), jplan),
      jax.random.PRNGKey(0)))
  j1 = jax.tree_util.tree_unflatten(tree, [
      jnp.asarray(a1["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                              for k in path)]) for path, _ in flat])
  for rec, nonrec in ((LAMBDA, LAMBDA), (2 * LAMBDA, 0.0)):
    got = tracenorm.regularization_loss(t1, tracenorm.RegularizerConfig(
        kind="trace", lambda_rec=rec, lambda_nonrec=nonrec))
    want = jtn.regularization_loss(j1, jtn.RegularizerConfig(
        kind="trace", lambda_rec=rec, lambda_nonrec=nonrec))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
  spec = svd.TruncationSpec(variance_threshold=0.5)
  jspec = jsvd.TruncationSpec(variance_threshold=0.5)
  a2 = bridge.to_reference(compress.to_stage2(t1, plan, spec))
  ranks = {k[:-2]: v.shape[-1] for k, v in a2.items() if k.endswith("/u")}
  # the reference's rule on each stage-1 product's spectrum, one rank a
  # stack (its layers' largest), as its `truncate_leaf` picks it
  want = {}
  for k in ranks:
    w = np.matmul(a1[k + "/u"], a1[k + "/v"])
    want[k] = max(jspec.pick(np.linalg.svd(m, compute_uv=False))
                  for m in w.reshape((-1,) + w.shape[-2:]))
  assert ranks == want
  assert len(ranks) == 7 and ranks["pairs/slstm/rh"] < 64
  # the reference's own transition of the (pairs, heads) `rec` stack (its
  # eager host SVDs, one a head and pair, are this test's cost)
  rh = jcompress.to_stage2({"rh": j1["pairs"]["slstm"]["rh"]}, jplan, jspec)
  assert rh["rh"].u.shape[-1] == ranks["pairs/slstm/rh"]


def test_launch_train_runs_both_stages(capsys):
  """`launch.train --arch xlstm-350m --device cpu --two-stage` end to
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


# ----------------------------------------------------------------------------
# Serving.
# ----------------------------------------------------------------------------

def prompts():
  rng = np.random.RandomState(16)
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
def vanilla(model):
  return serve(engine(model[1]))


@pytest.fixture(scope="module")
def drafts(model):
  """The target's drafts at SANE_RANK and LOW_RANK, built once."""
  return {r: tspec.make_draft_params(model[1], rank=r)
          for r in (SANE_RANK, LOW_RANK)}


def test_engine_greedy_matches_reference_loop(model, vanilla):
  """Each request's greedy tokens from the 2-slot engine (4 requests:
  slots refill mid-run) equal a batch-1 greedy loop over the reference's
  decode_step from a fresh state."""
  jp, _, jc = model
  for prompt, budget, got in zip(prompts(), BUDGETS, vanilla):
    state = jx.init_decode_state(jc, 1, MAX_LEN)
    out = []
    for t in range(len(prompt) + budget - 1):
      tok = prompt[t] if t < len(prompt) else out[-1]
      logits, state = J_DECODE(jp, state, jnp.asarray([[tok]]),
                               jnp.asarray([t]), jc)
      if t >= len(prompt) - 1:
        out.append(int(jnp.argmax(logits[0, -1])))
    assert got == out


@pytest.mark.parametrize("rank", [SANE_RANK, LOW_RANK])
def test_speculative_greedy_equals_vanilla(model, vanilla, drafts, rank):
  """`LMEngine(speculate=2)` greedy emits vanilla greedy's tokens, token
  for token, through the all-carry branch: the full-rank draft takes the
  full-accept fast path, the rank-8 draft the masked replay."""
  params, draft = model[1], drafts[rank]
  assert draft.pairs.slstm.rh is params.pairs.slstm.rh   # 64 wide: kept
  eng = engine(params, speculate=K, draft_params=draft)
  replays = []
  replay = eng._replay
  eng._replay = lambda *a: replays.append(1) or replay(*a)
  assert eng._has_carry
  assert serve(eng) == vanilla
  if rank == SANE_RANK:
    assert eng.accept_rate > 0.5 and len(replays) < 2 * eng.decode_steps
  else:
    assert eng.accept_rate < 0.5 and len(replays) > 0


def test_sampled_speculation_keeps_each_slots_carries(model, drafts):
  """Temperature 0.8 with the rank-8 draft: after every iteration each
  live slot's carries, in the target's state and in the draft's, equal
  its committed tokens fed one step at a time."""
  params = model[1]
  tc = tcfg()
  api = get_model(tc)
  eng = engine(params, speculate=K, draft_params=drafts[LOW_RANK],
               rng=torch.Generator().manual_seed(3))
  axes = api.decode_state_batch_axes(tc)
  step = eng._decode_all_speculative
  checked = []

  def lone(p, slot):
    s = eng._slots[slot]
    state = api.init_decode_state(tc, 1, MAX_LEN, device="cpu")
    with torch.no_grad():
      for t, tok in enumerate(list(s.req.prompt) + s.tokens[:-1]):
        _, state = api.decode_step(p, state, torch.tensor([[tok]]),
                                   torch.tensor([t]), tc)
    return state

  def checked_step(temperature):
    step(temperature)
    for i, s in enumerate(eng._slots):
      if not s.active:
        continue
      for p, state in ((eng.params, eng.state),
                       (eng.draft_params, eng.draft_state)):
        want = lone(p, i)
        for key, leaves in axes.items():
          for leaf, ax in leaves.items():
            close(state[key][leaf].select(ax, i),
                  want[key][leaf].select(ax, 0).numpy(), CARRY_TOL)
      checked.append(len(s.tokens))
  eng._decode_all_speculative = checked_step
  uids = [eng.submit(p, max_new_tokens=n, eos_id=None)
          for p, n in zip(prompts()[:SLOTS], BUDGETS[:SLOTS])]
  fin = eng.run(temperature=0.8)
  assert sorted(f.uid for f in fin) == uids
  assert len(checked) >= 4 and eng.accept_rate < 1.0
