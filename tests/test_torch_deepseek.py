"""The DeepSeek family of the port against the reference, on the CPU at
the two SMOKE configs in f32: `deepseek-v2-lite` (dense q projection,
no MTP) and `deepseek-v3-671b` (q-LoRA 48, MTP head), 1 dense + 2 or 3
MoE layers, d 128, 8 experts top-2 with one shared, with the port's
seeded weights carried into the reference's tree
(`_torch_parity.reference_tree`) and inputs drawn with numpy: the MoE
layer (groups, capacity drops, a 16-row decode batch that overflows an
expert), MLA (prefill, absorbed decode, window), the whole model's
forward and aux loss, decode steps and windows, the bridge and
checkpoints both ways, and a PTQ'd tree.

Routing: `torch.topk` promises no order among exactly tied
probabilities, `jax.lax.top_k` puts them in index order. The inputs are
continuous draws, so no two router probabilities tie exactly and the
routes must be equal.

Tolerances: layers and whole models at 1e-4 (f32, summation order in the
GEMMs, the einsums and the blockwise softmax, as `test_torch_lm.py`);
routes, keep masks, configs and bridged leaves exactly; the aux loss at
1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays, reference_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.layers import mla as jmla  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.quant import quantize_params as jquantize  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.layers import mla, moe  # noqa: E402
from repro_torch.layers.common import ModelConfig  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.quant import QuantizedLinear, quantize_params  # noqa: E402

ARCHS = ["deepseek-v2-lite", "deepseek-v3-671b"]
TOL = dict(atol=1e-4, rtol=1e-4)

# the reference's functions, jitted once with their config static (run
# eagerly, each of their scans would be traced and compiled anew)
J_FORWARD = jax.jit(jtf.forward, static_argnums=2)
J_DECODE = jax.jit(jtf.decode_step, static_argnums=4)
J_WINDOW = jax.jit(jtf.decode_window, static_argnums=4)
J_MOE = jax.jit(jmoe.moe_forward, static_argnums=2)
J_ROUTE = jax.jit(jmoe._route, static_argnums=2)
J_DISPATCH = jax.jit(jmoe._dispatch_one_group, static_argnums=(3, 4, 5))
J_MLA = jax.jit(jmla.mla_forward, static_argnums=2)
J_MLA_DECODE = jax.jit(jmla.mla_decode, static_argnums=4)
J_MLA_WINDOW = jax.jit(jmla.mla_decode_window, static_argnums=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def jcfg(arch, **moe_kw):
  cfg = jconfigs.get_smoke(arch).with_(dtype=jnp.float32)
  return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw))


def tcfg(arch, **moe_kw):
  cfg = tconfigs.get_smoke(arch).with_(dtype=torch.float32)
  return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw))


@pytest.fixture(scope="module")
def models():
  """{arch: (reference params, port params)}: the port's init from a
  seeded CPU generator, carried into the reference's tree (no JAX init
  is compiled or run)."""
  out = {}
  for arch in ARCHS:
    tp = transformer.init_lm(tcfg(arch), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    out[arch] = reference_tree(tp, lambda k, a=arch: jtf.init_lm(
        k, jcfg(a))), tp
  return out


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def tokens(seed, shape, vocab=512):
  return np.random.RandomState(seed).randint(1, vocab, size=shape)


def close(got, want, tol=TOL):
  if isinstance(got, torch.Tensor):
    got = got.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(want), **tol)


def layer0(jp, tp, stack: str):
  """Layer 0 of a stack: the reference's slice and the port's view."""
  return (jax.tree.map(lambda a: a[0], jp[stack]),
          getattr(tp, stack).layers()[0])


# ----------------------------------------------------------------------------
# Configs.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
  """Every field of the port's config equals the reference's, the MoE
  and MLA sub-configs field by field, full and smoke."""
  names = [f.name for f in dataclasses.fields(ModelConfig)
           if f.name not in ("dtype", "moe", "mla")]
  for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                       (tconfigs.get_smoke, jconfigs.get_smoke)):
    t, j = get_t(arch), get_j(arch)
    assert {n: getattr(t, n) for n in names} == \
        {n: getattr(j, n) for n in names}
    for sub in ("moe", "mla"):
      assert dataclasses.asdict(getattr(t, sub)) == \
          dataclasses.asdict(getattr(j, sub))
  assert arch in tconfigs.ARCH_NAMES
  transformer.check_supported(tconfigs.get_config(arch))


# ----------------------------------------------------------------------------
# MoE.
# ----------------------------------------------------------------------------

MOE_CASES = {
    # (dispatch_groups, capacity_factor, x shape (b, s), rows near one point)
    "g1": (1, 1.25, (2, 32), False),
    "g2": (2, 1.25, (2, 32), False),
    "g1_drops": (1, 0.05, (2, 32), False),
    "g2_drops": (2, 0.05, (2, 32), False),
    "decode16_overflow": (1, 1.25, (16, 1), True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(models, arch, case):
  """One MoE layer: equal routes and keep masks group by group, the aux
  loss and the output. With capacity_factor 0.05 every group drops
  entries; the 16-row decode batch (rows near one point) sends more than
  the 8 slots' worth of rows to one expert, which drops the rest."""
  groups, cf, (b, s), clustered = MOE_CASES[case]
  jp, tp = models[arch]
  jl, tl = layer0(jp, tp, "moe_layers")
  jc, tc = (jcfg(arch, dispatch_groups=groups, capacity_factor=cf),
            tcfg(arch, dispatch_groups=groups, capacity_factor=cf))
  x = rnd(1, (b, s, 128))
  if clustered:
    x = rnd(2, (1, 1, 128)) + 0.05 * x
  want_y, want_aux = J_MOE(jl["moe"], jnp.asarray(x), jc)
  with torch.no_grad():
    got_y, got_aux = moe.moe_forward(tl["moe"], torch.as_tensor(x), tc)
  close(got_y, want_y)
  np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)

  m = tc.moe
  tg = b * s // groups
  cap = moe.capacity(m, tg)
  assert cap == max(8, (int(cf * tg * m.top_k / m.num_experts) + 7) // 8 * 8)
  xg = x.reshape(groups, tg, 128)
  topw, tope, _ = moe._route(tl["moe"]["router"], torch.as_tensor(xg), m)
  _, (_, _, _, keep) = moe._dispatch(torch.as_tensor(xg), tope, m, cap)
  drops = 0
  for g in range(groups):
    jw, je, _ = J_ROUTE(jl["moe"]["router"], jnp.asarray(xg[g]), jc.moe)
    _, (_, _, jkeep) = J_DISPATCH(
        jnp.asarray(xg[g]), jw, je, jc.moe, cap, jnp.float32)
    np.testing.assert_array_equal(tope[g].numpy(), np.asarray(je))
    close(topw[g], jw)
    np.testing.assert_array_equal(keep[g].numpy(), np.asarray(jkeep))
    drops += int((~keep[g]).sum())
  if cf < 1 or clustered:
    assert drops > 0


def test_moe_route_replay_takes_the_recorded_experts(models):
  """`replay_routes`: a call replaying its own log gives its own output;
  a call on other inputs replaying that log routes every token to the
  recorded experts, weighted by its own probabilities; a call past the
  log raises."""
  jp, tp = models["deepseek-v2-lite"]
  _, tl = layer0(jp, tp, "moe_layers")
  cfg = tcfg("deepseek-v2-lite")
  x = torch.as_tensor(rnd(3, (2, 8, 128)))
  y = torch.as_tensor(rnd(4, (2, 8, 128)))
  with torch.no_grad():
    with moe.record_routes() as log:
      want, want_aux = moe.moe_forward(tl["moe"], x, cfg)
    with moe.replay_routes(log):
      got, aux = moe.moe_forward(tl["moe"], x, cfg)
    close(got, want.numpy(), dict(atol=0, rtol=0))
    assert float(aux) == float(want_aux)
    with moe.record_routes() as other, moe.replay_routes(log):
      moe.moe_forward(tl["moe"], y, cfg)
      with pytest.raises(RuntimeError, match="more MoE calls"):
        moe.moe_forward(tl["moe"], y, cfg)
  np.testing.assert_array_equal(other[0]["experts"], log[0]["experts"])


def test_moe_route_log_records_margins_and_changes_nothing(models):
  jp, tp = models["deepseek-v2-lite"]
  _, tl = layer0(jp, tp, "moe_layers")
  cfg = tcfg("deepseek-v2-lite")
  x = torch.as_tensor(rnd(3, (2, 8, 128)))
  with torch.no_grad():
    plain, _ = moe.moe_forward(tl["moe"], x, cfg)
    with moe.record_routes() as log:
      logged, _ = moe.moe_forward(tl["moe"], x, cfg)
  assert torch.equal(plain, logged) and len(log) == 1
  logits = x.reshape(-1, 128) @ tl["moe"]["router"]
  probs = torch.softmax(logits, -1)
  top = torch.topk(probs, 3, -1)
  np.testing.assert_array_equal(log[0]["experts"], top.indices[:, :2])
  close(log[0]["margin"], (top.values[:, 1] - top.values[:, 2]).numpy(),
        dict(atol=1e-6, rtol=1e-5))
  close(log[0]["logits"], logits.numpy(), dict(atol=1e-5, rtol=1e-5))


# ----------------------------------------------------------------------------
# MLA.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_mla_matches_reference(models, arch):
  """Prefill (the blockwise softmax over 2 x 2 blocks), 3 absorbed decode
  steps after it, and a 3-token window from the same cache: outputs and
  latent caches."""
  jp, tp = models[arch]
  jl, tl = layer0(jp, tp, "dense_layers")
  jc, tc = jcfg(arch), tcfg(arch)
  x = rnd(4, (2, 64, 128))
  want = J_MLA(jl["attn"], jnp.asarray(x), jc)
  with torch.no_grad():
    got = mla.mla_forward(tl["attn"], torch.as_tensor(x), tc)
  close(got, want)

  b, max_len = 2, 12
  jcache = jmla.init_mla_cache(jc, b, max_len)
  tcache = mla.init_mla_cache(tc, b, max_len)
  xs = rnd(5, (b, 6, 128))
  for t in range(3):
    pos = np.array([t, t + 2])
    want, jcache = J_MLA_DECODE(jl["attn"], jnp.asarray(xs[:, t:t + 1]),
                                   jcache, jnp.asarray(pos), jc)
    with torch.no_grad():
      got, tcache = mla.mla_decode(tl["attn"], torch.as_tensor(xs[:, t:t + 1]),
                                   tcache, torch.as_tensor(pos), tc)
    close(got, want)
  pos = np.array([3, 5])
  want, jcache = J_MLA_WINDOW(jl["attn"], jnp.asarray(xs[:, 3:]),
                                        jcache, jnp.asarray(pos), jc)
  with torch.no_grad():
    got, tcache = mla.mla_decode_window(tl["attn"], torch.as_tensor(xs[:, 3:]),
                                        tcache, torch.as_tensor(pos), tc)
  close(got, want)
  for k in ("c_kv", "k_rope"):
    close(tcache[k], jcache[k])


def test_mla_blocks_must_divide_the_sequence(models):
  jp, tp = models["deepseek-v2-lite"]
  _, tl = layer0(jp, tp, "dense_layers")
  x = torch.zeros(1, 48, 128)
  with pytest.raises(ValueError, match="attn_block_q=32, attn_block_kv=32"):
    mla.mla_forward(tl["attn"], x, tcfg("deepseek-v2-lite"))
  out = mla.mla_forward(tl["attn"], x, tcfg("deepseek-v2-lite").with_(
      attn_block_q=16, attn_block_kv=48))
  assert out.shape == (1, 48, 128)


# ----------------------------------------------------------------------------
# The model.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(models, arch):
  jp, tp = models[arch]
  toks = tokens(6, (2, 64))
  want, want_aux = J_FORWARD(jp, jnp.asarray(toks), jcfg(arch))
  with torch.no_grad():
    got, aux = transformer.forward_with_aux(tp, torch.as_tensor(toks),
                                            tcfg(arch))
    last = transformer.forward(tp, torch.as_tensor(toks), tcfg(arch),
                               last_only=True)
  close(got, want)
  close(last, np.asarray(want)[:, -1:])
  np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
  assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_window_match_reference(models, arch):
  """4 decode steps at staggered positions, then (from fresh states) the
  same 4 tokens as one window: logits and both stacks' latent caches.
  The window's 2 x 4 rows cannot send more than 8 rows to an expert (8
  slots at least), so it equals the steps; a wider window could drop
  entries the steps keep (the reference's capacity rule)."""
  jp, tp = models[arch]
  jc, tc = jcfg(arch), tcfg(arch)
  api = get_model(tc)
  b, max_len = 2, 16
  toks = tokens(7, (b, 4))
  start = np.array([0, 3])
  js = jtf.init_decode_state(jc, b, max_len)
  ts = api.init_decode_state(tc, b, max_len, device="cpu")
  assert set(ts) == {"dense", "moe"} and set(ts["moe"]) == {"c_kv",
                                                            "k_rope"}
  steps = []
  with torch.no_grad():
    for t in range(4):
      pos = start + t
      want, js = J_DECODE(jp, js, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos), jc)
      got, ts = api.decode_step(tp, ts, torch.as_tensor(toks[:, t:t + 1]),
                                torch.as_tensor(pos), tc)
      close(got, want)
      steps.append(got[:, 0])
    for key in ("dense", "moe"):
      for k in ("c_kv", "k_rope"):
        close(ts[key][k], js[key][k])
    jw = jtf.init_decode_state(jc, b, max_len)
    want, jw = J_WINDOW(jp, jw, jnp.asarray(toks),
                                 jnp.asarray(start), jc)
    tw = api.init_decode_state(tc, b, max_len, device="cpu")
    got, tw = api.decode_window(tp, tw, torch.as_tensor(toks),
                                torch.as_tensor(start), tc)
  close(got, want)
  close(got, torch.stack(steps, 1).numpy())
  for k in ("c_kv", "k_rope"):
    close(tw["moe"][k], ts["moe"][k])


def test_api_slot_surgery_covers_both_stacks():
  cfg = tcfg("deepseek-v3-671b")
  api = get_model(cfg)
  assert api.decode_state_batch_axes(cfg) == {
      "dense": {"c_kv": 1, "k_rope": 1}, "moe": {"c_kv": 1, "k_rope": 1}}
  assert not any(v for d in api.decode_state_carry(cfg).values()
                 for v in d.values())
  state = api.init_decode_state(cfg, 3, 8, device="cpu")
  one = api.init_decode_state(cfg, 1, 8, device="cpu")
  one["moe"]["c_kv"].fill_(2.0)
  api.insert_slot(cfg, state, one, 1)
  assert state["moe"]["c_kv"].shape == (3, 3, 8, 32)
  assert torch.equal(state["moe"]["c_kv"][:, 1], one["moe"]["c_kv"][:, 0])
  assert not state["moe"]["c_kv"][:, [0, 2]].any()


# ----------------------------------------------------------------------------
# Bridge, checkpoints and PTQ.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_bit_for_bit(models, arch):
  """The router (raw f32 (L, d, E)), the (L, E, m, n) expert stacks, the
  shared experts, MLA's leaves and the unstacked MTP head keep the
  reference's paths and bits, both ways; names follow the reference's."""
  jp, tp = models[arch]
  want = path_arrays(jp)
  got = bridge.to_reference(tp)
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  assert got["moe_layers/moe/router"].shape == (
      tcfg(arch).num_layers - 1, 128, 8)
  assert got["moe_layers/moe/w_gate/w"].shape[1:] == (8, 128, 64)
  assert tp.moe_layers.moe.shared.w_gate.name == "layers/shared/ffn_gate"
  assert tp.moe_layers.moe.w_down.name == "layers/expert_down"
  if arch == "deepseek-v3-671b":
    assert got["mtp/layer/attn/wq_a/w"].ndim == 2
    assert tp.mtp.layer.attn.wq_b.name == "layers/mla_q_b"
    assert tp.mtp.proj.name == "mtp/proj"
  missing = {k: v for k, v in want.items() if k != "moe_layers/moe/router"}
  with pytest.raises(KeyError, match="router"):
    bridge.from_reference(missing, tcfg(arch), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_load_across_packages(models, arch, tmp_path):
  """A reference checkpoint loads into the port (`load_checkpoint`) and
  a port checkpoint restores into the reference's own tree, bit for
  bit."""
  jp, tp = models[arch]
  want = path_arrays(jp)
  JManager(str(tmp_path / "ref")).save(0, {"params": jp})
  loaded = bridge.to_reference(bridge.load_checkpoint(
      str(tmp_path / "ref"), tcfg(arch), device="cpu"))
  CheckpointManager(str(tmp_path / "port")).save(0, {"params": tp})
  tree, _ = JManager(str(tmp_path / "port")).restore({"params": jp})
  back = path_arrays(tree["params"])
  for k, v in want.items():
    np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_quantized_tree_matches_reference(models):
  """PTQ of the whole tree: the expert stacks and w_uk / w_uv become
  QuantizedLinear leaves that the MoE and the absorbed decode use
  through `product()` (the dequantized W); the other GEMMs run the w8a8
  path. The port's int8 leaves, carried into the reference's PTQ'd tree
  (its own quantization, jitted, may round a few entries the other
  way), give the same forward and decode step there within 1e-4, and
  `product()` equals the reference's exactly."""
  arch = "deepseek-v3-671b"
  jp, tp = models[arch]
  jc, tc = jcfg(arch), tcfg(arch)
  tq = quantize_params(tp)
  jq = reference_tree(tq, lambda k: jquantize(jtf.init_lm(k, jc)))
  experts = tq.moe_layers.moe.w_up
  assert isinstance(experts, QuantizedLinear)
  assert isinstance(tq.dense_layers.attn.w_uk, QuantizedLinear)
  assert experts.w_q.shape == (3, 8, 128, 64)
  for got, want in ((experts, jq["moe_layers"]["moe"]["w_up"]),
                    (tq.dense_layers.attn.w_uk,
                     jq["dense_layers"]["attn"]["w_uk"])):
    close(got.product(), want.product(), dict(atol=0, rtol=0))
  toks = tokens(8, (2, 32))
  want, _ = J_FORWARD(jq, jnp.asarray(toks), jc)
  with torch.no_grad():
    got = transformer.forward(tq, torch.as_tensor(toks), tc)
  close(got, want)
  js = jtf.init_decode_state(jc, 2, 8)
  ts = transformer.init_decode_state(tc, 2, 8, device="cpu")
  want, _ = J_DECODE(jq, js, jnp.asarray(toks[:, :1]),
                     jnp.zeros((2,), jnp.int32), jc)
  with torch.no_grad():
    got, _ = transformer.decode_step(tq, ts, torch.as_tensor(toks[:, :1]),
                                     torch.zeros(2, dtype=torch.long), tc)
  close(got, want)
