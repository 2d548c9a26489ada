"""GRU and DS2 parity between the port and the reference, on JAX params
carried across by `repro_torch.bridge` (dense, factored and PTQ'd).

Widths: the DS2 smoke config at gru_dims (128, 128, 256), fc 128, f32
(`_torch_parity.SMALL`), where every frame-step GEMM passes the 128-lane
gate, so the reference reaches its Pallas kernels (interpret mode) under
the decode policy. Tolerances: hidden states and log-probs within
atol 1e-4 — f32 throughout, the two frameworks differing only in
summation order and transcendental implementations."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (bridged, jax_cfg, path_arrays,  # noqa: E402
                           torch_cfg)
from repro.core import compress as jcompress  # noqa: E402
from repro.core.svd import TruncationSpec  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.layers import gru as jgru  # noqa: E402
from repro.models import deepspeech as jds  # noqa: E402
from repro.quant import quantize_params as jquantize_params  # noqa: E402
from repro_torch.bridge import from_reference, to_tensor  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.layers import gru as tgru  # noqa: E402
from repro_torch.models import deepspeech as tds  # noqa: E402
from repro_torch.quant import QuantizedLinear, quantize_params  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
  return jds.init_model(jax.random.PRNGKey(0), jax_cfg())


@pytest.fixture(scope="module")
def forms(jparams):
  """The reference params in the three weight forms, and their bridges."""
  plan = jcompress.FactorizationPlan()
  fact = jcompress.to_stage2(jcompress.to_stage1(jparams, plan), plan,
                             TruncationSpec(fixed_rank=128))
  out = {"dense": jparams, "factored": fact,
         "int8": jquantize_params(jparams)}
  return {k: (v, bridged(v)) for k, v in out.items()}


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def gru_in(cfg):
  return ((cfg.feat_dim + 1) // 2 + 1) // 2 * cfg.conv_channels


def close(got, want, atol=ATOL):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                             rtol=0)


@pytest.mark.parametrize("policy", [None, "decode"])
def test_gru_decode_parity(forms, policy):
  jp, tp = forms["dense"]
  x, h = rnd(1, (2, gru_in(jax_cfg()))), rnd(2, (2, 128), 0.5)
  jpol = tpol = None
  if policy:
    jpol, tpol = jdispatch.decode_policy(2), dispatch.decode_policy(2)
  want = jgru.gru_decode(jp["grus"]["gru0"], jnp.asarray(x), jnp.asarray(h),
                         policy=jpol)
  got = tgru.gru_decode(tp.grus["gru0"], torch.from_numpy(x),
                        torch.from_numpy(h), policy=tpol)
  close(got, want)


def test_gru_forward_parity(forms):
  jp, tp = forms["factored"]
  x = rnd(3, (2, 5, 128))
  want = jgru.gru_forward(jp["grus"]["gru1"], jnp.asarray(x))
  got = tgru.gru_forward(tp.grus["gru1"], torch.from_numpy(x))
  close(got, want)


def test_forward_parity_any_length(forms):
  """The full-utterance forward, frontend included, at stride-hostile
  lengths (the asymmetric `conv_time_pads`)."""
  jp, tp = forms["dense"]
  cfg_j, cfg_t = jax_cfg(), torch_cfg()
  for t in (9, 23):
    feats = rnd(t, (2, t, 80))
    want = jds.forward(jp, jnp.asarray(feats), cfg_j)
    got = tds.forward(tp, torch.from_numpy(feats), cfg_t)
    assert got.shape == want.shape
    close(got, want)
  np.testing.assert_array_equal(
      tds.output_lengths(torch.tensor([9, 23, 40]), cfg_t).numpy(),
      np.asarray(jds.output_lengths(jnp.array([9, 23, 40]), cfg_j)))


@pytest.mark.parametrize("form", ["dense", "factored", "int8"])
def test_decode_step_parity(forms, form):
  """One frame step through both packages with the decode policy (the
  reference in interpret mode) and with none; states and log-probs."""
  jp, tp = forms[form]
  cfg_j, cfg_t = jax_cfg(), torch_cfg()
  x = rnd(5, (2, gru_in(cfg_j)), 0.5)
  state_np = {f"gru{i}": rnd(10 + i, (2, h), 0.3)
              for i, h in enumerate(cfg_j.gru_dims)}
  for jpol, tpol in ((None, None),
                     (jdispatch.decode_policy(2), dispatch.decode_policy(2))):
    want, wstate = jds.decode_step(
        jp, {k: jnp.asarray(v) for k, v in state_np.items()},
        jnp.asarray(x), cfg_j, policy=jpol)
    got, gstate = tds.decode_step(
        tp, {k: torch.from_numpy(v) for k, v in state_np.items()},
        torch.from_numpy(x), cfg_t, policy=tpol)
    close(got, want)
    for k in wstate:
      close(gstate[k], wstate[k])


def test_bridge_structure_and_ptq_bitwise(forms):
  """Bridged params carry the reference's paths as state_dict keys, and
  the port's PTQ of the bridged float params equals the bridged PTQ'd
  params bit for bit."""
  jp, tp = forms["dense"]
  want_keys = {k.replace("/", ".") for k in path_arrays(jp)}
  assert set(tp.state_dict()) == want_keys
  assert "grus.gru0.nonrec.w" in want_keys
  assert tp.grus["gru1"].rec.name == "gru1/rec"
  assert tp.grus["gru1"].rec.group == "rec"
  assert tp.out.name == "out" and tp.fc.group == "nonrec"
  assert tp.fc.u is None and forms["factored"][1].fc.u.shape[-1] == 128

  jq, tq = forms["int8"]
  assert isinstance(tq.out, QuantizedLinear)
  mine = quantize_params(tp).state_dict()
  theirs = tq.state_dict()
  assert set(mine) == set(theirs)
  for k in theirs:
    assert torch.equal(mine[k], theirs[k]), k


def test_bridge_bf16_both_encodings(jparams):
  """bf16 arrives as ml_dtypes.bfloat16 or as a uint16 view plus its
  dtype string; both carry the same bits."""
  arrays = path_arrays(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                    jparams))
  viewed = {k: v.view(np.uint16) if str(v.dtype) == "bfloat16" else v
            for k, v in arrays.items()}
  dtypes = {k: "bfloat16" for k, v in arrays.items()
            if str(v.dtype) == "bfloat16"}
  cfg = torch_cfg().with_(dtype=torch.bfloat16)
  a = from_reference(arrays, cfg, device="cpu").state_dict()
  b = from_reference(viewed, cfg, dtypes=dtypes, device="cpu").state_dict()
  w = arrays["grus/gru0/rec/w"]
  assert a["grus.gru0.rec.w"].dtype == torch.bfloat16
  np.testing.assert_array_equal(a["grus.gru0.rec.w"].float().numpy(),
                                w.astype(np.float32))
  for k in a:
    assert torch.equal(a[k], b[k]), k
  assert to_tensor(np.arange(3, dtype=np.int8)).dtype == torch.int8


def test_bridge_rejects_unknown_and_missing_keys(jparams):
  arrays = path_arrays(jparams)
  with pytest.raises(KeyError, match="unused"):
    from_reference({**arrays, "extra": np.zeros(1, np.float32)}, torch_cfg(),
                   device="cpu")
  arrays.pop("grus/gru2/bias")
  with pytest.raises(KeyError, match="missing"):
    from_reference(arrays, torch_cfg(), device="cpu")


def test_model_api_decode_step_and_slot_surgery(forms):
  """`get_model` for DS2: the ModelApi frame step is `decode_step` with a
  (b, 1, ...) time axis, and `insert_slot` writes batch row `slot`."""
  from repro_torch.models.api import get_model
  cfg = torch_cfg()
  api = get_model(cfg)
  params = forms["dense"][1]
  state = api.init_decode_state(cfg, 2, device="cpu")
  x = torch.from_numpy(np.random.RandomState(0).randn(
      2, 1, params.grus["gru0"].nonrec.in_dim).astype(np.float32))
  lp, new = api.decode_step(params, state, x, torch.zeros(2), cfg)
  want, want_state = tds.decode_step(params, state, x[:, 0], cfg)
  assert lp.shape == (2, 1, cfg.vocab_size)
  assert torch.equal(lp[:, 0], want)
  one = {k: v[1:] for k, v in want_state.items()}
  assert api.insert_slot(cfg, state, one, 0) is state
  for k, v in state.items():
    assert torch.equal(v[0], want_state[k][1]) and not v[1].any()
