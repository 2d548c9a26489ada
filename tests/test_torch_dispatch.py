"""The port's `kernels.dispatch` against the reference's: `classify`
returns the same regime for the shapes tests/test_dispatch.py pins, for
dense, factored and quantized leaves. (The routing log of a whole frame
step is compared in tests/test_torch_serving.py, where both servers
run.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.factored import dense as jdense  # noqa: E402
from repro.core.factored import factored as jfactored  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.quant import quantize_leaf as jquantize_leaf  # noqa: E402
from repro_torch.core.factored import FactoredLinear  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.layers.common import gemm  # noqa: E402
from repro_torch.quant import QuantizedLinear, quantize_leaf  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


KEY = jax.random.PRNGKey(0)


def t(a):
  return None if a is None else torch.from_numpy(np.array(a))


def port_leaf(jleaf):
  """The port's counterpart of a reference leaf (same arrays)."""
  if hasattr(jleaf, "w_q"):
    return QuantizedLinear(w_q=t(jleaf.w_q), w_scale=t(jleaf.w_scale),
                           u_q=t(jleaf.u_q), u_scale=t(jleaf.u_scale),
                           v_q=t(jleaf.v_q), v_scale=t(jleaf.v_scale),
                           name=jleaf.name, group=jleaf.group)
  return FactoredLinear(w=t(jleaf.w), u=t(jleaf.u), v=t(jleaf.v),
                        name=jleaf.name, group=jleaf.group)


def policies(batch, window=1, overrides=()):
  return (jdispatch.decode_policy(batch, window=window, overrides=overrides),
          dispatch.decode_policy(batch, window=window, overrides=overrides))


def leaf_of(kind, m, n, name):
  if kind == "dense":
    return jdense(KEY, m, n, name=name)
  if kind == "factored":
    return jfactored(KEY, m, n, r=128, name=name)
  return jquantize_leaf(jdense(KEY, m, n, name=name))


#: (decode batch, window, overrides, leaf kind, m, n, x rows, name) — the
#: cases tests/test_dispatch.py pins, each in the three weight forms
CASES = [
    (8, 1, (), "dense", 128, 256, 4, "fc"),
    (8, 1, (), "dense", 128, 256, 64, "fc"),
    (8, 1, (), "factored", 128, 256, 4, "lr"),
    (8, 1, (), "factored", 128, 256, 64, "lr"),
    (8, 1, (), "dense", 64, 32, 4, "tiny"),
    (8, 1, (), "quantized", 128, 256, 4, "fc"),
    (8, 1, (), "quantized", 64, 32, 64, "tiny"),
    (4, 1, (("*/rec", "jnp"), ("fc", "int8_gemm")), "dense", 128, 384, 2,
     "gru0/rec"),
    (4, 1, (("*/rec", "jnp"), ("fc", "int8_gemm")), "dense", 128, 256, 2,
     "fc"),
    (4, 1, (("*/rec", "gru_cell"),), "dense", 128, 384, 2, "gru0/rec"),
    (4, 1, (("*/rec", "gru_cell"),), "factored", 128, 384, 2, "gru1/rec"),
    (4, 1, (("*", "jnp"),), "quantized", 128, 256, 2, "fc"),
    (2, 3, (), "dense", 192, 256, 6, "fc"),
    (2, 3, (), "dense", 192, 256, 7, "fc"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[3]}-{c[7]}-{c[6]}")
def test_classify_matches_reference(case):
  batch, window, overrides, kind, m, n, rows, name = case
  jpol, tpol = policies(batch, window, overrides)
  jleaf = leaf_of(kind, m, n, name)
  x = np.random.RandomState(rows).randn(rows, m).astype(np.float32)
  want = jdispatch.classify(jleaf, jnp.asarray(x), jpol)
  leaf = port_leaf(jleaf)
  assert dispatch.classify(leaf, torch.from_numpy(x), tpol) == want
  for jp, tp in ((None, None), (jdispatch.JNP_ONLY, dispatch.JNP_ONLY)):
    assert dispatch.classify(leaf, torch.from_numpy(x), tp) == \
        jdispatch.classify(jleaf, jnp.asarray(x), jp) == "jnp"


def test_policy_surface_matches_reference():
  for args in ((2, 3), (4, 4), (8, 4), (4, 1)):
    assert dispatch.decode_policy(args[0], window=args[1]).decode_batch_max \
        == jdispatch.decode_policy(args[0], window=args[1]).decode_batch_max
  assert dispatch.resolve_policy("cuda", 2, window=3) == \
      dispatch.decode_policy(2, window=3)
  assert dispatch.resolve_policy("plain") is dispatch.JNP_ONLY
  with pytest.raises(ValueError):
    dispatch.KernelPolicy(mode="decode", overrides=(("x", "nonsense"),))
  with pytest.raises(ValueError):
    dispatch.KernelPolicy(mode="bogus")
  with pytest.raises(ValueError):
    dispatch.KernelPolicy(mode="decode", decode_batch_max=17)


def test_jnp_only_policy_is_bit_exact():
  """KernelPolicy() reproduces the no-policy path exactly."""
  rng = np.random.RandomState(0)
  x = torch.from_numpy(rng.randn(8, 96).astype(np.float32))
  for jleaf in (jdense(KEY, 96, 160, name="w"),
                jfactored(KEY, 96, 160, r=64, name="uv")):
    leaf = port_leaf(jleaf)
    assert torch.equal(gemm(leaf, x), gemm(leaf, x, dispatch.JNP_ONLY))


def test_port_quantize_leaf_matches_reference_bitwise():
  jleaf = jfactored(KEY, 160, 384, r=128, name="gru0/nonrec")
  got, want = quantize_leaf(port_leaf(jleaf)), jquantize_leaf(jleaf)
  for field in ("u_q", "u_scale", "v_q", "v_scale"):
    np.testing.assert_array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(want, field)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 80, 112, 128])
def test_flash_predicate_declines_where_the_kernel_refuses(d, dtype):
  """The routing predicate beside HEAD_DIMS: head widths 64, 80
  (stablelm-3b), 112 (zamba2-7b) and 128 only.
  Where an operand starts does not enter it: the wrapper copies a bf16
  operand off a 16-byte boundary (here one element into its storage) and
  a non-contiguous one into a fresh buffer."""
  from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_supported
  assert HEAD_DIMS == (64, 80, 112, 128)
  want = d in HEAD_DIMS
  n = 2 * 8 * 2 * d
  q = torch.zeros(n + 1, dtype=dtype)[1:].view(2, 8, 2, d)
  k = v = torch.zeros((2, 8, 2, d), dtype=dtype)
  assert flash_supported(k, k, v) is want
  assert flash_supported(q, k, v) is want
  assert flash_supported(k, k, q) is want
  assert flash_supported(q.transpose(1, 2), k, v) is want


@pytest.mark.parametrize("d", [16, 96])
def test_maybe_flash_attention_records_nothing_when_it_declines(d):
  q = torch.zeros((1, 8, 4, d), dtype=torch.bfloat16)
  k = v = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
  with dispatch.record_dispatch() as log:
    out = dispatch.maybe_flash_attention(q, k, v, dispatch.resolve_policy(
        "cuda"), name="layers/attn")
  assert out is None and log == []


def test_maybe_flash_attention_routes_supported_operands():
  q = torch.zeros((1, 8, 4, 64))
  k = v = torch.zeros((1, 8, 2, 64))
  with dispatch.record_dispatch() as log:
    out = dispatch.maybe_flash_attention(q, k, v, dispatch.resolve_policy(
        "cuda"), name="layers/attn")
  assert out is not None and log == [("layers/attn", "flash_attention")]
