"""The port's cost ledger (`repro_torch.dist.hlo_cost`) and the op walk's
trace it reads: the reference's counting rules on the same shapes, a
loop counted per iteration, kernel scopes, what cannot be accounted, and
the memory ledger's inputs and donation credit.

The reference's cost parser undercounts dots on this JAX
(`tests/test_hlo_cost.py`), so the rules are held against its helpers
(`_dot_flops`, `_conv_flops`, `_wire_factor`, `_shape_bytes`) on
hand-written HLO instruction lines and shapes, which parse alike on
every JAX.
"""
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")

from repro.dist import hlo_cost as jcost  # noqa: E402
from repro_torch.analysis import liveness  # noqa: E402
from repro_torch.analysis.op_walk import OpWalk  # noqa: E402
from repro_torch.core.factored import FactoredLinear  # noqa: E402
from repro_torch.dist import hlo_cost  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.layers.gru import gru_cell  # noqa: E402
from repro_torch.quant.ptq import quantize_leaf  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(1):
    yield
  torch.set_num_threads(threads)


def walked(fn):
  walk = OpWalk([], keep_trace=True)
  with torch.no_grad(), walk:
    out = fn()
  return out, walk


def cost(fn) -> hlo_cost.CostReport:
  return hlo_cost.analyze_walk(walked(fn)[1].result.trace)


@pytest.mark.parametrize("line, out, lhs, contract", [
    ("%d = f32[32,16]{1,0} dot(f32[32,128]{1,0} %a, f32[128,16]{1,0} %b), "
     "lhs_contracting_dims={1}, rhs_contracting_dims={0}",
     (32, 16), (32, 128), (1,)),
    ("%d = bf16[4,8,16]{2,1,0} dot(bf16[4,8,32]{2,1,0} %a, "
     "bf16[4,32,16]{2,1,0} %b), lhs_batch_dims={0}, "
     "lhs_contracting_dims={2}, rhs_batch_dims={0}, "
     "rhs_contracting_dims={1}", (4, 8, 16), (4, 8, 32), (2,)),
    ("%d = f32[2,3]{1,0} dot(f32[5,2,7]{2,1,0} %a, f32[5,7,3]{2,1,0} %b), "
     "lhs_contracting_dims={0,2}, rhs_contracting_dims={0,1}",
     (2, 3), (5, 2, 7), (0, 2)),
])
def test_dot_rule_is_the_reference_rule(line, out, lhs, contract):
  want = jcost._dot_flops(jcost._split_instr(line))
  assert hlo_cost.dot_flops(out, lhs, contract) == want


def test_conv_rule_is_the_reference_rule_and_the_walk_counts_it():
  line = ("%c = f32[2,8,8,16]{3,2,1,0} convolution(f32[2,8,8,4]{3,2,1,0} "
          "%x, f32[3,3,4,16]{3,2,1,0} %w), window={size=3x3 pad=1_1x1_1}, "
          "dim_labels=b01f_01io->b01f")
  want = jcost._conv_flops(jcost._split_instr(line))
  # the same convolution in torch's layouts: NCHW input, OIHW kernel
  assert hlo_cost.conv_flops((2, 16, 8, 8), (16, 4, 3, 3)) == want
  x, w = torch.randn(2, 4, 8, 8), torch.randn(16, 4, 3, 3)
  rep = cost(lambda: torch.nn.functional.conv2d(x, w, padding=1))
  assert rep.flops == want and rep.dot_flops == 0


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [1, 2, 4, 16, 256])
def test_wire_factor_is_the_reference_rule(kind, n):
  assert hlo_cost._wire_factor(kind, n) == jcost._wire_factor(kind, n)


@pytest.mark.parametrize("shape, arrays", [
    ("bf16[4,8]{1,0}", [((4, 8), torch.bfloat16)]),
    ("f32[]", [((), torch.float32)]),
    ("(f32[2,2]{1,0}, s8[4]{0})", [((2, 2), torch.float32),
                                   ((4,), torch.int8)]),
    ("pred[16]", [((16,), torch.bool)]),
    ("s4[4,8]{1,0}", [((4, 8), torch.int4)]),
    ("s4[5]{0}", [((5,), torch.int4)]),
    ("u4[3]{0}", [((3,), torch.uint4)]),
    ("(s4[5]{0}, s4[5]{0})", [((5,), torch.int4), ((5,), torch.int4)]),
    ("(bf16[3]{0}, s4[7]{0})", [((3,), torch.bfloat16),
                                ((7,), torch.int4)])])
def test_shape_bytes_is_the_reference_rule(shape, arrays):
  """Each array rounds up to whole bytes on its own: s4[5] is 3 bytes."""
  got = sum(hlo_cost.array_bytes(s, d) for s, d in arrays)
  assert got == jcost._shape_bytes(shape)


def test_a_loop_counts_every_iteration():
  """The reference multiplies a scanned body by its trip count; the walk
  sees the eager loop unrolled."""
  w, x = torch.randn(64, 64), torch.randn(8, 64)

  def five():
    h = x
    for _ in range(5):
      h = h @ w
    return h
  rep = cost(five)
  assert rep.flops == rep.dot_flops == 5 * 2 * 8 * 64 * 64
  # each mm reads its operands and writes its result, in f32
  assert rep.hbm_bytes == 5 * 4 * (8 * 64 + 64 * 64 + 8 * 64)
  assert rep.unknown_ops == {}


def _leaves():
  g = torch.Generator().manual_seed(0)
  dense = FactoredLinear(w=torch.randn(256, 384, generator=g), name="d")
  low = FactoredLinear(u=torch.randn(256, 128, generator=g),
                       v=torch.randn(128, 384, generator=g), name="l")
  return {"decode_matvec": dense, "lowrank_gemm": low,
          "int8_gemm": quantize_leaf(dense)}


@pytest.mark.parametrize("regime", ["decode_matvec", "lowrank_gemm",
                                    "int8_gemm"])
def test_a_kernel_scope_counts_its_products(regime):
  """A kernel scope is one op of the ledger, its FLOPs the products its
  plain version computes: the same under "jnp" and "pallas"."""
  leaf = _leaves()[regime]
  x = torch.randn(2, 256)
  reps = {}
  for policy in ("jnp", "pallas"):
    pol = dispatch.JNP_ONLY if policy == "jnp" else dispatch.decode_policy(2)
    _, walk = walked(lambda: dispatch.gemm(leaf, x, pol))
    reps[policy] = hlo_cost.analyze_walk(walk.result.trace)
    if policy == "pallas":
      assert walk.log[0].regime == regime
      (rec,) = [r for r in walk.result.trace if r.ns == "scope"]
      assert rec.op.startswith(f"dispatch:{regime}:c")
  want = (2 * 2 * (256 * 128 + 128 * 384) if regime == "lowrank_gemm"
          else 2 * 2 * 256 * 384)
  assert reps["jnp"].dot_flops == reps["pallas"].dot_flops == want


def test_a_gru_cell_scope_counts_h_at_u():
  hidden, b = 128, 2
  g = torch.Generator().manual_seed(1)
  rec = FactoredLinear(w=torch.randn(hidden, 3 * hidden, generator=g),
                       name="rec")
  xw, h = torch.randn(b, 3 * hidden), torch.randn(b, hidden)
  bias = torch.zeros(3 * hidden)
  flops = {}
  for policy in ("jnp", "pallas"):
    pol = dispatch.JNP_ONLY if policy == "jnp" else dispatch.decode_policy(b)
    flops[policy] = cost(
        lambda: gru_cell(xw, h, rec, bias, hidden, pol)).dot_flops
  assert flops["jnp"] == flops["pallas"] == 2 * b * hidden * 3 * hidden


def test_the_ops_inside_a_kernel_scope_are_not_traced():
  leaf = _leaves()["decode_matvec"]
  x = torch.randn(2, 256)
  _, walk = walked(lambda: dispatch.gemm(leaf, x, dispatch.decode_policy(2)))
  assert [r.ns for r in walk.result.trace] == ["scope"]
  (rec,) = walk.result.trace
  assert dict(rec.fields) == {"x": (2, 256), "w": (256, 384)}
  assert rec.in_bytes == 4 * (2 * 256 + 256 * 384)
  assert rec.out_bytes == 4 * 2 * 384


def test_what_cannot_be_accounted_is_named():
  x = torch.randn(16, 16)
  rep = cost(lambda: torch.linalg.svdvals(x))
  assert any(k.startswith("op:aten._linalg_svd") for k in rep.unknown_ops)
  rep = cost(lambda: torch.zeros(4, dtype=torch.complex32) + 1)
  assert rep.unknown_ops.get("dtype:complex32", 0) >= 1
  # views and metadata move nothing; a reshape that must copy does
  assert cost(lambda: x.reshape(256)[:4].unsqueeze(0)).hbm_bytes == 0
  assert cost(lambda: x.T.reshape(256)).hbm_bytes == 2 * 16 * 16 * 4


def test_roofline_under_the_cards_peaks():
  rep = hlo_cost.CostReport(flops=989e12, hbm_bytes=3.35e12 * 2,
                            collective_wire_bytes=450e9 / 2)
  roof = hlo_cost.roofline_from_report(rep)
  assert roof.dominant == "memory"
  assert abs(roof.compute_s - 1.0) < 1e-9
  assert abs(roof.memory_s - 2.0) < 1e-9
  assert abs(roof.collective_s - 0.5) < 1e-9
  assert abs(roof.roofline_fraction - 2.0 / 3.5) < 1e-9


def test_the_memory_ledger_counts_arguments_and_credits_state():
  """input_bytes over every argument, read or not (as the reference's
  jaxpr invars); the state written in place is donated and credited."""
  params = {"w": torch.randn(32, 32), "unused": torch.randn(100)}
  state = {"h": torch.zeros(2, 32), "kept": torch.zeros(2, 8)}
  x = torch.randn(2, 32)

  def step():
    h = torch.tanh(x @ params["w"] + state["h"])
    state["h"].copy_(h)
    return h.sum(-1), state
  out, walk = walked(step)
  rep = liveness.estimate(walk.result, walk, outputs=out,
                          inputs=(params, state, x), donated=state)
  assert rep.input_bytes == 4 * (32 * 32 + 100 + 2 * 32 + 2 * 8 + 2 * 32)
  assert rep.donated_bytes == 4 * (2 * 32 + 2 * 8)
  assert rep.credited_bytes == 4 * 2 * 32
  assert rep.peak_bytes == rep.input_bytes + rep.transient_bytes


def test_fake_tensors_have_storages_of_their_own():
  """Under FakeTensorMode every data_ptr() is 0; the walk tells storages
  apart by their StorageImpl, and views share their base's."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  with FakeTensorMode():
    a, b = torch.empty(8, 8), torch.empty(8, 8)
    walk = OpWalk([], keep_trace=True)
    with walk:
      c = a @ b
      d = c.T
      e = c + d
  ids = {walk.storage_id(t)[0] for t in (a, b, c, e)}
  assert len(ids) == 4 and walk.storage_id(d)[0] == walk.storage_id(c)[0]
  rep = liveness.estimate(walk.result, walk, outputs=[e], inputs=(a, b))
  assert rep.input_bytes == 2 * 256 and rep.transient_bytes == 2 * 256
