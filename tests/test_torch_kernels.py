"""The port's kernel plain versions (`repro_torch.kernels.ref`) against
the reference's oracles (`repro.kernels.ref`) and Pallas kernels
(`repro.kernels.ops`, interpret mode on the CPU), on a subset of
tests/test_kernels.py's shape grid, and the `ops` wrappers on CPU
tensors. (The CUDA kernels are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.)

Tolerances: f32 rtol = atol = 1e-5 (summation order differs between the
frameworks; the inputs are O(1) and m <= 1024), attention 2e-5 (the
blockwise softmax sums in another order than the whole-row one). int8
tensors, scales and GEMM outputs are compared bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
#: (b, m, n) from tests/test_kernels.py's PARITY_GRID, odd shapes included
GRID = [(1, 128, 128), (3, 300, 700), (16, 384, 136)]


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def both(*arrays):
  return ([jnp.asarray(a) for a in arrays],
          [torch.from_numpy(a) for a in arrays])


def close(got_t, want_j, **tol):
  np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j),
                             **(tol or TOL))


@pytest.mark.parametrize("b,m,n", GRID)
def test_decode_matvec_matches_reference(b, m, n):
  (xj, wj), (xt, wt) = both(rnd(b, (b, m)), rnd(m, (m, n), 0.05))
  got = ref.decode_matvec(xt, wt)
  close(got, jref.decode_matvec(xj, wj))
  close(got, jops.decode_matvec(xj, wj))


@pytest.mark.parametrize("b,m,n", GRID)
def test_lowrank_gemm_matches_reference(b, m, n):
  r = max(128, min(m, n) // 2)
  (xj, uj, vj), (xt, ut, vt) = both(rnd(b, (b, m)), rnd(m, (m, r), 0.05),
                                    rnd(n, (r, n), 0.05))
  got = ref.lowrank_gemm(xt, ut, vt)
  close(got, jref.lowrank_gemm(xj, uj, vj))
  close(got, jops.lowrank_gemm(xj, uj, vj))


@pytest.mark.parametrize("b,h", [(1, 128), (3, 256), (5, 384)])
def test_gru_cell_matches_reference(b, h):
  (xwj, hj, uj, bj), (xwt, ht, ut, bt) = both(
      rnd(1, (b, 3 * h)), rnd(2, (b, h)), rnd(3, (h, 3 * h), 0.05),
      rnd(4, (3 * h,), 0.1))
  got = ref.gru_cell(xwt, ht, ut, bt)
  close(got, jref.gru_cell(xwj, hj, uj, bj))
  close(got, jops.gru_cell(xwj, hj, uj, bj))


@pytest.mark.parametrize("b,m,n", GRID)
def test_quantize_and_int8_gemm_bitwise(b, m, n):
  (xj, wj), (xt, wt) = both(rnd(b, (b, m)), rnd(m, (m, n), 0.05))
  xq, xs = ref.quantize_rowwise(xt)
  wq, ws = ref.quantize_colwise(wt)
  jxq, jxs = jref.quantize_rowwise(xj)
  jwq, jws = jref.quantize_colwise(wj)
  for got, want in ((xq, jxq), (xs, jxs), (wq, jwq), (ws, jws)):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  y = ref.int8_gemm(xq, wq, xs, ws)
  np.testing.assert_array_equal(y.numpy(),
                                np.asarray(jref.int8_gemm(jxq, jwq, jxs, jws)))
  np.testing.assert_array_equal(y.numpy(),
                                np.asarray(jops.int8_gemm(jxq, jwq, jxs, jws)))


def test_quantize_static_bitwise():
  (xj,), (xt,) = both(rnd(7, (4, 200), 2.0))
  for amax in (0.5, 3.0):                       # saturating and not
    scale = np.float32(amax / 127.0)
    q, s = ref.quantize_static(xt, torch.tensor(scale))
    jq, js = jref.quantize_static(xj, jnp.float32(scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


#: attention at (b, s, h, d) = (1, 128, 2, 128), blocks of 64
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(causal):
  """The plain version against the reference's oracle and its Pallas
  kernel (interpret mode, blocks of 64)."""
  (qj, kj, vj), (qt, kt, vt) = both(*(rnd(i, (1, 128, 2, 128))
                                      for i in (1, 2, 3)))
  got = ref.flash_attention(qt, kt, vt, causal=causal)
  close(got, jref.flash_attention(qj, kj, vj, causal=causal), **ATTN_TOL)
  close(got, jops.flash_attention(qj, kj, vj, causal=causal, block_q=64,
                                  block_k=64), **ATTN_TOL)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_blockwise_attention_matches_reference(kv_heads):
  """The model's plain blockwise attention (the kernel's causal path
  under the plain policy) against the reference's jnp twin and its
  Pallas kernel; kv_heads=1 repeats the kv head for both q heads."""
  from repro.layers.attention import flash_attention as jflash
  from repro.layers.common import ModelConfig as JConfig
  from repro_torch.layers.attention import flash_attention
  from repro_torch.layers.common import ModelConfig
  dims = dict(name="t", family="transformer", num_layers=1, d_model=256,
              num_heads=2, num_kv_heads=kv_heads, d_ff=512, vocab_size=64,
              attn_block_q=64, attn_block_kv=64)
  (qj, kj, vj), (qt, kt, vt) = both(rnd(1, (1, 128, 2, 128)),
                                    rnd(2, (1, 128, kv_heads, 128)),
                                    rnd(3, (1, 128, kv_heads, 128)))
  got = flash_attention(qt, kt, vt, ModelConfig(**dims))
  close(got, jflash(qj, kj, vj, JConfig(**dims)), **ATTN_TOL)
  rep = 2 // kv_heads
  close(got, jops.flash_attention(qj, jnp.repeat(kj, rep, axis=2),
                                  jnp.repeat(vj, rep, axis=2), block_q=64,
                                  block_k=64), **ATTN_TOL)


def test_ops_take_plain_version_on_cpu_without_launching():
  """On CPU tensors each wrapper is its plain version, bit for bit, and
  counts no launch (a launch happens only on a CUDA tensor)."""
  ops.reset_launches()
  x, w = torch.from_numpy(rnd(0, (4, 192))), torch.from_numpy(rnd(1, (192, 256)))
  u, v = torch.from_numpy(rnd(2, (192, 128))), torch.from_numpy(rnd(3, (128, 256)))
  assert torch.equal(ops.decode_matvec(x, w), ref.decode_matvec(x, w))
  assert torch.equal(ops.lowrank_gemm(x, u, v), ref.lowrank_gemm(x, u, v))
  xw, h = torch.from_numpy(rnd(4, (4, 384))), torch.from_numpy(rnd(5, (4, 128)))
  uh, bias = torch.from_numpy(rnd(6, (128, 384), 0.05)), torch.zeros(384)
  assert torch.equal(ops.gru_cell(xw, h, uh, bias),
                     ref.gru_cell(xw, h, uh, bias))
  xq, xs = ref.quantize_rowwise(x)
  wq, ws = ref.quantize_colwise(w)
  assert torch.equal(ops.int8_gemm(xq, wq, xs, ws),
                     ref.int8_gemm(xq, wq, xs, ws))
  q, k, v = (torch.from_numpy(rnd(i, (1, 40, 2, 64))) for i in (7, 8, 9))
  for causal in (True, False):
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal),
                       ref.flash_attention(q, k, v, causal=causal))
  assert set(ops.LAUNCHES.values()) == {0}


def test_launchers_refuse_cpu_tensors():
  """A launcher never computes on the CPU: it wants CUDA tensors."""
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.flash_attention import flash_attention
  with pytest.raises(ValueError, match="CUDA"):
    decode_matvec(torch.ones(2, 128), torch.ones(128, 128))
  with pytest.raises(ValueError, match="CUDA"):
    flash_attention(*(torch.ones(1, 8, 2, 64) for _ in range(3)))


#: attention at (b, s, h, d) = (1, 96, 4, 64) with grouped kv heads
@pytest.mark.parametrize("policy", ["plain", "cuda"])
@pytest.mark.parametrize("kv_heads", [2, 1])
def test_gqa_attention_with_unrepeated_kv_matches_reference(policy,
                                                            kv_heads):
  """k and v at kv_heads, not repeated: the port's plain version, its
  attention layer under both policies (the "cuda" policy hands the
  un-repeated heads to the kernel's wrapper, which on CPU tensors runs
  the plain version) and the reference's jnp twin on repeated heads
  agree within ATTN_TOL."""
  from repro.layers.attention import flash_attention as jflash
  from repro.layers.common import ModelConfig as JConfig
  from repro_torch.kernels.dispatch import resolve_policy
  from repro_torch.layers.attention import flash_attention
  from repro_torch.layers.common import ModelConfig
  dims = dict(name="t", family="transformer", num_layers=1, d_model=256,
              num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=64,
              attn_block_q=32, attn_block_kv=32)
  (qj, kj, vj), (qt, kt, vt) = both(rnd(1, (1, 96, 4, 64)),
                                    rnd(2, (1, 96, kv_heads, 64)),
                                    rnd(3, (1, 96, kv_heads, 64)))
  rep = 4 // kv_heads
  want = jflash(qj, jnp.repeat(kj, rep, axis=2), jnp.repeat(vj, rep, axis=2),
                JConfig(**dims))
  close(ref.flash_attention(qt, kt, vt), want, **ATTN_TOL)
  got = flash_attention(qt, kt, vt, ModelConfig(**dims),
                        resolve_policy(policy))
  close(got, want, **ATTN_TOL)


def test_attention_layer_hands_unrepeated_kv_to_the_kernel(monkeypatch):
  """Under a kernel policy the layer passes k and v at their own kv heads
  to the kernel's wrapper (which reads kv head j // rep in place); only
  the plain route repeats them."""
  from repro_torch.kernels.dispatch import resolve_policy
  from repro_torch.layers.attention import flash_attention
  from repro_torch.layers.common import ModelConfig
  seen = []

  def spy(q, k, v, *, causal=True):
    seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    return ref.flash_attention(q, k, v, causal=causal)
  monkeypatch.setattr(ops, "flash_attention", spy)
  cfg = ModelConfig(name="t", family="transformer", num_layers=1,
                    d_model=256, num_heads=4, num_kv_heads=1, d_ff=512,
                    vocab_size=64)
  q = torch.from_numpy(rnd(1, (1, 40, 4, 64)))
  k, v = (torch.from_numpy(rnd(i, (1, 40, 1, 64))) for i in (2, 3))
  flash_attention(q, k, v, cfg, resolve_policy("cuda"))
  assert seen == [((1, 40, 4, 64), (1, 40, 1, 64), (1, 40, 1, 64))]
  flash_attention(q, k, v, cfg, resolve_policy("plain"))
  assert len(seen) == 1


#: (m, n) of every GEMM decode_matvec and lowrank_gemm's two phases run on
#: the main paths: deepspeech2-wsj's unfactored nonrec/fc leaves, its
#: rank-256 factors, and llama3-8b's q/o, k/v, gate/up, down and head
PLAN_SHAPES = {
    "ds2 gru0/nonrec": (640, 2304), "ds2 gru1/nonrec": (768, 3072),
    "ds2 gru2/nonrec": (1024, 3840), "ds2 fc": (1280, 1536),
    "ds2 rank-256 U": (1280, 256), "ds2 rank-256 V": (256, 3840),
    "llama3 q/o": (4096, 4096), "llama3 k/v": (4096, 1024),
    "llama3 gate/up": (4096, 14336), "llama3 down": (14336, 4096),
    "llama3 head": (4096, 128256),
}


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_decode_matvec_plan_covers_k_once_and_its_workspace(shape):
  """For b 1..17 and bf16/f32 weights: the plan's k ranges cover every k
  of m exactly once; the grid is one wave of the SMs' resident blocks
  (or two k ranges when the column tiles alone overflow it); and the
  blocks' writes (block (x, y, z) -> workspace[y, 16 z + r, x * cols + c],
  as the kernel indexes it) cover the (split, b, n) workspace exactly
  once, with one counter a (column tile, batch tile)."""
  from repro_torch.kernels import decode_matvec as dm
  m, n = PLAN_SHAPES[shape]
  for w_bytes in (2, 4):
    for b in range(1, 18):
      p = dm.plan(b, m, n, w_bytes=w_bytes)
      covered = np.zeros(m, dtype=np.int64)
      for k0, k1 in p.k_ranges():
        assert k0 < k1
        covered[k0:k1] += 1
      assert (covered == 1).all()
      assert p.k_per_split % 8 == 0 or p.k_per_split == m
      assert p.k_per_split >= min(m, dm.k_min(p.lanes))
      assert p.rows >= min(b, dm.BATCH_TILE) and p.cols == p.lanes * p.vec
      gx, gy, gz = p.grid
      slots = dm.RESIDENT[p.rows] * dm.H100_SMS
      assert p.blocks <= slots or gy <= 2
      if p.split == 1:
        assert p.workspace_shape == (0,) and p.counters == 0
        continue
      written = np.zeros(p.workspace_shape, dtype=np.int8)
      for z in range(gz):
        rows = slice(dm.BATCH_TILE * z, min(b, dm.BATCH_TILE * z + p.rows))
        for x in range(gx):
          written[:, rows, x * p.cols:(x + 1) * p.cols] += 1
      assert gy == p.split and (written == 1).all()
      assert p.counters == gx * gz


def _kernel_constants() -> dict:
  """The tiling constants of `csrc/matvec.cuh` (and the batch-row tiers
  of `common.cuh`'s RK_DISPATCH_ROWS), read from the sources."""
  import pathlib
  import re
  csrc = pathlib.Path(ops.__file__).parent / "csrc"
  mv = (csrc / "matvec.cuh").read_text()
  common = (csrc / "common.cuh").read_text()

  def const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", mv).group(1))

  resident = re.search(r"kBlocks = ([^;]+);", mv).group(1)
  tiers = [(int(r), int(k)) for r, k in
           re.findall(r"R <= (\d+) \? (\d+) :", resident)]
  default = int(resident.rsplit(":", 1)[1])
  rows = [int(r) for r in re.findall(r"constexpr int R = (\d+);", common)]
  return dict(
      threads=const("kWarps") * 32, unroll=const("kUnroll"),
      batch_tile=const("kBatchTile"),
      resident={r: next((k for t, k in tiers if r <= t), default)
                for r in rows},
      lanes=sorted(int(g) for g in re.findall(r"lanes != (\d+)", mv)),
      batch_rows=rows)


@pytest.mark.parametrize("name", ["threads", "unroll", "batch_tile",
                                  "resident", "lanes", "batch_rows"])
def test_decode_matvec_plan_constants_match_the_kernel(name):
  """`plan` sizes its wave from copies of the kernel's constants; each
  copy equals the value in the CUDA source, so the two cannot drift
  apart unnoticed."""
  from repro_torch.kernels import decode_matvec as dm
  mine = dict(threads=dm.THREADS, unroll=dm.UNROLL,
              batch_tile=dm.BATCH_TILE, resident=dm.RESIDENT,
              lanes=sorted(dm.LANES),
              batch_rows=sorted({dm.plan(b, 64, 64).rows
                                 for b in range(1, 2 * dm.BATCH_TILE + 1)}))
  assert mine[name] == _kernel_constants()[name]
