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


#: (m, n) of every GEMM decode_matvec runs on the main paths, and more:
#: deepspeech2-wsj's unfactored nonrec/fc leaves, its rank-256 factors'
#: shapes, and llama3-8b's q/o, k/v, gate/up, down and head
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


#: (m, n) of the deepspeech2-wsj leaves: the 7 that FactorizationPlan()
#: factors at rank 256 (lowrank_gemm) and, with `out`, the 8 PTQ'd ones
#: (int8_gemm); then ragged shapes (m, n off every quad, vector and tile)
DS2_LEAVES = {
    "gru0/nonrec": (640, 2304), "gru1/nonrec": (768, 3072),
    "gru2/nonrec": (1024, 3840), "gru0/rec": (768, 2304),
    "gru1/rec": (1024, 3072), "gru2/rec": (1280, 3840), "fc": (1280, 1536),
}
DS2_INT8 = dict(DS2_LEAVES, out=(1536, 32))
RAGGED = {"ragged 1000x700": (1000, 700), "ragged 333x1030": (333, 1030),
          "ragged 37x13": (37, 13)}


@pytest.mark.parametrize("shape", sorted(DS2_LEAVES) + sorted(RAGGED))
def test_lowrank_plan_covers_u_and_v_once_in_one_wave(shape):
  """For b 1..17 and bf16/f32 (rank 256 on the DS2 leaves, 130 and 72 on
  the ragged shapes): the tickets decode to every phase-1 item and every
  phase-2 item once, all phase 1's first; phase 1's k ranges cover every
  k of U once and phase 2's tiles and ranges every (k, column) of V once;
  the grid fits one wave of resident blocks at 132 SMs (always at the
  main path's bf16 DS2 shapes; elsewhere unless the column and batch
  tiles alone overflow it, and then no k is split); the slab fits the
  kernel's shared memory and one chunk of staged t; the workspace holds t
  and each splitting phase's partials, and the counters the head and one
  a tile of each phase."""
  from repro_torch.kernels import decode_matvec as dm
  from repro_torch.kernels import lowrank_gemm as lg
  m, n = {**DS2_LEAVES, **RAGGED}[shape]
  ranks = (256,) if shape in DS2_LEAVES else (130, 72)
  for r in ranks:
    for w_bytes in (2, 4):
      for b in range(1, 18):
        p = lg.lowrank_plan(b, m, r, n, w_bytes=w_bytes)
        gx1, gx2, gz = p.tiles
        assert p.rows >= min(b, dm.BATCH_TILE) and p.cols == lg.LANES * p.vec
        phases = [p.item(t)[0] for t in range(p.blocks)]
        assert phases == sorted(phases) and phases.count(1) == p.items1
        seen = {p.item(t) for t in range(p.blocks)}
        assert len(seen) == p.blocks
        for phase, k, gx, split in ((1, m, gx1, p.split1),
                                    (2, r, gx2, p.split2)):
          ranges = p.k_ranges(phase)
          assert len(ranges) == split
          covered = np.zeros(k, dtype=np.int64)
          for k0, k1 in ranges:
            assert k0 < k1
            covered[k0:k1] += 1
          assert (covered == 1).all()
          assert {(ph, x, y, z) for ph, x, y, z in seen if ph == phase} == {
              (phase, x, y, z) for x in range(gx) for y in range(split)
              for z in range(gz)}
        written = np.zeros((r, gx2 * p.cols), dtype=np.int8)
        for x in range(gx2):
          for k0, k1 in p.k_ranges(2):
            written[k0:k1, x * p.cols:(x + 1) * p.cols] += 1
        assert (written[:, :n] == 1).all()
        assert p.blocks <= lg.RESIDENT[p.rows] * dm.H100_SMS or \
            p.split1 == p.split2 == 1
        if shape in DS2_LEAVES and b <= dm.BATCH_TILE and w_bytes == 2:
          assert p.blocks <= lg.RESIDENT[p.rows] * dm.H100_SMS
        assert p.kper1 % 8 == 0 or p.kper1 == m
        assert p.kper2 % 8 == 0 or p.kper2 == r
        if p.slab:
          assert n % p.vec == 0
          assert p.slab_bytes == p.kper2 * p.cols * w_bytes <= lg.SLAB_BYTES
          assert p.kper2 * p.rows <= lg.XS_FLOATS
        elif shape in DS2_LEAVES and b <= dm.BATCH_TILE:
          pytest.fail(f"{shape} b={b}: no slab of V at a main-path shape")
        assert p.slab_bytes == (p.kper2 * p.cols * w_bytes if p.slab else 0)
        assert p.workspace_shape == (
            b * r + (p.split1 * b * r if p.split1 > 1 else 0)
            + (p.split2 * b * n if p.split2 > 1 else 0),)
        assert p.counters == lg.HEAD + gz * (gx1 + gx2)


@pytest.mark.parametrize("shape", sorted(DS2_INT8) + sorted(RAGGED))
def test_int8_plan_covers_k_once_and_its_workspace(shape):
  """For b 1..17: int8_gemm's k ranges cover every k of w_q once, in
  whole 16-row quads-of-quads (or one range); the grid fits one wave (or
  two k ranges); 16 columns a lane up to 8 batch rows, 8 at 16; the
  blocks' writes cover the (split, b, n) s32 workspace once, with one
  counter a (column tile, batch tile)."""
  from repro_torch.kernels import decode_matvec as dm
  from repro_torch.kernels import int8_gemm as ig
  m, n = {**DS2_INT8, **RAGGED}[shape]
  for b in range(1, 18):
    p = ig.plan(b, m, n)
    covered = np.zeros(m, dtype=np.int64)
    for k0, k1 in p.k_ranges():
      assert k0 < k1
      covered[k0:k1] += 1
    assert (covered == 1).all()
    assert p.k_per_split % 16 == 0 or p.split == 1
    assert p.k_per_split >= min(m, ig.k_min(p.lanes))
    assert p.vec == (16 if p.rows <= 8 else 8) and p.lanes in dm.LANES
    gx, gy, gz = p.grid
    assert p.blocks <= ig.RESIDENT[p.rows] * dm.H100_SMS or gy <= 2
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


def _source_constants() -> dict:
  """The constants of `csrc/lowrank_gemm.cu` and `csrc/int8_gemm.cu`,
  read from the sources (int8_gemm.cu takes its warps and batch tile
  from matvec.cuh)."""
  import pathlib
  import re
  csrc = pathlib.Path(ops.__file__).parent / "csrc"
  lr = (csrc / "lowrank_gemm.cu").read_text()
  mv = (csrc / "matvec.cuh").read_text()
  i8 = (csrc / "int8_gemm.cu").read_text()
  rows = (1, 2, 4, 8, 16)

  def const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

  def resident(src):
    expr = re.search(r"kBlocks = ([^;]+);", src).group(1)
    tiers = [(int(r), int(k)) for r, k in
             re.findall(r"R <= (\d+) \? (\d+) :", expr)]
    default = int(expr.rsplit(":", 1)[1])
    return {r: next((k for t, k in tiers if r <= t), default) for r in rows}

  vec = re.search(r"kVec = R <= (\d+) \? (\d+) : (\d+);", i8).groups()
  head = re.search(r"kTicket = 0, kTReady = 1, kPast = 2, kTiles = (\d+);",
                   lr)
  return dict(
      lowrank_lanes=const(lr, "kLanes"), lowrank_slab=const(lr, "kSlabBytes"),
      lowrank_head=int(head.group(1)), lowrank_resident=resident(lr),
      lowrank_xs_floats=const(mv, "kXsFloats"),
      int8_threads=const(mv, "kWarps") * 32, int8_unroll=const(i8, "kUnroll"),
      int8_batch_tile=const(mv, "kBatchTile"), int8_resident=resident(i8),
      int8_cols_a_lane={r: int(vec[1]) if r <= int(vec[0]) else int(vec[2])
                        for r in rows},
      int8_lanes=sorted(int(g) for g in re.findall(r"lanes != (\d+)", i8)))


@pytest.mark.parametrize("name", [
    "lowrank_lanes", "lowrank_slab", "lowrank_head", "lowrank_resident",
    "lowrank_xs_floats", "int8_threads",
    "int8_unroll", "int8_batch_tile", "int8_resident", "int8_cols_a_lane",
    "int8_lanes"])
def test_fused_lowrank_and_int8_plan_constants_match_the_kernels(name):
  """The plans of the fused lowrank_gemm and of int8_gemm size their
  grids from copies of the kernels' constants; each copy equals the value
  in the CUDA source."""
  from repro_torch.kernels import decode_matvec as dm
  from repro_torch.kernels import int8_gemm as ig
  from repro_torch.kernels import lowrank_gemm as lg
  mine = dict(
      lowrank_lanes=lg.LANES, lowrank_slab=lg.SLAB_BYTES,
      lowrank_head=lg.HEAD, lowrank_resident=lg.RESIDENT,
      lowrank_xs_floats=lg.XS_FLOATS,
      int8_threads=ig.THREADS, int8_unroll=ig.UNROLL,
      int8_batch_tile=dm.BATCH_TILE, int8_resident=ig.RESIDENT,
      int8_cols_a_lane={r: ig.cols_a_lane(r) for r in ig.RESIDENT},
      int8_lanes=sorted(dm.LANES))
  assert mine[name] == _source_constants()[name]


#: hidden sizes of gru_cell's plan: deepspeech2-wsj's three GRUs (the
#: main path), then narrow ones (one k range; H off the unit tile)
GRU_HIDDEN = (768, 1024, 1280, 64, 80, 96)
DS2_HIDDEN = (768, 1024, 1280)


@pytest.mark.parametrize("b", [1, 4, 5, 16, 17])
@pytest.mark.parametrize("hidden", GRU_HIDDEN)
def test_gru_cell_plan_covers_k_once_and_its_workspace(hidden, b):
  """For bf16 and f32 U: the plan's k ranges tile [0, H) once; the column
  tiles (gate x % 3 of unit tile x // 3, as the kernel decodes them)
  cover all three gates of every unit once; the grid fits one wave of
  resident blocks (always at the bf16 DS2 widths up to batch 16; else
  two k ranges at most); the blocks' writes (block (x, y, z) ->
  workspace[y, 16 z + r, gate * H + unit]) cover the (split, b, 3H)
  workspace once, and each of the counters (one a unit tile and batch
  tile) counts 3 * split blocks."""
  from repro_torch.kernels import decode_matvec as dm
  from repro_torch.kernels import gru_cell as gc
  for w_bytes in (2, 4):
    p = gc.plan(b, hidden, w_bytes=w_bytes)
    covered = np.zeros(hidden, dtype=np.int64)
    for k0, k1 in p.k_ranges():
      assert k0 < k1
      covered[k0:k1] += 1
    assert (covered == 1).all()
    assert p.k_per_split % 8 == 0 or p.k_per_split == hidden
    assert p.k_per_split >= min(hidden, dm.k_min(p.lanes))
    assert p.lanes in dm.LANES and p.vec == 16 // w_bytes
    assert p.cols == p.lanes * p.vec and p.rows >= min(b, dm.BATCH_TILE)
    gx, gy, gz = p.grid
    assert gx == gc.GATES * p.unit_tiles and gy == p.split
    slots = dm.RESIDENT[p.rows] * dm.H100_SMS
    assert p.blocks <= slots or gy <= 2
    if hidden in DS2_HIDDEN and b <= dm.BATCH_TILE and w_bytes == 2:
      assert p.blocks <= slots
    units = np.zeros((gc.GATES, hidden), dtype=np.int64)
    written = np.zeros(p.workspace_shape, dtype=np.int64)
    arrivals = np.zeros((gz, p.unit_tiles), dtype=np.int64)
    for z in range(gz):
      rows = slice(dm.BATCH_TILE * z, min(b, dm.BATCH_TILE * z + p.rows))
      for x in range(gx):
        gate, t = p.tile(x)
        u0, u1 = t * p.cols, min(hidden, (t + 1) * p.cols)
        if z == 0:
          units[gate, u0:u1] += 1
        for y in range(gy):
          written[y, rows, gate * hidden + u0:gate * hidden + u1] += 1
          arrivals[z, t] += 1
    assert (units == 1).all()
    assert (written == 1).all()
    assert arrivals.size == p.counters
    assert (arrivals == gc.GATES * p.split).all()


def _gru_source_constants() -> dict:
  """What `gru_cell.plan` copies from `csrc/gru_cell.cu`: its gates and
  the lane widths its launcher takes; and, where the kernel runs the tile
  of `matvec.cuh` (its threads, resident blocks and 16-byte lanes), that
  tile's values (None where it does not)."""
  import pathlib
  import re
  csrc = pathlib.Path(ops.__file__).parent / "csrc"
  gru = (csrc / "gru_cell.cu").read_text()
  tile = _kernel_constants()
  on_tile = "using rk::mv::kThreads;" in gru
  return dict(
      gates=int(re.search(r"constexpr int kGates = (\d+);", gru).group(1)),
      lanes=sorted(int(g) for g in re.findall(r"lanes != (\d+)", gru)),
      threads=tile["threads"] if on_tile else None,
      resident=(tile["resident"]
                if "__launch_bounds__(kThreads, rk::mv::Resident<R>::kBlocks)"
                in gru else None),
      vec=({w: 16 // w for w in (2, 4)}
           if "rk::mv::Lane<T>::kVec" in gru else None))


@pytest.mark.parametrize("name", ["gates", "lanes", "threads", "resident",
                                  "vec"])
def test_gru_cell_plan_constants_match_the_kernel(name):
  """`gru_cell.plan` sizes its grid from copies of the kernel's constants:
  GATES column groups (kGates), the lane widths its launcher takes, and
  the threads, resident blocks and 16-byte lanes of the matvec.cuh tile
  that the kernel runs (decode_matvec's THREADS and RESIDENT)."""
  from repro_torch.kernels import decode_matvec as dm
  from repro_torch.kernels import gru_cell as gc
  mine = dict(gates=gc.GATES, lanes=sorted(dm.LANES), threads=dm.THREADS,
              resident=gc.RESIDENT,
              vec={w: gc.plan(4, 64, w_bytes=w).vec for w in (2, 4)})
  assert mine[name] == _gru_source_constants()[name]
