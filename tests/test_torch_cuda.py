"""The port on the card: its five CUDA kernels against their plain
versions, and the streaming server, the LM prefill and the LM decode
steps (dense, zamba, DeepSeek) through the kernels against the plain
policy. Every test here is marked `gpu` and skips where no CUDA device is
present (the kernels have no CPU mode); on a GPU machine run

  python -m pytest -q -m gpu tests/test_torch_cuda.py

The file imports only torch and the port (no JAX), so it runs where JAX
is not installed. Tolerances: f32 within 1e-4 (summation order), bf16
within 1e-2 (one output rounding is 2^-8 relative), int8 bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.gpu

#: odd shapes (ragged edges in m and n) and a batch above 16 (grid.y)
GRID = [(1, 128, 128), (3, 300, 700), (16, 384, 136), (37, 300, 700)]


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions(cuda, dtype):
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.gru_cell import gru_cell
  from repro_torch.kernels.int8_gemm import int8_gemm
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)

  def dev(a):
    return torch.from_numpy(a).to(cuda, dt)

  for b, m, n in GRID:
    x, w = dev(rnd(b, (b, m))), dev(rnd(m, (m, n), 0.05))
    u, v = dev(rnd(1, (m, 130), 0.08)), dev(rnd(2, (130, n), 0.08))
    torch.testing.assert_close(decode_matvec(x, w), ref.decode_matvec(x, w),
                               **tol)
    torch.testing.assert_close(lowrank_gemm(x, u, v),
                               ref.lowrank_gemm(x, u, v), **tol)
    xq, xs = ref.quantize_rowwise(x)
    wq, ws = ref.quantize_colwise(w)
    assert torch.equal(int8_gemm(xq, wq, xs, ws),
                       ref.int8_gemm(xq, wq, xs, ws))
  for b, h in ((1, 128), (5, 200), (20, 384)):
    xw, hh = dev(rnd(1, (b, 3 * h))), dev(rnd(2, (b, h)))
    uh = dev(rnd(3, (h, 3 * h), 0.05))
    bias = torch.from_numpy(rnd(4, (3 * h,), 0.1)).to(cuda)
    torch.testing.assert_close(gru_cell(xw, hh, uh, bias),
                               ref.gru_cell(xw, hh, uh, bias), **tol)


def test_launchers_validate_operands(cuda):
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.gru_cell import gru_cell
  x = torch.ones(2, 128, device=cuda)
  # f32 activations over bf16 weights are the one mix taken (the sLSTM's
  # recurrent GEMM); bf16 activations over f32 weights are refused
  with pytest.raises(TypeError):
    decode_matvec(x.bfloat16(), torch.ones(128, 64, device=cuda))
  with pytest.raises(ValueError):
    decode_matvec(x, torch.ones(127, 64, device=cuda))
  with pytest.raises(TypeError, match="bias"):
    gru_cell(torch.ones(2, 384, device=cuda), x,
             torch.ones(128, 384, device=cuda),
             torch.ones(384, device=cuda, dtype=torch.bfloat16))


@pytest.mark.parametrize("form", ["dense", "factored", "int8"])
def test_server_through_kernels_matches_plain(cuda, form):
  """A small f32 DS2 fleet on the card: the "cuda" policy launches the
  form's kernels, and every label and per-step log-prob equals the plain
  policy's within 1e-4 (PTQ'd: bit for bit)."""
  from repro_torch import configs
  from repro_torch.core.compress import FactorizationPlan
  from repro_torch.core.factored import factored, map_factored_leaves
  from repro_torch.kernels import ops
  from repro_torch.models.deepspeech import init_model
  from repro_torch.quant import quantize_params
  from repro_torch.serving import StreamingSpeechServer
  cfg = configs.get_smoke("deepspeech2-wsj").with_(
      gru_dims=(128, 128, 256), fc_dim=128, d_model=256, dtype=torch.float32)
  gen = torch.Generator().manual_seed(0)
  params = init_model(cfg, generator=gen, device=cuda)
  if form == "factored":
    plan = FactorizationPlan()
    params = map_factored_leaves(
        lambda leaf: factored(leaf.in_dim, leaf.out_dim, 128, name=leaf.name,
                              group=leaf.group, generator=gen, device=cuda)
        if plan.matches(leaf) else leaf, params)
  elif form == "int8":
    params = quantize_params(params)
  utts = [rnd(t, (t, 80)) for t in (17, 23, 31)]

  def serve(policy):
    srv = StreamingSpeechServer(cfg, params, batch_size=2,
                                kernel_policy=policy, device=cuda)
    steps, step = [], srv._frame_step

    def recording(x, active):
      lp = step(x, active)
      steps.append(lp[active])
      return lp
    srv._frame_step = recording
    for u in utts:
      srv.submit(u)
    ops.reset_launches()
    labels = {r.uid: r.labels for r in srv.run(chunk_frames=7)}
    return labels, steps, dict(ops.LAUNCHES)

  got, got_steps, launches = serve("cuda")
  want, want_steps, plain_launches = serve("plain")
  expected = {"dense": {"gru_cell", "decode_matvec"},
              "factored": {"lowrank_gemm"}, "int8": {"int8_gemm"}}[form]
  assert {k for k, n in launches.items() if n} == expected
  assert not any(plain_launches.values())
  assert len(got_steps) == len(want_steps)
  for g, w in zip(got_steps, want_steps):
    if form == "int8":
      assert torch.equal(g, w)
    else:
      torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
  assert got == want


#: (b, s, h, d, causal): ragged lengths (s not a multiple of the 64-row
#: f32 or 128-row bf16 tiles), both head widths, both modes
FLASH_GRID = [(1, 256, 4, 128, True), (2, 200, 3, 128, True),
              (1, 130, 2, 64, False), (1, 1, 2, 64, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain_version(cuda, dtype):
  from repro_torch.kernels import ops
  from repro_torch.kernels.flash_attention import flash_attention
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  for b, s, h, d, causal in FLASH_GRID:
    q, k, v = (torch.from_numpy(rnd(i, (b, s, h, d))).to(cuda, dt)
               for i in (1, 2, 3))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention(q, k, v,
                                                        causal=causal), **tol)
  ops.reset_launches()
  ops.flash_attention(q, k, v)
  assert ops.LAUNCHES["flash_attention"] == 1
  with pytest.raises(ValueError, match="head width"):
    flash_attention(*(torch.ones(1, 8, 2, 96, device=cuda) for _ in "qkv"))


def test_prefill_through_flash_matches_plain(cuda):
  """A small f32 LM forward on the card: the "cuda" policy launches the
  flash kernel once per layer, and its logits equal the plain policy's
  blockwise attention within 1e-4."""
  from repro_torch import configs
  from repro_torch.kernels import ops
  from repro_torch.kernels.dispatch import resolve_policy
  from repro_torch.models import transformer
  cfg = configs.get_smoke("llama3-8b").with_(
      dtype=torch.float32, head_dim=64, attn_block_q=64, attn_block_kv=64)
  params = transformer.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                               device=cuda)
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(2, 150))).to(cuda)
  ops.reset_launches()
  got = transformer.forward(params, toks, cfg, policy=resolve_policy("cuda"))
  assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
  want = transformer.forward(params, toks, cfg,
                             policy=resolve_policy("plain"))
  torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


#: (b, s, h, h_kv, d, causal): grouped kv heads (4 and 8 q heads a kv
#: head, as llama3-8b's 32/8), ragged lengths, both head widths and modes
GQA_GRID = [(1, 300, 8, 2, 128, True), (2, 129, 8, 1, 64, False),
            (1, 1, 4, 2, 64, True), (2, 520, 4, 4, 128, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_reads_gqa_heads_in_place(cuda, dtype):
  """k and v at h_kv heads, not repeated: q head j reads kv head
  j // (h // h_kv), as the plain version on repeated heads."""
  from repro_torch.kernels.flash_attention import flash_attention
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  for b, s, h, h_kv, d, causal in GQA_GRID:
    q = torch.from_numpy(rnd(1, (b, s, h, d))).to(cuda, dt)
    k, v = (torch.from_numpy(rnd(i, (b, s, h_kv, d))).to(cuda, dt)
            for i in (2, 3))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rep = h // h_kv
    want = ref.flash_attention(q, torch.repeat_interleave(k, rep, dim=2),
                               torch.repeat_interleave(v, rep, dim=2),
                               causal=causal)
    torch.testing.assert_close(got, want, **tol)
  with pytest.raises(ValueError, match="shapes"):
    flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v)
  # operands off a 16-byte boundary: the wrapper copies a bf16 one for
  # TMA, the f32 kernel reads it as it is
  q, k, v = (torch.from_numpy(rnd(i, (1 * 8 * 2 * 64 + 1,))).to(cuda, dt)[1:]
             .view(1, 8, 2, 64) for i in (1, 2, 3))
  torch.testing.assert_close(flash_attention(q, k, v),
                             ref.flash_attention(q, k, v), **tol)


def test_maybe_flash_attention_launches_on_bf16_views_off_a_16_byte_boundary(
    cuda):
  """bf16 q, k, v one element into their storage (off TMA's 16-byte
  boundary) under the "cuda" policy: the dispatch routes them to the
  kernel, which launches once on the wrapper's aligned copies and agrees
  with the plain version on repeated kv heads within 1e-2."""
  from repro_torch.kernels import dispatch, ops
  b, s_, h, h_kv, d = 1, 200, 8, 2, 128
  q = torch.from_numpy(rnd(1, (b * s_ * h * d + 1,))).to(
      cuda, torch.bfloat16)[1:].view(b, s_, h, d)
  k, v = (torch.from_numpy(rnd(i, (b * s_ * h_kv * d + 1,))).to(
      cuda, torch.bfloat16)[1:].view(b, s_, h_kv, d) for i in (2, 3))
  assert all(t.data_ptr() % 16 for t in (q, k, v))
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    got = dispatch.maybe_flash_attention(q, k, v, dispatch.resolve_policy(
        "cuda"), name="layers/attn")
  assert ops.LAUNCHES["flash_attention"] == 1
  assert log == [("layers/attn", "flash_attention")]
  want = ref.flash_attention(q, torch.repeat_interleave(k, h // h_kv, dim=2),
                             torch.repeat_interleave(v, h // h_kv, dim=2),
                             causal=True)
  torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


#: ragged m and n (n not a multiple of the 8 bf16 / 4 f32 columns of a
#: lane's 16-byte load, or of a block's 256 / 128), shapes whose plan
#: splits k and shapes whose plan does not
RAGGED = [(1000, 700), (333, 130), (4100, 1030), (24, 8), (4096, 4096)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4, 5, 16, 17])
def test_matvec_kernels_on_ragged_shapes(cuda, dtype, b):
  from repro_torch.kernels.decode_matvec import decode_matvec, plan
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  splits = set()
  for m, n in RAGGED:
    x = torch.from_numpy(rnd(b, (b, m))).to(cuda, dt)
    w = torch.from_numpy(rnd(m, (m, n), 0.05)).to(cuda, dt)
    u = torch.from_numpy(rnd(1, (m, 130), 0.05)).to(cuda, dt)
    v = torch.from_numpy(rnd(2, (130, n), 0.08)).to(cuda, dt)
    torch.testing.assert_close(decode_matvec(x, w), ref.decode_matvec(x, w),
                               **tol)
    torch.testing.assert_close(lowrank_gemm(x, u, v),
                               ref.lowrank_gemm(x, u, v), **tol)
    splits.add(plan(b, m, n, w_bytes=w.element_size()).split > 1)
  assert splits == {True, False}


@pytest.mark.parametrize("b", [1, 4, 5, 16, 17])
def test_int8_gemm_bitwise_on_ragged_and_unaligned_shapes(cuda, b):
  """int8_gemm equals the plain version bit for bit at m off every quad
  (37), n off every lane's 16 or 8 columns (13) and at the DS2 widths,
  including a w_q whose rows start off a 16-byte boundary (a view one
  byte into its storage: the kernel's scalar-load branch)."""
  from repro_torch.kernels import int8_gemm as ig
  for m in (37, 640, 1536):
    for n in (13, 32, 2304):
      x = torch.from_numpy(rnd(b, (b, m))).to(cuda)
      xq, xs = ref.quantize_rowwise(x)
      w = torch.from_numpy(rnd(m + n, (m, n), 0.05)).to(cuda)
      wq, ws = ref.quantize_colwise(w)
      assert torch.equal(ig.int8_gemm(xq, wq, xs, ws),
                         ref.int8_gemm(xq, wq, xs, ws))
      flat = torch.zeros(m * n + 1, dtype=torch.int8, device=cuda)
      flat[1:] = wq.flatten()
      off = flat[1:].view(m, n)
      assert off.data_ptr() % 16 != 0
      assert torch.equal(ig.int8_gemm(xq, off, xs, ws),
                         ref.int8_gemm(xq, wq, xs, ws))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_lowrank_finishes_oversubscribed_and_beside_a_busy_stream(
    cuda, dtype):
  """The fused lowrank_gemm takes its work items by ticket, phase 1
  first, so it cannot deadlock: with a plan forced to several waves of
  blocks (k ranges of 8 rows, batch 17: 1 block an SM), and with a long
  kernel holding SMs on a second stream, it finishes and agrees with the
  plain version; the counters it leaves let the next call run too."""
  import dataclasses

  from repro_torch.kernels import decode_matvec as dm
  from repro_torch.kernels import lowrank_gemm as lg
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm, lowrank_plan
  launch = lg._launch
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  b, m, r, n = 17, 1000, 130, 700
  x = torch.from_numpy(rnd(1, (b, m))).to(cuda, dt)
  u = torch.from_numpy(rnd(2, (m, r), 0.05)).to(cuda, dt)
  v = torch.from_numpy(rnd(3, (r, n), 0.08)).to(cuda, dt)
  want = ref.lowrank_gemm(x, u, v)
  p = dataclasses.replace(
      lowrank_plan(b, m, r, n, w_bytes=x.element_size()), split1=125,
      kper1=8, split2=17, kper2=8)
  sms = dm.sm_count(cuda.index or 0)
  assert p.blocks > 2 * lg.RESIDENT[p.rows] * sms
  torch.testing.assert_close(launch(x, u, v, p), want, **tol)
  side = torch.cuda.Stream()
  big = torch.randn(8192, 8192, device=cuda)
  side.wait_stream(torch.cuda.current_stream())   # big is written
  with torch.cuda.stream(side):
    for _ in range(4):
      big @ big.T
  got = launch(x, u, v, p)
  again = lowrank_gemm(x, u, v)
  torch.cuda.synchronize()
  torch.testing.assert_close(got, want, **tol)
  torch.testing.assert_close(again, want, **tol)


def test_factored_quantized_leaf_matches_ref_apply_bitwise(cuda):
  """A factored QuantizedLinear through the kernels (int8_gemm for x @ U,
  a per-row requantize of t, int8_gemm for t @ V) equals `ref_apply` bit
  for bit, at the DS2 frame step's batch and at a ragged one."""
  from repro_torch.core.factored import factored
  from repro_torch.quant.leaf import kernel_apply, ref_apply
  from repro_torch.quant.ptq import quantize_leaf
  gen = torch.Generator().manual_seed(0)
  leaf = quantize_leaf(factored(1024, 3840, 256, name="gru2/nonrec",
                                group="nonrec", generator=gen, device=cuda))
  assert leaf.is_factored
  for b in (4, 17):
    x = torch.from_numpy(rnd(b, (b, 1024))).to(cuda)
    assert torch.equal(kernel_apply(leaf, x), ref_apply(leaf, x))


#: hidden sizes for gru_cell: two DS2 widths, then H off the 64-unit bf16
#: tile (200) and off a 16-byte row (333, 37: U read by scalar loads)
GRU_HIDDEN = (768, 1280, 200, 333, 37)


def _gru_operands(b, hidden, dt, device):
  xw = torch.from_numpy(rnd(b, (b, 3 * hidden))).to(device, dt)
  h = torch.from_numpy(rnd(b + 1, (b, hidden), 0.5)).to(device, dt)
  u = torch.from_numpy(rnd(hidden, (hidden, 3 * hidden), 0.05)).to(device, dt)
  bias = torch.from_numpy(rnd(hidden + 1, (3 * hidden,), 0.1)).to(device)
  return xw, h, u, bias


def _counters_are_zero():
  from repro_torch.kernels import decode_matvec as dm
  return all(int(buf.abs().sum()) == 0 for buf in dm._COUNTERS.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4, 5, 16, 17])
def test_gru_cell_on_ragged_shapes_is_bit_stable(cuda, dtype, b):
  """gru_cell against the plain version at the DS2 widths and ragged H,
  batch 1..17; a second call gives the same bits (the three gates' k
  ranges are summed in a fixed order, whichever block comes last), and
  the tile counters are zero after the calls."""
  from repro_torch.kernels.gru_cell import gru_cell
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  for hidden in GRU_HIDDEN:
    args = _gru_operands(b, hidden, dt, cuda)
    got, again = gru_cell(*args), gru_cell(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.gru_cell(*args), **tol)
    assert torch.equal(got, again)
  assert _counters_are_zero()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_cell_forced_to_several_waves_and_beside_a_busy_stream(cuda,
                                                                   dtype):
  """A plan forced to several waves of blocks (k ranges of 8 rows, batch
  17: one block an SM) and a launch while a long product holds SMs on a
  second stream both agree with the plain version (no block waits on
  another: the last of a tile's blocks does its tail); the counters stay
  zero for the next call; `stamps` gets each block's start <= partial
  sums <= end."""
  import dataclasses
  import math

  from repro_torch.kernels import decode_matvec as dm
  from repro_torch.kernels import gru_cell as gc
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  b, hidden = 17, 333
  args = _gru_operands(b, hidden, dt, cuda)
  want = ref.gru_cell(*args)
  natural = gc.plan(b, hidden, w_bytes=args[1].element_size())
  p = dataclasses.replace(natural, lanes=8, split=math.ceil(hidden / 8),
                          k_per_split=8)
  assert p.blocks > 2 * dm.RESIDENT[p.rows] * dm.sm_count(cuda.index or 0)
  torch.testing.assert_close(gc._launch(*args, p), want, **tol)
  side = torch.cuda.Stream()
  big = torch.randn(8192, 8192, device=cuda)
  side.wait_stream(torch.cuda.current_stream())   # big is written
  with torch.cuda.stream(side):
    for _ in range(4):
      big @ big.T
  got = gc._launch(*args, p)
  stamps = torch.zeros(3 * natural.blocks, dtype=torch.int64, device=cuda)
  stamped = gc._launch(*args, natural, stamps=stamps)
  again = gc.gru_cell(*args)
  torch.cuda.synchronize()
  torch.testing.assert_close(got, want, **tol)
  assert torch.equal(stamped, again)
  st = stamps.view(-1, 3)
  assert bool((st[:, 0] > 0).all() and (st[:, 1] >= st[:, 0]).all()
              and (st[:, 2] >= st[:, 1]).all())
  assert _counters_are_zero()


def test_prefill_at_the_default_smoke_config_declines_flash(cuda):
  """The default llama3-8b smoke config (head width 16, which the flash
  kernel is not built for) under the "cuda" policy: attention declines
  to the plain path instead of raising, and the logits equal the plain
  policy's within 1e-4."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models import transformer
  cfg = configs.get_smoke("llama3-8b").with_(dtype=torch.float32)
  assert cfg.resolved_head_dim == 16
  params = transformer.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                               device=cuda)
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(2, 70))).to(cuda)
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    got = transformer.forward(params, toks, cfg,
                              policy=dispatch.resolve_policy("cuda"))
  assert ops.LAUNCHES["flash_attention"] == 0
  assert ("layers/attn", "flash_attention") not in set(log)
  want = transformer.forward(params, toks, cfg,
                             policy=dispatch.resolve_policy("plain"))
  torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_training_step_on_the_card_matches_the_cpu(cuda, tmp_path):
  """One f32 stage-1 step (trace norm on, DS2 smoke config) on the card
  and on the CPU from the same weights (the CPU trainer's, carried to the
  card through a checkpoint: each device's own stage-1 SVD would pick
  other signs) and batch: the loss within 1e-4
  relative, each gradient within 1e-3 relative in norm, and each leaf's
  update within 1e-2 relative in norm (Adam's first step moves every
  weight by about lr * sign(g), so a gradient within rounding of zero may
  move the other way on the other device)."""
  from repro_torch import configs
  from repro_torch.core.compress import FactorizationPlan
  from repro_torch.core.schedule import TwoStageSchedule
  from repro_torch.core.svd import TruncationSpec
  from repro_torch.core.tracenorm import RegularizerConfig
  from repro_torch.data.speech import SpeechDataConfig, batch_at
  from repro_torch.training import TrainConfig, Trainer
  cfg = configs.get_smoke("deepspeech2-wsj").with_(dtype=torch.float32)
  sched = TwoStageSchedule(
      total_steps=4, transition_step=2,
      regularizer=RegularizerConfig(kind="trace", lambda_rec=1e-4,
                                    lambda_nonrec=1e-4),
      truncation=TruncationSpec())
  batch = batch_at(SpeechDataConfig(global_batch=4), 0)
  runs = []
  for dev in ("cpu", cuda):
    tr = Trainer(cfg, TrainConfig(lr=1e-3, checkpoint_dir=str(tmp_path)),
                 schedule=sched, device=dev,
                 plan=FactorizationPlan(min_dim=32),
                 generator=torch.Generator().manual_seed(0))
    if runs:
      tr.restore()
    else:
      tr.save(blocking=True)
    before = {k: p.detach().cpu().clone() for k, p in
              tr.params.named_parameters()}
    _, _, grads = tr._step_fn.grads_of(tr.params, batch)
    m = tr.train_step(batch)
    after = {k: p.detach().cpu() for k, p in tr.params.named_parameters()}
    runs.append((m["loss"], {k: g.cpu() for k, g in grads.items()},
                 {k: after[k] - before[k] for k in before}))
  (l_c, g_c, d_c), (l_g, g_g, d_g) = runs
  np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
  for k in g_c:
    assert float((g_g[k] - g_c[k]).norm() / g_c[k].norm()) < 1e-3, k
  for k in d_c:
    assert float((d_g[k] - d_c[k]).norm() / d_c[k].norm()) < 1e-2, k


#: (m, r, n) of the llama3-8b draft at rank 128 that stress the fused
#: launch most: phase 1's split-K over w_down's 14336 rows, and the
#: factored head's 128256 columns (2004 phase-2 column tiles)
LLAMA_DRAFT = [(14336, 128, 4096), (4096, 128, 128256)]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("shape", LLAMA_DRAFT)
def test_lowrank_gemm_at_llama3_8b_draft_shapes(cuda, shape, b):
  """`lowrank_gemm` against its plain version in bf16 at the draft's
  widest shapes, at the batch of a draft prefill (1) and of a 4-slot
  draft step (4), within 1e-2."""
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm, lowrank_plan
  m, r, n = shape
  gen = torch.Generator(device=cuda).manual_seed(b)

  def draw(*s, scale=1.0):
    return (torch.randn(s, generator=gen, device=cuda) * scale).to(
        torch.bfloat16)
  x, u, v = draw(b, m), draw(m, r, scale=m ** -0.5), draw(r, n,
                                                           scale=r ** -0.5)
  got = lowrank_gemm(x, u, v)
  torch.cuda.synchronize()
  assert got.shape == (b, n) and got.dtype == torch.bfloat16
  torch.testing.assert_close(got, ref.lowrank_gemm(x, u, v), rtol=1e-2,
                             atol=1e-2)
  p = lowrank_plan(b, m, r, n)
  assert p.split2 == 1 and p.tiles[1] == -(-n // p.cols)


def test_ds2_decode_window_through_kernels_matches_plain_steps(cuda):
  """DS2's `api_decode_window` on the card under the "cuda" policy (a
  4-frame window at 2 slots: the non-recurrent and FC GEMMs through
  decode_matvec at 8 rows, the recurrence through gru_cell) against 4
  `api_decode_step`s under the plain policy, in f32 within 1e-4."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models.api import get_model
  from repro_torch.models.deepspeech import init_model
  cfg = configs.get_smoke("deepspeech2-wsj").with_(
      gru_dims=(128, 128, 256), fc_dim=128, d_model=256, dtype=torch.float32)
  api, b, w = get_model(cfg), 2, 4
  params = init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device=cuda)
  f = params.grus["gru0"].nonrec.in_dim
  state = api.init_decode_state(cfg, b, device=cuda)
  pos = torch.zeros(b, dtype=torch.int64, device=cuda)
  for t in range(2):                            # a streaming carry
    x = torch.from_numpy(rnd(t, (b, 1, f))).to(cuda)
    _, state = api.decode_step(params, state, x, pos, cfg)
  frames = torch.from_numpy(rnd(5, (b, w, f))).to(cuda)
  ops.reset_launches()
  # the window writes its state in place: each run gets its own
  got, new = api.decode_window(params, {k: v.clone() for k, v in
                                        state.items()}, frames, pos, cfg,
                               dispatch.resolve_policy("cuda", b, window=w))
  launches = dict(ops.LAUNCHES)
  want, want_state = api.decode_window_sequential(
      params, state, frames, pos, cfg, dispatch.resolve_policy("plain"))
  torch.cuda.synchronize()
  layers = len(cfg.gru_dims)
  assert launches == dict(launches, decode_matvec=layers + 1,
                          gru_cell=layers * w)
  assert not any(n for k, n in launches.items()
                 if k not in ("decode_matvec", "gru_cell"))
  torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
  for k in want_state:
    torch.testing.assert_close(new[k], want_state[k], rtol=0, atol=1e-4)


#: (b, s, h, h_kv, d, causal) at stablelm-3b's head width 80 (two 64-column
#: panels of TMA, the second zero past column 16): ragged lengths off the
#: 64- and 128-row tiles, one row, grouped kv heads, both modes
FLASH_80 = [(1, 300, 4, 4, 80, True), (2, 129, 3, 3, 80, False),
            (1, 1, 2, 2, 80, True), (1, 520, 8, 2, 80, True),
            (1, 200, 4, 4, 80, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_width_80(cuda, dtype):
  """The d = 80 instantiation against the plain version (scale 1/sqrt(80)),
  f32 within 1e-4 and bf16 within 1e-2; each output head holds exactly
  its own 80 columns (a wrong panel would read the next head's)."""
  from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
  assert 80 in HEAD_DIMS
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  for b, s, h, h_kv, d, causal in FLASH_80:
    q = torch.from_numpy(rnd(1, (b, s, h, d))).to(cuda, dt)
    k, v = (torch.from_numpy(rnd(i, (b, s, h_kv, d))).to(cuda, dt)
            for i in (2, 3))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rep = h // h_kv
    want = ref.flash_attention(q, torch.repeat_interleave(k, rep, dim=2),
                               torch.repeat_interleave(v, rep, dim=2),
                               causal=causal)
    torch.testing.assert_close(got, want, **tol)


#: (b, s, h, h_kv, d, causal) at zamba2-7b's head width 112 (two 64-column
#: panels, the second zero past column 48), as FLASH_80
FLASH_112 = [(1, 300, 4, 4, 112, True), (2, 129, 3, 3, 112, False),
             (1, 1, 2, 2, 112, True), (1, 520, 8, 2, 112, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_width_112(cuda, dtype):
  """The d = 112 instantiation against the plain version (scale
  1/sqrt(112)), f32 within 1e-4 and bf16 within 1e-2."""
  from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
  assert 112 in HEAD_DIMS
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  for b, s, h, h_kv, d, causal in FLASH_112:
    q = torch.from_numpy(rnd(4, (b, s, h, d))).to(cuda, dt)
    k, v = (torch.from_numpy(rnd(i, (b, s, h_kv, d))).to(cuda, dt)
            for i in (5, 6))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rep = h // h_kv
    want = ref.flash_attention(q, torch.repeat_interleave(k, rep, dim=2),
                               torch.repeat_interleave(v, rep, dim=2),
                               causal=causal)
    torch.testing.assert_close(got, want, **tol)


def test_zamba_smoke_decode_through_kernels_matches_plain(cuda):
  """zamba2-7b's smoke config in f32 on the card: 6 batch-2 decode steps
  under the "cuda" policy (the 128-lane GEMMs through decode_matvec)
  against the plain policy, logits and every SSM carry within 1e-4, and
  a 4-token decode window against its steps."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models import zamba
  cfg = configs.get_smoke("zamba2-7b").with_(dtype=torch.float32)
  params = zamba.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                         device=cuda)
  b = 2
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(b, 10))).to(cuda)
  states = {p: zamba.init_decode_state(cfg, b, 16, device=cuda)
            for p in ("cuda", "plain")}
  pos = torch.tensor([0, 2], device=cuda)
  ops.reset_launches()
  for t in range(6):
    out = {p: zamba.decode_step(
        params, states[p], toks[:, t:t + 1], pos + t, cfg,
        dispatch.resolve_policy(p, b))[0] for p in states}
    torch.testing.assert_close(out["cuda"], out["plain"], rtol=1e-4,
                               atol=1e-4)
  assert ops.LAUNCHES["decode_matvec"] > 0
  for key in ("main_ssm", "tail_ssm"):
    torch.testing.assert_close(states["cuda"][key]["ssm"],
                               states["plain"][key]["ssm"], rtol=1e-4,
                               atol=1e-4)
  got, _ = zamba.decode_window(params, states["cuda"], toks[:, 6:], pos + 6,
                               cfg, dispatch.resolve_policy("cuda", b,
                                                            window=4))
  steps = []
  for t in range(4):
    lg, _ = zamba.decode_step(params, states["plain"], toks[:, 6 + t:7 + t],
                              pos + 6 + t, cfg)
    steps.append(lg[:, 0])
  torch.testing.assert_close(got, torch.stack(steps, 1), rtol=1e-4, atol=1e-4)


def test_qwen3_smoke_decode_through_kernels_matches_plain(cuda):
  """qwen3-4b's smoke config (qk-norm) in f32 on the card: 6 batch-2
  decode steps under the "cuda" policy (the GEMMs of 128 lanes or more
  through decode_matvec) against the plain policy, logits within 1e-4 at
  every step, and a 4-token decode window against its steps."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models import transformer
  cfg = configs.get_smoke("qwen3-4b").with_(dtype=torch.float32)
  params = transformer.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                               device=cuda)
  b = 2
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(b, 10))).to(cuda)
  states = {p: transformer.init_decode_state(cfg, b, 16, device=cuda)
            for p in ("cuda", "plain")}
  pos = torch.tensor([0, 2], device=cuda)
  ops.reset_launches()
  for t in range(6):
    out = {p: transformer.decode_step(
        params, states[p], toks[:, t:t + 1], pos + t, cfg,
        dispatch.resolve_policy(p, b))[0] for p in states}
    torch.testing.assert_close(out["cuda"], out["plain"], rtol=1e-4,
                               atol=1e-4)
  assert ops.LAUNCHES["decode_matvec"] > 0
  got, _ = transformer.decode_window(params, states["cuda"], toks[:, 6:],
                                     pos + 6, cfg,
                                     dispatch.resolve_policy("cuda", b, window=4))
  steps = []
  for t in range(4):
    lg, _ = transformer.decode_step(params, states["plain"],
                                    toks[:, 6 + t:7 + t], pos + 6 + t, cfg)
    steps.append(lg[:, 0])
  torch.testing.assert_close(got, torch.stack(steps, 1), rtol=1e-4, atol=1e-4)


def test_transformer_training_step_on_the_card_matches_the_cpu(cuda,
                                                               tmp_path):
  """One f32 stage-1 step (trace norm on, qwen3-4b smoke config, batches
  of `data/lm.py`) on the card and on the CPU from the same weights (the
  CPU trainer's, through a checkpoint): the loss within 1e-4 relative and
  each gradient within 1e-3 relative in norm (f32 sums in another
  order)."""
  from repro_torch import configs
  from repro_torch.core.compress import FactorizationPlan
  from repro_torch.core.schedule import TwoStageSchedule
  from repro_torch.core.svd import TruncationSpec
  from repro_torch.core.tracenorm import RegularizerConfig
  from repro_torch.data.lm import LMDataConfig, batch_at
  from repro_torch.training import TrainConfig, Trainer
  cfg = configs.get_smoke("qwen3-4b").with_(dtype=torch.float32)
  sched = TwoStageSchedule(
      total_steps=4, transition_step=2,
      regularizer=RegularizerConfig(kind="trace", lambda_rec=1e-4,
                                    lambda_nonrec=1e-4),
      truncation=TruncationSpec())
  batch = batch_at(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4), 0)
  runs = []
  for dev in ("cpu", cuda):
    tr = Trainer(cfg, TrainConfig(lr=1e-3, checkpoint_dir=str(tmp_path)),
                 schedule=sched, device=dev,
                 plan=FactorizationPlan(min_dim=32, exclude=("*embed*",)),
                 generator=torch.Generator().manual_seed(0))
    if runs:
      tr.restore()
    else:
      tr.save(blocking=True)
    _, _, grads = tr._step_fn.grads_of(tr.params, tr_batch(tr, batch))
    m = tr.train_step(batch)
    runs.append((m["loss"], {k: g.cpu() for k, g in grads.items()}))
  (l_c, g_c), (l_g, g_g) = runs
  np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
  assert sorted(g_g) == sorted(g_c)
  for k in g_c:
    assert float((g_g[k] - g_c[k]).norm() / g_c[k].norm()) < 1e-3, k


def tr_batch(trainer, batch):
  from repro_torch.data.lm import shard_batch
  return shard_batch(batch, trainer.device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_flash_at_the_whisper_encoder_shape(cuda, dtype):
  """flash_attention non-causal at whisper-small's encoder attention
  (4, 1500, 12, 64): 1500 is off every 128-row tile."""
  from repro_torch.kernels.flash_attention import flash_attention
  dt = getattr(torch, dtype)
  tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
      dict(rtol=1e-2, atol=1e-2)
  q, k, v = (torch.from_numpy(rnd(i, (4, 1500, 12, 64))).to(cuda, dt)
             for i in (4, 5, 6))
  got = flash_attention(q, k, v, causal=False)
  torch.cuda.synchronize()
  torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal=False),
                             **tol)


def test_whisper_encode_through_flash_matches_plain(cuda):
  """A full-width whisper-small encode (12 layers, f32, 1500 frames,
  attn_block_kv 500): the "cuda" policy launches the non-causal flash
  kernel once a layer and nothing else (every GEMM has 1500 rows), and
  its memory equals the plain policy's within 2e-4 (f32 summation order
  through 12 layers)."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models import whisper
  cfg = configs.get_config("whisper-small").with_(dtype=torch.float32,
                                                  attn_block_kv=500)
  model = whisper.init_model(cfg, generator=torch.Generator(
      device=cuda).manual_seed(0), device=cuda)
  frames = torch.from_numpy(rnd(7, (1, 1500, cfg.d_model))).to(cuda)
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    got = whisper.encode(model, frames, cfg, dispatch.resolve_policy("cuda"))
  assert ops.LAUNCHES == {**{k: 0 for k in ops.LAUNCHES},
                          "flash_attention": cfg.encoder_layers}
  assert ("enc/attn", "flash_attention") in set(log)
  want = whisper.encode(model, frames, cfg, dispatch.resolve_policy("plain"))
  torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


#: (m, n) of every GEMM a DeepSeek decode step sends to decode_matvec:
#: deepseek-v2-lite's wq, w_dkv, wo, the dense layer's SwiGLU, the shared
#: experts' SwiGLU and the head; deepseek-v3-671b's q-LoRA wq_a and wq_b
#: and its wo
DEEPSEEK_DECODE = [(2048, 3072), (2048, 576), (2048, 2048), (2048, 10944),
                   (10944, 2048), (2048, 2816), (2816, 2048), (2048, 102400),
                   (7168, 1536), (1536, 24576), (16384, 7168)]


@pytest.mark.parametrize("shape", DEEPSEEK_DECODE)
def test_decode_matvec_at_deepseek_decode_shapes(cuda, shape):
  """decode_matvec against its plain version in bf16 at batch 4 (the
  engine's slots), within 1e-2."""
  from repro_torch.kernels.decode_matvec import decode_matvec
  m, n = shape
  gen = torch.Generator(device=cuda).manual_seed(m + n)
  x = torch.randn(4, m, generator=gen, device=cuda).to(torch.bfloat16)
  w = (torch.randn(m, n, generator=gen, device=cuda) * m ** -0.5).to(
      torch.bfloat16)
  got = decode_matvec(x, w)
  torch.cuda.synchronize()
  assert got.shape == (4, n) and got.dtype == torch.bfloat16
  torch.testing.assert_close(got, ref.decode_matvec(x, w), rtol=1e-2,
                             atol=1e-2)


def test_deepseek_smoke_decode_through_kernels_matches_plain(cuda):
  """deepseek-v3-671b's smoke config (q-LoRA, MLA, MoE) in f32 on the
  card: 4 batch-2 decode steps under the "cuda" policy against the plain
  policy with the same routes and logits within 1e-4, then a 4-token
  window against its steps."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch, ops
  from repro_torch.layers import moe
  from repro_torch.models import transformer
  cfg = configs.get_smoke("deepseek-v3-671b").with_(dtype=torch.float32)
  params = transformer.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                               device=cuda)
  b = 2
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(b, 8))).to(cuda)
  states = {p: transformer.init_decode_state(cfg, b, 16, device=cuda)
            for p in ("cuda", "plain")}
  pos = torch.tensor([0, 3], device=cuda)
  ops.reset_launches()
  routes = {}
  for p in states:
    with moe.record_routes() as routes[p]:
      out = [transformer.decode_step(
          params, states[p], toks[:, t:t + 1], pos + t, cfg,
          dispatch.resolve_policy(p, b))[0] for t in range(4)]
    routes[p + "_out"] = out
  for a, c in zip(routes["cuda_out"], routes["plain_out"]):
    torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
  for a, c in zip(routes["cuda"], routes["plain"]):
    np.testing.assert_array_equal(np.sort(a["experts"], -1),
                                  np.sort(c["experts"], -1))
  assert ops.LAUNCHES["decode_matvec"] > 0
  got, _ = transformer.decode_window(
      params, states["cuda"], toks[:, 4:], pos + 4, cfg,
      dispatch.resolve_policy("cuda", b, window=4))
  steps = [transformer.decode_step(params, states["plain"],
                                   toks[:, 4 + t:5 + t], pos + 4 + t,
                                   cfg)[0][:, 0] for t in range(4)]
  torch.testing.assert_close(got, torch.stack(steps, 1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b", [1, 4, 16])
def test_mixed_f32_activations_over_bf16_weights(cuda, b):
  """decode_matvec and lowrank_gemm take f32 x over bf16 weights (the
  sLSTM's recurrent GEMM: xlstm-350m's per-head (256, 1024) `rh`, and a
  rank-128 factored one), f32 out, within 1e-4 of the plain versions,
  which upcast both operands."""
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  x = torch.from_numpy(rnd(0, (b, 256))).to(cuda)
  w = torch.from_numpy(rnd(1, (256, 1024), 0.05)).to(cuda, torch.bfloat16)
  u = torch.from_numpy(rnd(2, (256, 128), 0.1)).to(cuda, torch.bfloat16)
  v = torch.from_numpy(rnd(3, (128, 1024), 0.1)).to(cuda, torch.bfloat16)
  y = decode_matvec(x, w)
  assert y.dtype == torch.float32
  torch.testing.assert_close(y, ref.decode_matvec(x, w), rtol=1e-4, atol=1e-4)
  y = lowrank_gemm(x, u, v)
  assert y.dtype == torch.float32
  torch.testing.assert_close(y, ref.lowrank_gemm(x, u, v), rtol=1e-4,
                             atol=1e-4)
  with pytest.raises(TypeError):
    lowrank_gemm(x.bfloat16(), u.float(), v.float())


def test_xlstm_smoke_decode_through_kernels_matches_plain(cuda):
  """xlstm-350m's smoke config at d 512 and 2 heads (each `rh` head
  (256, 1024) reaches the 128-lane gate): 4 batch-2 decode steps under
  the "cuda" policy. In bf16 every GEMM routes to decode_matvec (the
  recurrent heads on f32 activations over bf16 weights) but the gate
  projection, one launch a route, finite logits; in f32 the logits are
  the plain policy's within 1e-4 (in bf16 one flipped rounding reaches
  the mLSTM's normaliser, which divides by a sum that cancels)."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models import xlstm_model
  b = 2
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, 512, size=(b, 4))).to(cuda)
  pol = dispatch.resolve_policy("cuda", b)
  for dtype in (torch.bfloat16, torch.float32):
    cfg = configs.get_smoke("xlstm-350m").with_(d_model=512, dtype=dtype)
    params = xlstm_model.init_lm(
        cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    states = {p: xlstm_model.init_decode_state(cfg, b, device=cuda)
              for p in ("cuda", "plain")}
    ops.reset_launches()
    log = []
    for t in range(4):
      want, _ = xlstm_model.decode_step(params, states["plain"],
                                        toks[:, t:t + 1], None, cfg)
      with dispatch.record_dispatch() as step_log:
        got, _ = xlstm_model.decode_step(params, states["cuda"],
                                         toks[:, t:t + 1], None, cfg, pol)
      log += step_log
      assert bool(torch.isfinite(got.float()).all())
      if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert {n for n, r in log if r == "jnp"} == {"pairs/mlstm_ifg"}
    assert ("pairs/slstm_rec", "decode_matvec") in log
    assert ops.LAUNCHES["decode_matvec"] == sum(
        r == "decode_matvec" for _, r in log)
