"""The port on the card: its five CUDA kernels against their plain
versions, and the streaming server and the LM prefill through the
kernels against the plain policy. Every test here is marked `gpu` and skips where no CUDA device is
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
  with pytest.raises(TypeError):
    decode_matvec(x, torch.ones(128, 64, device=cuda, dtype=torch.bfloat16))
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
  # operands off a 16-byte boundary: TMA (bf16) refuses them, the f32
  # kernel reads them as they are
  q, k, v = (torch.from_numpy(rnd(i, (1 * 8 * 2 * 64 + 1,))).to(cuda, dt)[1:]
             .view(1, 8, 2, 64) for i in (1, 2, 3))
  if dt == torch.bfloat16:
    with pytest.raises(ValueError, match="16-byte"):
      flash_attention(q, k, v)
  else:
    torch.testing.assert_close(flash_attention(q, k, v),
                               ref.flash_attention(q, k, v), **tol)


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
