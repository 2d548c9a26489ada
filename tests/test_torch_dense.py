"""The rest of the dense-transformer family against the reference, on the
CPU at the SMOKE configs (2 layers, d 128) in f32: `qwen3-4b` (qk-norm,
head width 32), `glm4-9b` and `chameleon-34b` (GQA 8/2), and
`stablelm-3b` (MHA 8/8), each with the reference's params carried across
by `repro_torch.bridge` and token inputs drawn with numpy; and the plain
`flash_attention` at stablelm-3b's head width 80.

Tolerances: whole models (logits, KV caches) at 1e-4 — summation order
in the GEMMs and the blockwise softmax, as `tests/test_torch_lm.py`;
attention alone at 2e-5 (one f32 softmax); configs and bridged leaves
exactly.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers.common import ModelConfig as JConfig  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import from_reference, to_reference  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.layers import attention  # noqa: E402
from repro_torch.layers.common import ModelConfig  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCHS = ["qwen3-4b", "glm4-9b", "chameleon-34b", "stablelm-3b"]
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def jcfg(arch):
  return jconfigs.get_smoke(arch).with_(dtype=jnp.float32)


def tcfg(arch):
  return tconfigs.get_smoke(arch).with_(dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
  """{arch: (reference params, the port's)}, each built once."""
  out = {}
  for arch in ARCHS:
    jp = jtf.init_lm(jax.random.PRNGKey(0), jcfg(arch))
    out[arch] = jp, from_reference(path_arrays(jp), tcfg(arch), device="cpu")
  return out


#: the reference's entry points jitted once per config (eager calls would
#: trace and compile their layer scans again at every call)
jforward = jax.jit(jtf.forward, static_argnums=(2,),
                   static_argnames=("last_only",))
jdecode_step = jax.jit(jtf.decode_step, static_argnums=(4,))
jdecode_window = jax.jit(jtf.decode_window, static_argnums=(4,))


def tokens(seed, shape, vocab):
  return np.random.RandomState(seed).randint(1, vocab, size=shape)


def close(got, want, tol):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ----------------------------------------------------------------------------
# Configs and weights.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
  """Every field the port's ModelConfig has equals the reference's, full
  and smoke (dtype aside: the port's is a torch.dtype)."""
  names = [f.name for f in dataclasses.fields(ModelConfig) if f.name != "dtype"]
  for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                       (tconfigs.get_smoke, jconfigs.get_smoke)):
    t, j = get_t(arch), get_j(arch)
    assert {n: getattr(t, n) for n in names} == \
        {n: getattr(j, n) for n in names}
  assert arch in tconfigs.ARCH_NAMES
  assert tconfigs.get_config("stablelm-3b").resolved_head_dim == 80


def test_qk_norm_leaves_cross_the_bridge(models):
  """qwen3's per-head norms: (L, hd) f32 leaves at the reference's paths,
  carried both ways bit for bit; a config without qk-norm leaves them
  unused (the bridge raises)."""
  jp, tp = models["qwen3-4b"]
  arrays = path_arrays(jp)
  assert arrays["dense_layers/attn/q_norm"].shape == (2, 32)
  assert tp.dense_layers.attn.k_norm.dtype == torch.float32
  back = to_reference(tp)
  assert sorted(back) == sorted(arrays)
  for k, v in arrays.items():
    np.testing.assert_array_equal(back[k], v, err_msg=k)
  with pytest.raises(KeyError, match="unused"):
    from_reference(arrays, tcfg("qwen3-4b").with_(qk_norm=False),
                   device="cpu")


# ----------------------------------------------------------------------------
# The models.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch, last_only):
  """s = 64: two q blocks of 32, the diagonal tile and a skipped one."""
  jp, tp = models[arch]
  toks = tokens(5, (2, 64), 512)
  want, _ = jforward(jp, jnp.asarray(toks), jcfg(arch),
                     last_only=last_only)
  got = transformer.forward(tp, torch.from_numpy(toks), tcfg(arch),
                            last_only=last_only)
  assert got.shape == want.shape == (2, 1 if last_only else 64, 512)
  close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_and_window_match_reference(models, arch):
  """6 decode steps at ragged positions, then a 3-token decode window
  (the speculative verify path): logits at every call and the KV caches
  after them."""
  jp, tp = models[arch]
  cj, ct = jcfg(arch), tcfg(arch)
  b, steps, w, max_len = 2, 6, 3, 12
  toks = tokens(7, (b, steps + w), 512)
  pos0 = np.array([0, 3])
  jstate = jtf.init_decode_state(cj, b, max_len)
  tstate = transformer.init_decode_state(ct, b, max_len, device="cpu")
  for t in range(steps):
    pos = pos0 + t
    jl, jstate = jdecode_step(jp, jstate, jnp.asarray(toks[:, t:t + 1]),
                              jnp.asarray(pos, jnp.int32), cj)
    tl, tstate = transformer.decode_step(tp, tstate,
                                         torch.from_numpy(toks[:, t:t + 1]),
                                         torch.from_numpy(pos), ct)
    close(tl, jl, MODEL_TOL)
  pos = pos0 + steps
  jl, jstate = jdecode_window(jp, jstate, jnp.asarray(toks[:, steps:]),
                              jnp.asarray(pos, jnp.int32), cj)
  tl, tstate = transformer.decode_window(tp, tstate,
                                         torch.from_numpy(toks[:, steps:]),
                                         torch.from_numpy(pos), ct)
  assert tl.shape == (b, w, 512)
  close(tl, jl, MODEL_TOL)
  for key in ("k", "v"):
    close(tstate["dense"][key], jstate["dense"][key], MODEL_TOL)


def test_qk_norm_is_live_and_matches_reference(models):
  """qwen3's q/k norms are live: scaling one layer's q_norm moves the
  port's logits exactly as it moves the reference's."""
  jp, tp = models["qwen3-4b"]
  jq = jax.tree.map(lambda a: a, jp)
  jq["dense_layers"]["attn"]["q_norm"] = \
      jp["dense_layers"]["attn"]["q_norm"].at[0].multiply(3.0)
  tq = from_reference(path_arrays(jq), tcfg("qwen3-4b"), device="cpu")
  toks = tokens(9, (1, 32), 512)
  want, _ = jforward(jq, jnp.asarray(toks), jcfg("qwen3-4b"))
  got = transformer.forward(tq, torch.from_numpy(toks), tcfg("qwen3-4b"))
  base = transformer.forward(tp, torch.from_numpy(toks), tcfg("qwen3-4b"))
  close(got, want, MODEL_TOL)
  assert float((got - base).abs().max()) > 1e-2


# ----------------------------------------------------------------------------
# Head width 80 (stablelm-3b).
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_at_head_width_80_matches_reference(causal):
  """`kernels/ref.flash_attention` (the d = 80 kernel's plain version)
  against the reference's oracle and its Pallas kernel (interpret mode,
  blocks of 64) at (1, 128, 2, 80), scale 1/sqrt(80)."""
  arrays = [np.random.RandomState(i).randn(1, 128, 2, 80).astype(np.float32)
            for i in (1, 2, 3)]
  qj, kj, vj = (jnp.asarray(a) for a in arrays)
  got = ref.flash_attention(*(torch.from_numpy(a) for a in arrays),
                            causal=causal)
  close(got, jref.flash_attention(qj, kj, vj, causal=causal), ATTN_TOL)
  close(got, jops.flash_attention(qj, kj, vj, causal=causal, block_q=64,
                                  block_k=64), ATTN_TOL)


def test_head_dims_are_the_cuda_sources_instantiations():
  """`HEAD_DIMS` (the routing gate) names exactly the widths
  `csrc/flash_attention.cu` launches, on its bf16 (TMA) and f32 (SIMT)
  paths alike."""
  from repro_torch.kernels import flash_attention as fa
  src = (pathlib.Path(fa.__file__).parent / "csrc" /
         "flash_attention.cu").read_text()
  for launcher in ("tma::launch", "launch_simt"):
    widths = re.findall(rf"if \(d == (\d+)\) return {launcher}<\1>", src)
    assert tuple(int(w) for w in widths) == fa.HEAD_DIMS == (64, 80, 112,
                                                              128)


def test_blockwise_attention_at_head_width_80_matches_reference():
  """The model's plain blockwise attention at stablelm-3b's head width
  against the reference's jnp twin (blocks of 64 over s = 128)."""
  dims = dict(name="t", family="transformer", num_layers=1, d_model=320,
              num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
              attn_block_q=64, attn_block_kv=64)
  arrays = [np.random.RandomState(i).randn(1, 128, 4, 80).astype(np.float32)
            for i in (4, 5, 6)]
  got = attention.flash_attention(*(torch.from_numpy(a) for a in arrays),
                                  ModelConfig(**dims))
  want = jattn.flash_attention(*(jnp.asarray(a) for a in arrays),
                               JConfig(**dims))
  close(got, want, ATTN_TOL)


def test_blockwise_attention_at_head_width_112_matches_reference():
  """The plain blockwise attention at zamba2-7b's head width (112)
  against the reference's jnp twin (blocks of 64 over s = 128)."""
  dims = dict(name="t", family="transformer", num_layers=1, d_model=448,
              num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
              attn_block_q=64, attn_block_kv=64)
  arrays = [np.random.RandomState(i).randn(1, 128, 4, 112).astype(
      np.float32) for i in (7, 8, 9)]
  got = attention.flash_attention(*(torch.from_numpy(a) for a in arrays),
                                  ModelConfig(**dims))
  want = jattn.flash_attention(*(jnp.asarray(a) for a in arrays),
                               JConfig(**dims))
  close(got, want, ATTN_TOL)


def test_stablelm_prefill_routes_flash_at_head_width_80(models):
  """stablelm-3b's smoke config at its full head width (80) under the
  "cuda" policy: one flash route a layer (on the CPU the wrapper runs its
  plain version and launches nothing), logits equal the reference's."""
  cj = jcfg("stablelm-3b").with_(head_dim=80)
  ct = tcfg("stablelm-3b").with_(head_dim=80)
  jp = jtf.init_lm(jax.random.PRNGKey(1), cj)
  tp = from_reference(path_arrays(jp), ct, device="cpu")
  toks = tokens(11, (1, 64), 512)
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    got = transformer.forward(tp, torch.from_numpy(toks), ct,
                              policy=dispatch.resolve_policy("cuda"))
  assert log.count(("layers/attn", "flash_attention")) == ct.num_layers
  assert not any(ops.LAUNCHES.values())
  want, _ = jforward(jp, jnp.asarray(toks), cj)
  close(got, want, MODEL_TOL)
