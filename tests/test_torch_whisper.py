"""The port's Whisper against the reference's, on the CPU at the
`whisper-small` SMOKE config (2 + 2 layers, d 128, 4 heads) in f32, with
the reference's params carried across by `repro_torch.bridge` (the
LayerNorms' scales and biases and the FFN biases drawn at random, so
every add is exercised) and inputs drawn with numpy.

Tolerances, all f32 summed in another order: the memory of `encode` and
`encode_unrolled` within atol 2e-5 / rtol 1e-5 of the reference's
(measured ~2e-6; the reference's own bar between its two encoders is
atol 2e-4 / rtol 1e-4, `tests/test_calibrated_svd.py`), and the port's
two encoders equal bit for bit (the same per-layer program); logits of
`decode_train`, `decode_step` and `decode_window` within 1e-5 (measured
~5e-7), the window also within 1e-5 of W sequential steps; the loss
within 1e-5 relative and each gradient within 1e-4 relative in norm; a
4-step two-stage run from the reference's own checkpoint within 1e-3 of
its losses (Adam divides each gradient by its own scale, so step-0
differences grow), ranks equal. The bridge round trip is exact.
"""
import copy
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import _key_str, path_arrays  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.core import tracenorm as jtn  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.models import whisper as jw  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import from_reference, to_reference  # noqa: E402
from repro_torch.core import compress, schedule, svd, tracenorm  # noqa: E402
from repro_torch.core.factored import (iter_factored_leaves,  # noqa: E402
                                       param_tree, trainable)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import whisper as tw  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402

ARCH = "whisper-small"
B, T, S = 2, 64, 16            # batch, frames, decoder tokens
MEM_TOL = dict(atol=2e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
STEPS, TRANSITION, LAMBDA = 4, 2, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def jcfg(**kw):
  return jconfigs.get_smoke(ARCH).with_(dtype=jnp.float32, **kw)


def tcfg(**kw):
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32, **kw)


def perturbed_tree(params, seed=0):
  """The reference's tree with every LayerNorm scale/bias and FFN bias
  (ones and zeros at init) drawn at random."""
  rng = np.random.RandomState(seed)
  flat, tree = jax.tree_util.tree_flatten_with_path(params)
  leaves = []
  for path, leaf in flat:
    key = "/".join(_key_str(k) for k in path)
    if key.split("/")[-1] in ("scale", "bias", "b_in", "b_out"):
      leaf = leaf + jnp.asarray(0.1 * rng.randn(*leaf.shape), leaf.dtype)
    leaves.append(leaf)
  return jax.tree_util.tree_unflatten(tree, leaves)


@pytest.fixture(scope="module")
def models():
  """(the reference's params, the port's model) of the same weights."""
  jp = perturbed_tree(jw.init_model(jax.random.PRNGKey(0), jcfg()))
  return jp, from_reference(path_arrays(jp), tcfg(), device="cpu")


@pytest.fixture(scope="module")
def inputs():
  rng = np.random.RandomState(1)
  return {"frames": rng.randn(B, T, 128).astype(np.float32),
          "tokens": rng.randint(1, 512, size=(B, S)),
          "targets": rng.randint(1, 512, size=(B, S))}


@pytest.fixture(scope="module")
def memory(models, inputs):
  """The reference's encoder memory, which both decoders attend to."""
  return np.asarray(jax.jit(jw.encode, static_argnums=2)(
      models[0], jnp.asarray(inputs["frames"]), jcfg()))


def t(x):
  return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------------------
# Encoder.
# ----------------------------------------------------------------------------

def test_encode_matches_reference(models, inputs, memory):
  got = tw.encode(models[1], t(inputs["frames"]), tcfg())
  assert got.shape == (B, T, 128) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), memory, **MEM_TOL)


def test_encode_unrolled_matches_reference_and_encode(models, inputs):
  frames = t(inputs["frames"])
  want = np.asarray(jax.jit(jw.encode_unrolled, static_argnums=2)(
      models[0], jnp.asarray(inputs["frames"]), jcfg()))
  got = tw.encode_unrolled(models[1], frames, tcfg())
  np.testing.assert_allclose(got.numpy(), want, **MEM_TOL)
  assert torch.equal(got, tw.encode(models[1], frames, tcfg()))


@pytest.mark.parametrize("t_len,block", [(48, 32), (1500, 512)])
def test_attn_block_kv_rule_matches_reference(models, t_len, block):
  """The reference reshapes k and v into s // min(block, s) blocks, so it
  fails where that does not divide s (Whisper's own 1500 frames at the
  default 512); the port raises there under both policies."""
  frames = np.zeros((1, t_len, 128), np.float32)
  with pytest.raises(TypeError):
    jax.eval_shape(functools.partial(jw.encode, cfg=jcfg(attn_block_kv=block)),
                   models[0], jnp.asarray(frames))
  for policy in (None, dispatch.decode_policy()):
    with pytest.raises(ValueError, match="attn_block_kv"):
      tw.encode(models[1], t(frames), tcfg(attn_block_kv=block), policy)


def test_encode_at_a_dividing_block_runs_both(models):
  """Whisper's 1500 frames with the block of 500 the reference accepts."""
  frames = np.random.RandomState(2).randn(1, 1500, 128).astype(np.float32)
  want = np.asarray(jw.encode(models[0], jnp.asarray(frames),
                              jcfg(attn_block_kv=500)))
  got = tw.encode(models[1], t(frames), tcfg(attn_block_kv=500))
  np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_encoder_routes_the_non_causal_flash_path():
  """At head width 64 (whisper-small's) a kernel policy routes the
  encoder's attention through `maybe_flash_attention` with causal=False,
  recorded as ("enc/attn", "flash_attention"); on the CPU the wrapper
  runs its plain version, which must equal the blockwise body."""
  cfg = tcfg(num_heads=2, num_kv_heads=2)
  model = tw.init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
  frames = torch.randn((2, 64, 128), generator=torch.Generator(
      ).manual_seed(3))
  with dispatch.record_dispatch() as log:
    got = tw.encode(model, frames, cfg, dispatch.decode_policy())
  assert ("enc/attn", "flash_attention") in set(log)
  assert ("enc/attn_q", "jnp") in set(log)        # 128 rows > 16
  with dispatch.record_dispatch() as log:
    want = tw.encode(model, frames, cfg, dispatch.JNP_ONLY)
  assert {r for _, r in log} == {"jnp"}
  torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------------
# Decoder.
# ----------------------------------------------------------------------------

def test_decode_train_matches_reference(models, inputs, memory):
  want = np.asarray(jax.jit(jw.decode_train, static_argnums=3)(
      models[0], jnp.asarray(inputs["tokens"]), jnp.asarray(memory), jcfg()))
  got = tw.decode_train(models[1], t(inputs["tokens"]), t(memory), tcfg())
  assert got.shape == (B, S, 512)
  np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)


@pytest.fixture(scope="module")
def reference_grads(models, inputs):
  batch = {k: jnp.asarray(v) for k, v in inputs.items()}
  (loss, _), grads = jax.jit(jax.value_and_grad(
      lambda p: jw.loss_fn(p, batch, jcfg()), has_aux=True))(models[0])
  return float(loss), path_arrays(grads)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_reference(models, inputs, reference_grads,
                                            remat):
  jloss, want = reference_grads
  tp = trainable(copy.deepcopy(models[1]))
  loss, metrics = tw.loss_fn(tp, inputs, tcfg(remat=remat))
  loss.backward()
  np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
  assert metrics["xent"].item() == loss.item()
  got = {k: p.grad.numpy() for k, p in param_tree(tp).items()}
  assert sorted(got) == sorted(want)
  for k, g in want.items():
    err = np.linalg.norm(got[k] - g) / max(np.linalg.norm(g), 1e-12)
    assert err < 1e-4, (k, err)


def _states(memory, max_len=32):
  jstate = jw.init_decode_state(jcfg(), B, max_len, enc_len=T)
  jstate["mem"] = jnp.asarray(memory)
  tstate = tw.init_decode_state(tcfg(), B, max_len, enc_len=T, device="cpu")
  tstate["mem"].copy_(t(memory))
  return jstate, tstate


def test_decode_steps_match_reference(models, inputs, memory):
  jstate, tstate = _states(memory)
  step = jax.jit(jw.decode_step, static_argnums=4)
  positions = np.array([0, 3])
  for i in range(4):
    tok = inputs["tokens"][:, i:i + 1]
    jl, jstate = step(models[0], jstate, jnp.asarray(tok),
                      jnp.asarray(positions + i), jcfg())
    tl, tstate = tw.decode_step(models[1], tstate, t(tok), t(positions + i),
                                tcfg())
    assert tl.shape == (B, 1, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
  np.testing.assert_allclose(tstate["kv"]["k"].numpy(),
                             np.asarray(jstate["kv"]["k"]), **LOGIT_TOL)


def test_decode_window_matches_reference_and_steps(models, inputs, memory):
  w, positions = 4, np.array([2, 5])
  toks = inputs["tokens"][:, :w]
  jstate, tstate = _states(memory)
  want, _ = jax.jit(jw.decode_window, static_argnums=4)(
      models[0], jstate, jnp.asarray(toks), jnp.asarray(positions), jcfg())
  api = get_model(tcfg())
  got, _ = api.decode_window(models[1], tstate, t(toks), t(positions),
                             tcfg())
  assert got.shape == (B, w, 512)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
  _, tstate = _states(memory)
  seq, _ = api.decode_window_sequential(models[1], tstate, t(toks),
                                        t(positions), tcfg())
  np.testing.assert_allclose(got.numpy(), seq.numpy(), **LOGIT_TOL)


def test_state_contracts_and_get_model_branch(models):
  cfg, jc = tcfg(), jcfg()
  api, japi = get_model(cfg), jget_model(jc)
  assert api.family == "whisper" and api.forward is None
  assert api.encode is tw.encode and api.decodable
  assert api.decode_state_batch_axes(cfg) == japi.decode_state_batch_axes(jc)
  assert api.decode_state_carry(cfg) == japi.decode_state_carry(jc)
  state = api.init_decode_state(cfg, 3, 16, enc_len=8, device="cpu")
  jstate = japi.init_decode_state(jc, 3, 16, enc_len=8)
  assert {k: tuple(v.shape) for k, v in state["kv"].items()} == \
      {k: tuple(v.shape) for k, v in jstate["kv"].items()}
  assert tuple(state["mem"].shape) == jstate["mem"].shape == (3, 8, 128)
  one = api.init_decode_state(cfg, 1, 16, enc_len=8, device="cpu")
  one["mem"].fill_(1.0)
  one["kv"]["k"].fill_(2.0)
  api.insert_slot(cfg, state, one, 1)
  assert float(state["mem"][1].min()) == 1.0 and \
      float(state["mem"][[0, 2]].abs().max()) == 0.0
  assert float(state["kv"]["k"][:, 1].min()) == 2.0
  model = api.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
  names = {leaf.name for leaf in iter_factored_leaves(model)}
  assert names == {f"{p}/{g}" for p in ("enc", "dec") for g in (
      "attn_q", "attn_k", "attn_v", "attn_o", "ffn_in", "ffn_out")} | {
          f"dec/xattn_{x}" for x in "qkvo"}


def test_bridge_round_trip(models):
  arrays = path_arrays(models[0])
  back = to_reference(models[1])
  assert sorted(back) == sorted(arrays)
  for k, v in arrays.items():
    np.testing.assert_array_equal(back[k], v, err_msg=k)
  again = to_reference(from_reference(back, tcfg(), device="cpu"))
  for k, v in back.items():
    np.testing.assert_array_equal(again[k], v, err_msg=k)


# ----------------------------------------------------------------------------
# Training: the two-stage recipe from the reference's own checkpoint.
# ----------------------------------------------------------------------------

def _batch(i):
  b = jlm.batch_at(jlm.LMDataConfig(vocab_size=512, seq_len=32,
                                    global_batch=B), i)
  frames = np.random.RandomState(i).randn(B, 32, 128).astype(np.float32)
  return {"frames": frames, "tokens": b["tokens"], "targets": b["targets"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """The reference's Trainer saves step 0; the port's Trainer restores it;
  both train STEPS steps (transition at TRANSITION) on the same batches."""
  ref_dir = str(tmp_path_factory.mktemp("whisper_ref_ckpt"))
  jtr = JTrainer(jcfg(), JTrainConfig(
      lr=jschedule.cosine_schedule(1e-3, 0, STEPS), checkpoint_dir=ref_dir,
      async_checkpoint=False), schedule=jschedule.TwoStageSchedule(
          total_steps=STEPS, transition_step=TRANSITION,
          regularizer=jtn.RegularizerConfig(kind="trace", lambda_rec=LAMBDA,
                                            lambda_nonrec=LAMBDA),
          truncation=jsvd.TruncationSpec(variance_threshold=0.9)),
      plan=jcompress.FactorizationPlan(min_dim=32, exclude=("*embed*",)))
  jtr.save(blocking=True)
  ptr = Trainer(tcfg(), TrainConfig(
      lr=schedule.cosine_schedule(1e-3, 0, STEPS), checkpoint_dir=ref_dir,
      async_checkpoint=False), schedule=schedule.TwoStageSchedule(
          total_steps=STEPS, transition_step=TRANSITION,
          regularizer=tracenorm.RegularizerConfig(
              kind="trace", lambda_rec=LAMBDA, lambda_nonrec=LAMBDA),
          truncation=svd.TruncationSpec(variance_threshold=0.9)),
      plan=compress.FactorizationPlan(min_dim=32, exclude=("*embed*",)),
      device="cpu")
  ptr.restore()
  ptr.ckpt = None
  restored = to_reference(ptr.params)
  ref0 = path_arrays(jtr.params)
  out = {"ref": [], "port": [], "restored": restored, "ref0": ref0}
  for i in range(STEPS):
    b = _batch(i)
    out["ref"].append(jtr.train_step(b))
    out["port"].append(ptr.train_step(b))
  out["ref_ranks"] = {leaf.name: leaf.rank for leaf in
                      jcompress.iter_factored_leaves(jtr.params)}
  out["port_ranks"] = {leaf.name: leaf.rank
                       for leaf in iter_factored_leaves(ptr.params)}
  return out


def test_port_restores_the_reference_checkpoint(runs):
  got, want = runs["restored"], runs["ref0"]
  assert sorted(got) == sorted(want)
  assert "enc_layers/attn/wq/u" in got and "dec_layers/ln3/bias" in got
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_two_stage_run_tracks_reference(runs):
  ref, port = runs["ref"], runs["port"]
  assert [m["stage"] for m in port] == [m["stage"] for m in ref] == \
      [1] * TRANSITION + [2] * (STEPS - TRANSITION)
  for r, p in zip(ref, port):
    np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-3)
  assert runs["port_ranks"] == runs["ref_ranks"]
  assert len(runs["port_ranks"]) == 16     # 6 enc + 10 dec stacked GEMMs


def test_launch_train_whisper(capsys):
  """`launch.train --arch whisper-small --device cpu --two-stage` end to
  end: both stages, the diagnostics, a finite final loss."""
  out = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                        "--batch", "2", "--seq", "32", "--two-stage",
                        "--transition", "2"])
  text = capsys.readouterr().out
  assert "stage 1" in text and "stage 2" in text and "rank90=" in text
  assert json.loads(text.strip().splitlines()[-1]) == out
  assert np.isfinite(out["final_loss"])
