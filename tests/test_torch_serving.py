"""The slice as a whole: the port's `StreamingSpeechServer` (on the CPU)
against the reference's, on the same utterances and JAX params carried
across by the bridge — dense, factored (rank 128, `to_stage2(to_stage1(
...))`) and PTQ'd, under the plain policy and the kernel policy (the
reference's Pallas kernels in interpret mode, the port's plain versions:
on CPU tensors the kernel wrappers take them).

Compared per frame step: the slot mask, and the log-probs of the live
slots within atol 1e-4 (f32 in both; the programs differ in summation
order only) — 2e-2 for PTQ'd weights: w8a8 rounds every GEMM input to
int8, and a last-bit difference upstream (conv, gates) can move one
value across a rounding boundary, a jump of one int8 step (1/127 of the
row's range) in a later frame. Labels are compared where the reference's
own serial and fleet paths agree (a near-tie argmax may flip between
them at random init); PTQ'd labels must be identical. The routing log of the kernel
policy must equal the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import bridged, jax_cfg, torch_cfg  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core.svd import TruncationSpec  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import deepspeech as jds  # noqa: E402
from repro.quant import quantize_params as jquantize_params  # noqa: E402
from repro.serving import StreamingSpeechServer as JaxServer  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving import StreamingSpeechServer  # noqa: E402

ATOL = {"dense": 1e-4, "factored": 1e-4, "int8": 2e-2}
LENS = (17, 23, 31)
SLOTS = 2
CHUNK = 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forms():
  params = jds.init_model(jax.random.PRNGKey(0), jax_cfg())
  plan = jcompress.FactorizationPlan()
  return {
      "dense": params,
      "factored": jcompress.to_stage2(jcompress.to_stage1(params, plan),
                                      plan, TruncationSpec(fixed_rank=128)),
      "int8": jquantize_params(params),
  }


@pytest.fixture(scope="module")
def utts():
  rng = np.random.RandomState(0)
  return [rng.randn(t, 80).astype(np.float32) for t in LENS]


def run_jax(params, utts, policy, slots=SLOTS):
  srv = JaxServer(jax_cfg(), params, batch_size=slots, kernel_policy=policy)
  steps, step = [], srv._frame_step

  def recording(p, state, x, mask):
    lp, new = step(p, state, x, mask)
    steps.append((np.asarray(mask), np.asarray(lp)))
    return lp, new
  srv._frame_step = recording
  for u in utts:
    srv.submit(u)
  with jdispatch.record_dispatch() as log:
    res = srv.run(chunk_frames=CHUNK)
  return {r.uid: list(r.labels) for r in res}, steps, {tuple(r) for r in log}


def run_port(params, utts, policy):
  srv = StreamingSpeechServer(torch_cfg(), params, batch_size=SLOTS,
                              kernel_policy=policy, device="cpu")
  steps, step = [], srv._frame_step

  def recording(x, active):
    lp = step(x, active)
    steps.append((active.numpy(), lp.numpy()))
    return lp
  srv._frame_step = recording
  for u in utts:
    srv.submit(u)
  with dispatch.record_dispatch() as log:
    res = srv.run(chunk_frames=CHUNK)
  return {r.uid: list(r.labels) for r in res}, steps, set(log)


@pytest.mark.parametrize("form", ["dense", "factored", "int8"])
@pytest.mark.parametrize("policy", ["plain", "kernels"])
def test_server_matches_reference(forms, utts, form, policy):
  jparams = forms[form]
  jpol, tpol = ("jnp", "plain") if policy == "plain" else ("pallas", "cuda")
  want_labels, want_steps, want_routes = run_jax(jparams, utts, jpol)
  got_labels, got_steps, got_routes = run_port(bridged(jparams), utts, tpol)

  assert len(got_steps) == len(want_steps)
  for (gm, glp), (wm, wlp) in zip(got_steps, want_steps):
    np.testing.assert_array_equal(gm, wm)
    assert glp.shape == wlp.shape
    np.testing.assert_allclose(glp[gm], wlp[wm], atol=ATOL[form], rtol=0)
  assert got_routes == want_routes
  if policy == "kernels":
    assert {r for _, r in got_routes} == {
        "dense": {"decode_matvec", "gru_cell", "jnp"},
        "factored": {"lowrank_gemm", "jnp"},
        "int8": {"int8_gemm"}}[form]

  assert sorted(got_labels) == sorted(want_labels) == list(range(len(LENS)))
  if form == "int8":
    assert got_labels == want_labels
  else:
    serial = {}
    for uid, u in enumerate(utts):
      serial[uid] = run_jax(jparams, [u], jpol, slots=1)[0][0]
    agreed = [uid for uid in want_labels if want_labels[uid] == serial[uid]]
    assert agreed, "the reference's serial and fleet paths never agree"
    for uid in agreed:
      assert got_labels[uid] == want_labels[uid], uid


def test_lockstep_matches_fleet(forms, utts):
  """The lockstep surface (all streams through the same chunks, then
  flush) emits what the fleet emits for the same utterances."""
  params = bridged(forms["int8"])
  t = 23
  feats = np.stack([u[:t] for u in utts[1:]])          # 2 streams
  srv = StreamingSpeechServer(torch_cfg(), params, batch_size=2,
                              device="cpu")
  got = [[], []]
  for chunk in np.split(feats, [9, 16], axis=1):
    for i, e in enumerate(srv.process_chunk(chunk)):
      got[i].extend(e)
  for i, e in enumerate(srv.flush()):
    got[i].extend(e)
  assert srv.flush() == [[], []]
  with pytest.raises(RuntimeError, match="reset"):
    srv.process_chunk(feats[:, :4])
  fleet = StreamingSpeechServer(torch_cfg(), params, batch_size=2,
                                device="cpu")
  for row in feats:
    fleet.submit(row)
  by_uid = {r.uid: r.labels for r in fleet.run(chunk_frames=5)}
  assert got == [by_uid[0], by_uid[1]]
  with pytest.raises(ValueError):
    fleet.submit(np.zeros((4, 81), np.float32))
