"""The port's calibration (the observers of `kernels.dispatch`, the
activation-range and Gram-matrix taps of `quant.ptq`, the calibrated
PTQ and the LiteASR-calibrated truncation) against the reference's, on
the CPU in f32: DS2 at the parity widths of `_torch_parity`, the
`llama3-8b` and `whisper-small` smoke configs, with the reference's
params carried across by the bridge and inputs drawn with numpy.

The calibration dicts must hold the reference's keys exactly: the
reference's observers skip every GEMM inside a `lax.scan` (the GRU
recurrence, the transformer's layers), which the port marks with
`dispatch.scanned()`. Tolerances: amax within 1e-5 relative, Gram
matrices within 1e-4 relative to their largest entry (activations agree
to f32 summation order, ~1e-6), static activation scales within 1e-5
relative; the calibrated-PTQ'd DS2 stream's live log-probs within atol
2e-2 with equal labels (as `tests/test_torch_serving.py` for PTQ: an
activation on an int8 rounding boundary moves by one int8 step);
calibrated truncation: equal ranks and products UV within 1e-4 of the
reference's (each SVD picks its own signs, so u and v are compared only
as their product).
"""
import numpy as np
from threadpoolctl import threadpool_limits
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (bridged, jax_cfg, path_arrays,  # noqa: E402
                           reference_tree, torch_cfg)
from test_torch_serving import LENS, run_jax, run_port  # noqa: E402
from test_torch_whisper import perturbed_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import quant as jquant  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.core.factored import FactoredLinear as JLeaf  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import deepspeech as jds  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models import whisper as jw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bridge import from_reference, to_reference  # noqa: E402
from repro_torch.core import compress, svd  # noqa: E402
from repro_torch.core.factored import FactoredLinear  # noqa: E402
from repro_torch.core.factored import iter_factored_leaves  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import deepspeech as tds  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import whisper as tw  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch and the BLAS pools on one thread: the suite runs files in
  parallel workers, where spinning pool threads slow every worker."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(limits=1):   # the BLAS pools of host SVDs
    yield
  torch.set_num_threads(n)


# ----------------------------------------------------------------------------
# The observers.
# ----------------------------------------------------------------------------

def _leaves(m, n, name, seed):
  w = np.random.RandomState(seed).randn(m, n).astype(np.float32)
  return (JLeaf(w=jnp.asarray(w), u=None, v=None, name=name),
          FactoredLinear(w=torch.from_numpy(w), name=name))


def test_layer_tags_and_stats_assembly():
  leaf = _leaves(8, 4, "blk/fc", 6)
  xs = [np.random.RandomState(7 + i).randn(2, 8).astype(np.float32)
        for i in range(2)]

  def body(gemm, mod):
    for i, x in enumerate(xs):
      with mod.calibration_layer(i):
        gemm(leaf, x)
  want = jquant.calibrate_activation_stats(
      lambda _: body(lambda lf, x: jdispatch.gemm(
          lf[0], jnp.asarray(x), jdispatch.JNP_ONLY), jdispatch), [None])
  got = quant.calibrate_activation_stats(
      lambda _: body(lambda lf, x: dispatch.gemm(
          lf[1], torch.from_numpy(x), dispatch.JNP_ONLY), dispatch), [None])
  assert set(got) == set(want) == {"blk/fc"}
  st = got["blk/fc"]
  assert isinstance(st, quant.ActivationStats)
  assert st.second_moment.shape == (2, 8, 8)
  assert st.second_moment.dtype == np.float64
  for i, x in enumerate(xs):
    r = x.astype(np.float64)
    np.testing.assert_allclose(st.second_moment[i], r.T @ r / 2, rtol=1e-12)
  np.testing.assert_allclose(st.second_moment, want["blk/fc"].second_moment,
                             rtol=1e-6)
  assert st.count == want["blk/fc"].count == 4
  assert st.amax == pytest.approx(want["blk/fc"].amax, rel=1e-6)


def test_activation_ranges_fold_layer_keys():
  leaf = _leaves(4, 4, "blk/fc", 9)
  ones = np.ones((1, 4), np.float32)

  def body(gemm, mod):
    for i, scale in enumerate((1.0, 3.0)):
      with mod.calibration_layer(i):
        gemm(leaf, scale * ones)
  want = jquant.calibrate_activation_ranges(
      lambda _: body(lambda lf, x: jdispatch.gemm(
          lf[0], jnp.asarray(x), jdispatch.JNP_ONLY), jdispatch), [None])
  got = quant.calibrate_activation_ranges(
      lambda _: body(lambda lf, x: dispatch.gemm(
          lf[1], torch.from_numpy(x), dispatch.JNP_ONLY), dispatch), [None])
  assert got == pytest.approx(want)
  assert got == {"blk/fc": 3.0, "blk/fc@L0": 1.0, "blk/fc@L1": 3.0}


def test_observers_see_every_policy_and_skip_scanned_regions():
  _, leaf = _leaves(128, 128, "blk/fc", 3)
  x = torch.randn((2, 128), generator=torch.Generator().manual_seed(0))
  with dispatch.observe_gemm_inputs() as log:
    dispatch.gemm(leaf, x, dispatch.decode_policy())   # decode_matvec
    with dispatch.scanned():
      dispatch.gemm(leaf, 10 * x, dispatch.JNP_ONLY)
  assert log == {"blk/fc": pytest.approx(float(x.abs().max()))}


@pytest.mark.parametrize("tap", ["calibrate_activation_ranges",
                                 "calibrate_activation_stats"])
def test_observed_nothing_raises_as_the_reference(tap):
  _, leaf = _leaves(4, 4, "blk/fc", 1)
  x = torch.ones((1, 4))
  with pytest.raises(RuntimeError, match="zero GEMM activations"):
    getattr(quant, tap)(lambda _: leaf.apply(x), [None])   # no policy
  with pytest.raises(RuntimeError, match="zero GEMM activations"):
    def scanned_only(_):
      with dispatch.scanned():
        dispatch.gemm(leaf, x, dispatch.JNP_ONLY)
    getattr(quant, tap)(scanned_only, [None])
  assert getattr(quant, tap)(lambda _: None, []) == {}   # nothing ran


def test_layer_gap_raises_as_the_reference():
  _, leaf = _leaves(4, 4, "blk/fc", 8)

  def apply_fn(_):
    for i in (0, 2):                    # layer 1 never ran
      with dispatch.calibration_layer(i):
        dispatch.gemm(leaf, torch.ones((1, 4)), dispatch.JNP_ONLY)
  with pytest.raises(RuntimeError, match="contiguous"):
    quant.calibrate_activation_stats(apply_fn, [None])


# ----------------------------------------------------------------------------
# The three families: the reference's keys, values within tolerance.
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds2():
  """(reference params, port model, [feature batch]) at the parity
  widths."""
  params = tds.init_model(torch_cfg(), generator=torch.Generator(
      ).manual_seed(0), device="cpu")
  jp = reference_tree(params, lambda key: jds.init_model(key, jax_cfg()))
  feats = np.random.RandomState(4).randn(2, 40, 80).astype(np.float32)
  return jp, params, [feats]


@pytest.fixture(scope="module")
def lm():
  jc = jconfigs.get_smoke("llama3-8b").with_(dtype=jnp.float32)
  tc = tconfigs.get_smoke("llama3-8b").with_(dtype=torch.float32)
  params = ttf.init_lm(tc, generator=torch.Generator().manual_seed(0),
                       device="cpu")
  jp = reference_tree(params, lambda key: jtf.init_lm(key, jc))
  toks = np.random.RandomState(5).randint(1, 512, size=(2, 16))
  return jp, params, [toks], jc, tc


@pytest.fixture(scope="module")
def whisper():
  jc = jconfigs.get_smoke("whisper-small").with_(dtype=jnp.float32)
  tc = tconfigs.get_smoke("whisper-small").with_(dtype=torch.float32)
  jp = perturbed_tree(jw.init_model(jax.random.PRNGKey(1), jc))
  rng = np.random.RandomState(6)
  frames = [rng.randn(2, 32, 128).astype(np.float32) for _ in range(2)]
  return jp, from_reference(path_arrays(jp), tc, device="cpu"), frames, jc, tc


def _forwards(family, fx):
  """(reference apply_fn, port apply_fn, batches) of a family's
  calibration forward, the plain policy threaded."""
  if family == "deepspeech":
    jp, tp, batches = fx
    return (lambda b: jds.forward(jp, jnp.asarray(b), jax_cfg(),
                                  policy=jdispatch.JNP_ONLY),
            lambda b: tds.forward(tp, torch.from_numpy(b), torch_cfg(),
                                  policy=dispatch.JNP_ONLY), batches)
  if family == "transformer":
    jp, tp, batches, jc, tc = fx
    return (lambda b: jtf.forward(jp, jnp.asarray(b), jc,
                                  policy=jdispatch.JNP_ONLY),
            lambda b: ttf.forward(tp, torch.from_numpy(b), tc,
                                  policy=dispatch.JNP_ONLY), batches)
  jp, tp, batches, jc, tc = fx
  return (lambda b: jw.encode_unrolled(jp, jnp.asarray(b), jc,
                                       policy=jdispatch.JNP_ONLY),
          lambda b: tw.encode_unrolled(tp, torch.from_numpy(b), tc,
                                       policy=dispatch.JNP_ONLY), batches)


#: the keys each family's calibration must hold (the reference's)
KEYS = {
    "deepspeech": {"gru0/nonrec", "gru1/nonrec", "gru2/nonrec", "fc", "out"},
    "transformer": {"lm_head"},
    "whisper": {f"enc/{g}@L{i}" for i in range(2) for g in (
        "attn_q", "attn_k", "attn_v", "attn_o", "ffn_in", "ffn_out")},
}


@pytest.fixture(scope="module")
def calibrations(ds2, lm, whisper):
  """family -> {tap: (reference's dict, port's dict)}."""
  out = {}
  for family, fx in (("deepspeech", ds2), ("transformer", lm),
                     ("whisper", whisper)):
    jfn, tfn, batches = _forwards(family, fx)
    out[family] = {
        "ranges": (jquant.calibrate_activation_ranges(jfn, batches),
                   quant.calibrate_activation_ranges(tfn, batches)),
        "stats": (jquant.calibrate_activation_stats(jfn, batches),
                  quant.calibrate_activation_stats(tfn, batches))}
  return out


@pytest.mark.parametrize("family", ["deepspeech", "transformer", "whisper"])
def test_activation_ranges_match_reference(calibrations, family):
  want, got = calibrations[family]["ranges"]
  folded = {k.split("@L")[0] for k in KEYS[family]}
  assert set(got) == set(want) == KEYS[family] | folded
  for k, v in want.items():
    assert got[k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("family", ["deepspeech", "transformer", "whisper"])
def test_activation_stats_match_reference(calibrations, family):
  want, got = calibrations[family]["stats"]
  assert set(got) == set(want) == {k.split("@L")[0] for k in KEYS[family]}
  for k, w in want.items():
    g = got[k]
    assert g.second_moment.shape == w.second_moment.shape
    assert g.count == w.count
    assert g.amax == pytest.approx(w.amax, rel=1e-5)
    np.testing.assert_allclose(g.second_moment, w.second_moment, rtol=0,
                               atol=1e-4 * np.abs(w.second_moment).max())


def test_calibrated_ptq_gives_the_reference_act_scales(whisper, calibrations):
  """Encoder leaves get a static act_scale (max over their layers' amax /
  127); decoder leaves, which the reference scans, stay dynamic."""
  jp, tp = whisper[:2]
  want_calib, got_calib = calibrations["whisper"]["ranges"]
  want = path_arrays(jquant.quantize_params(jp, calib=want_calib))
  model = quant.quantize_params(tp, calib=got_calib)
  assert quant.is_quantized(model) and not quant.is_quantized(tp)
  got = to_reference(model)
  scales = {k for k in want if k.endswith("/act_scale")}
  assert {k for k in got if k.endswith("/act_scale")} == scales == {
      f"enc_layers/{p}/act_scale" for p in (
          "attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/w_in",
          "ffn/w_out")}
  for k in scales:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
  for k in want:
    if k.endswith("_q"):
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_calibrated_ptq_ds2_stream_matches_reference(ds2, calibrations):
  jp = ds2[0]
  want_calib, got_calib = calibrations["deepspeech"]["ranges"]
  jq = jquant.quantize_params(jp, calib=want_calib)
  tq = quant.quantize_params(bridged(jp), calib=got_calib)
  rng = np.random.RandomState(0)
  utts = [rng.randn(n, 80).astype(np.float32) for n in LENS]
  want_labels, want_steps, _ = run_jax(jq, utts, "jnp")
  got_labels, got_steps, _ = run_port(tq, utts, "plain")
  assert len(got_steps) == len(want_steps)
  for (gm, glp), (wm, wlp) in zip(got_steps, want_steps):
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(glp[gm], wlp[wm], atol=2e-2, rtol=0)
  assert got_labels == want_labels


@pytest.mark.parametrize("fixed_rank", [None, 64])
def test_calibrated_truncation_matches_reference(whisper, calibrations,
                                                 fixed_rank):
  """to_stage2(calib=stats) over the encoder, by the explained variance
  of the whitened spectrum or at a fixed rank: the same ranks a leaf,
  and the same products UV layer by layer."""
  jp, tp = whisper[:2]
  want_stats, got_stats = calibrations["whisper"]["stats"]
  want = jcompress.to_stage2(jp, jcompress.FactorizationPlan(
      include=("enc/*",), truncation=jsvd.TruncationSpec(
          fixed_rank=fixed_rank)), calib=want_stats)
  got = compress.to_stage2(tp, compress.FactorizationPlan(
      include=("enc/*",), truncation=svd.TruncationSpec(
          fixed_rank=fixed_rank)), calib=got_stats)
  wleaves = {lf.name: lf for lf in jcompress.iter_factored_leaves(want)}
  gleaves = {lf.name: lf for lf in iter_factored_leaves(got)}
  enc = {n for n in gleaves if n.startswith("enc/")}
  assert len(enc) == 6 and all(gleaves[n].is_factored for n in enc)
  assert not any(gleaves[n].is_factored for n in set(gleaves) - enc)
  for n in enc:
    w, g = wleaves[n], gleaves[n]
    assert g.rank == w.rank, n
    prod = np.asarray(jnp.matmul(w.u, w.v))
    np.testing.assert_allclose(g.product().numpy(), prod, rtol=0,
                               atol=1e-4 * np.abs(prod).max(), err_msg=n)
  report = compress.compression_report(tp, got, calib=got_stats)
  assert report["calibrated_gemms"] == sorted(got_stats)
  assert report["total_params_after"] < report["total_params_before"]
