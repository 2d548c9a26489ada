"""The port's truncated-SVD warmstart (`core.svd`, `core.compress`)
against the reference's: the balanced split, the explained-variance
rank and its rounding, stacked leaves, the activation-weighted split,
and `to_stage1` / `to_stage2` / `compression_report` on the DS2 smoke
model carried over by the bridge.

Singular vectors carry a sign, so factors are compared through their
products U·V, within 1e-4 (f32: two LAPACK SVDs); ranks and parameter
counts exactly. The stage-2 ranks are picked from f32 singular values;
`test_to_stage2_matches_reference` also checks that no rank sits within
1e-5 of the 0.9 threshold on its seed, so equal ranks are a fair ask."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bridged, path_arrays  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.core.factored import FactoredLinear as JLeaf  # noqa: E402
from repro.models import deepspeech as jds  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.core import compress, svd  # noqa: E402
from repro_torch.core.factored import (FactoredLinear, count_params,  # noqa: E402
                                       iter_factored_leaves)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


ATOL = 1e-4
#: launch/train.py's plan: every DS2 GEMM at the smoke widths
PLAN = dict(min_dim=32, exclude=("*embed*",))


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def t(a):
  return torch.from_numpy(np.array(a))


def test_balanced_split_reconstructs_and_balances():
  w = rnd(0, (24, 16))
  u, v = svd.balanced_split(t(w))
  np.testing.assert_allclose((u @ v).numpy(), w, atol=ATOL)
  np.testing.assert_allclose(float((u * u).sum()), float((v * v).sum()),
                             rtol=1e-4)
  ju, jv = jsvd.balanced_split(jnp.asarray(w), 7)
  u7, v7 = svd.balanced_split(t(w), 7)
  assert tuple(u7.shape) == (24, 7) and tuple(v7.shape) == (7, 16)
  np.testing.assert_allclose((u7 @ v7).numpy(), np.asarray(ju @ jv),
                             atol=ATOL)


@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.999])
@pytest.mark.parametrize("spec", [dict(), dict(round_to=1),
                                  dict(max_rank=12), dict(fixed_rank=5)])
def test_rank_rule_matches_reference(threshold, spec):
  s = np.sort(np.abs(rnd(2, (48,))) ** 3)[::-1]
  assert svd.explained_variance_rank(s, threshold) == \
      jsvd.explained_variance_rank(s, threshold)
  got = svd.TruncationSpec(variance_threshold=threshold, **spec).pick(s)
  want = jsvd.TruncationSpec(variance_threshold=threshold, **spec).pick(s)
  assert got == want
  assert svd.TruncationSpec().round_to == 8


@pytest.mark.parametrize("form", ["2d", "stacked"])
def test_truncate_leaf_matches_reference(form):
  shape = (40, 56) if form == "2d" else (3, 40, 56)
  w = rnd(3, shape) + np.einsum("...ir,...rj->...ij", rnd(4, shape[:-1] + (3,)),
                                rnd(5, shape[:-2] + (3, 56)), optimize=True) * 3
  spec = dict(variance_threshold=0.8, round_to=4)
  got = svd.truncate_leaf(FactoredLinear(w=t(w), name="x"),
                          svd.TruncationSpec(**spec))
  want = jsvd.truncate_leaf(JLeaf(w=jnp.asarray(w), u=None, v=None, name="x"),
                            jsvd.TruncationSpec(**spec))
  assert got.rank == want.rank and got.rank % 4 == 0
  assert tuple(got.u.shape) == want.u.shape
  np.testing.assert_allclose(got.product().numpy(),
                             np.asarray(want.product()), atol=ATOL)


@pytest.mark.parametrize("form", ["2d", "stacked"])
@pytest.mark.parametrize("spec", [dict(fixed_rank=12), dict(fixed_rank=13),
                                  dict(fixed_rank=99),
                                  dict(fixed_rank=30, max_rank=20)])
def test_truncate_leaf_fixed_rank_reads_no_singular_values(monkeypatch,
                                                           form, spec):
  """Under fixed_rank the rank rule reads only min(m, n): truncate_leaf
  computes no singular values for it, and returns the rank and factors
  that picking from the singular values gave (rounding to 8, max_rank,
  the min(m, n) cap), equal to the reference's."""
  shape = (40, 56) if form == "2d" else (3, 40, 56)
  w = rnd(8, shape)
  tspec = svd.TruncationSpec(**spec)
  flat = t(w).reshape(-1, 40, 56)
  want_rank = max(tspec.pick(svd._svals(m)) for m in flat)
  want = [svd.balanced_split(m, want_rank) for m in flat]
  jwant = jsvd.truncate_leaf(JLeaf(w=jnp.asarray(w), u=None, v=None,
                                   name="x"), jsvd.TruncationSpec(**spec))

  def no_svals(_):
    raise AssertionError("singular values computed under fixed_rank")
  monkeypatch.setattr(svd, "_svals", no_svals)
  got = svd.truncate_leaf(FactoredLinear(w=t(w), name="x"), tspec)
  assert got.rank == want_rank == jwant.rank
  u, v = (got.u, got.v) if form == "stacked" else (got.u[None], got.v[None])
  for i, (wu, wv) in enumerate(want):
    assert torch.equal(u[i], wu) and torch.equal(v[i], wv)
  np.testing.assert_allclose(got.product().numpy(),
                             np.asarray(jwant.product()), atol=ATOL)


def test_activation_split_matches_reference():
  w = rnd(6, (24, 30))
  x = rnd(7, (200, 24)) * np.linspace(0.1, 3, 24, dtype=np.float32)
  cov = x.T @ x / len(x)
  spec = dict(variance_threshold=0.9, round_to=1)
  u, v, s = svd.activation_split(t(w), cov, svd.TruncationSpec(**spec))
  ju, jv, js = jsvd.activation_split(jnp.asarray(w), cov,
                                     jsvd.TruncationSpec(**spec))
  np.testing.assert_allclose(s, js, rtol=1e-6)
  np.testing.assert_allclose((u @ v).numpy(), np.asarray(ju @ jv), atol=ATOL)
  leaf = svd.truncate_leaf(FactoredLinear(w=t(w), name="x"),
                           svd.TruncationSpec(**spec), cov=cov)
  np.testing.assert_allclose(leaf.product().numpy(), np.asarray(ju @ jv),
                             atol=ATOL)


def test_factorize_collapse_roundtrip():
  w = rnd(8, (2, 20, 12))
  leaf = svd.factorize_leaf(FactoredLinear(w=t(w), name="s"))
  assert leaf.is_factored and leaf.rank == 12
  back = svd.collapse_leaf(leaf)
  assert not back.is_factored
  np.testing.assert_allclose(back.w.numpy(), w, atol=ATOL)


@pytest.fixture(scope="module")
def models():
  """The DS2 smoke model (f32) in both packages, and both stage-1 forms."""
  jcfg = jconfigs.get_smoke("deepspeech2-wsj").with_(dtype=jnp.float32)
  tcfg = tconfigs.get_smoke("deepspeech2-wsj").with_(dtype=torch.float32)
  jp = jds.init_model(jax.random.PRNGKey(0), jcfg)
  tp = bridged(jp, tcfg)
  jplan = jcompress.FactorizationPlan(**PLAN)
  tplan = compress.FactorizationPlan(**PLAN)
  j1 = jcompress.to_stage1(jp, jplan)
  t1 = compress.to_stage1(tp, tplan)
  return dict(jp=jp, tp=tp, j1=j1, t1=t1, jplan=jplan, tplan=tplan)


def products(model):
  return {leaf.name: leaf.product().detach().numpy()
          for leaf in iter_factored_leaves(model)}


def test_to_stage1_matches_reference(models):
  j1, t1 = models["j1"], models["t1"]
  jleaves = {leaf.name: leaf for leaf in jcompress.iter_factored_leaves(j1)}
  got = products(t1)
  assert sorted(got) == sorted(jleaves) and len(got) == 8
  for name, w in got.items():
    leaf = jleaves[name]
    assert leaf.is_factored
    np.testing.assert_allclose(w, np.asarray(leaf.product()), atol=ATOL,
                               err_msg=name)
  # the product is the unfactored weight: the balanced split is exact
  np.testing.assert_allclose(got["fc"], models["tp"].fc.w.numpy(), atol=ATOL)
  assert count_params(t1) == jcompress.count_params(j1)
  # the reference walks dict keys sorted, the port in module order
  assert sorted(compress.leaf_names(t1)) == sorted(jcompress.leaf_names(j1))


def test_to_stage2_matches_reference(models):
  """Stage 2 from a stage-1 model whose spectra are not flat (the
  stage-1 factors scaled towards low rank), at the default spec."""
  # sharpen each spectrum the same way in both packages: u <- u * decay
  j1 = models["j1"]
  arrays = path_arrays(j1)
  for k, a in arrays.items():
    if k.endswith("/u"):
      arrays[k] = a * np.geomspace(1.0, 0.05, a.shape[-1]).astype(np.float32)
  t1 = from_reference(
      arrays, tconfigs.get_smoke("deepspeech2-wsj").with_(dtype=torch.float32),
      device="cpu")
  j1 = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(j1), [
      jnp.asarray(arrays[k]) for k in path_arrays(j1)])
  t2 = compress.to_stage2(t1, models["tplan"])
  j2 = jcompress.to_stage2(j1, models["jplan"])
  jleaves = {leaf.name: leaf for leaf in jcompress.iter_factored_leaves(j2)}
  stage1 = products(t1)
  for leaf in iter_factored_leaves(t2):
    want = jleaves[leaf.name]
    assert leaf.rank == want.rank, leaf.name
    assert leaf.rank % 8 == 0 or leaf.rank == min(leaf.in_dim, leaf.out_dim)
    np.testing.assert_allclose(leaf.product().numpy(),
                               np.asarray(want.product()), atol=ATOL,
                               err_msg=leaf.name)
    # the seed keeps every cumulative-variance fraction off the threshold
    s = np.linalg.svd(stage1[leaf.name].astype(np.float64),
                      compute_uv=False)
    frac = np.cumsum(s * s) / np.sum(s * s)
    assert np.min(np.abs(frac - 0.9)) > 1e-5, leaf.name
  rep = compress.compression_report(t1, t2)
  jrep = jcompress.compression_report(j1, j2)
  assert rep["total_params_before"] == jrep["total_params_before"]
  assert rep["total_params_after"] == jrep["total_params_after"]
  assert rep["total_params_after"] < rep["total_params_before"]
  strip = lambda rows: sorted((dict(r, shape=tuple(r["shape"])) for r in rows),
                              key=lambda r: r["name"])
  assert strip(rep["gemms"]) == strip(jrep["gemms"])
