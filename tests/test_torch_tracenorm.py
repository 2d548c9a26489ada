"""The port's trace-norm module (`core.tracenorm`) against the
reference's: nu(W), the explained-variance rank, the regularization loss
of both kinds and both groups, and the per-GEMM diagnostics, on weights
drawn from a numpy seed. Tolerances: f32 values within 1e-5 relative
(two LAPACK SVDs and sums in another order); ranks exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

from repro.core import tracenorm as jtn  # noqa: E402
from repro.core.factored import FactoredLinear as JLeaf  # noqa: E402
from repro_torch.core import tracenorm as tn  # noqa: E402
from repro_torch.core.factored import FactoredLinear  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


RTOL = 1e-5


def rnd(seed, shape, scale=1.0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def low_rank(seed, m, n, r):
  return rnd(seed, (m, r)) @ rnd(seed + 1, (r, n)) + rnd(seed + 2, (m, n),
                                                         0.01)


#: (name, group, arrays): factored and unfactored GEMMs of both groups,
#: one layer-stacked
LEAVES = [
    ("gru0/rec", "rec", dict(u=rnd(1, (24, 24), 0.3), v=rnd(2, (24, 72), 0.3))),
    ("gru0/nonrec", "nonrec", dict(u=rnd(3, (40, 24), 0.3),
                                   v=rnd(4, (24, 72), 0.3))),
    ("fc", "nonrec", dict(w=rnd(5, (24, 32), 0.2))),
    ("small/rec", "rec", dict(w=rnd(6, (8, 24), 0.2))),
    ("stack", "nonrec", dict(u=rnd(7, (2, 16, 16), 0.3),
                             v=rnd(8, (2, 16, 20), 0.3))),
]


def trees():
  jtree = {name: JLeaf(w=jnp.asarray(a["w"]) if "w" in a else None,
                       u=jnp.asarray(a["u"]) if "u" in a else None,
                       v=jnp.asarray(a["v"]) if "v" in a else None,
                       name=name, group=group)
           for name, group, a in LEAVES}
  ttree = nn.ModuleList([
      FactoredLinear(**{k: torch.from_numpy(x) for k, x in a.items()},
                     name=name, group=group) for name, group, a in LEAVES])
  return jtree, ttree


@pytest.mark.parametrize("shape,rank", [((16, 16), None), ((24, 40), None),
                                        ((64, 48), 3), ((30, 30), 1)])
def test_nu_coefficient_matches_reference(shape, rank):
  w = rnd(0, shape) if rank is None else low_rank(0, *shape, rank)
  got = float(tn.nu_coefficient(torch.from_numpy(w)))
  want = float(jtn.nu_coefficient(jnp.asarray(w)))
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
  assert 0.0 <= got <= 1.0 + 1e-6


@pytest.mark.parametrize("kind", ["spread", "low_rank", "degenerate"])
@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.99])
def test_rank_for_variance_matches_reference(kind, threshold):
  sigma = {"spread": np.sort(np.abs(rnd(1, (40,))))[::-1],
           "low_rank": np.array([9.0, 4.0, 1.0] + [1e-3] * 20, np.float32),
           "degenerate": np.zeros((12,), np.float32)}[kind].copy()
  got = int(tn.rank_for_variance(torch.from_numpy(sigma), threshold))
  want = int(jtn.rank_for_variance(jnp.asarray(sigma), threshold))
  assert got == want
  assert 1 <= got <= len(sigma)


@pytest.mark.parametrize("kind", ["trace", "l2", "none"])
@pytest.mark.parametrize("lambdas", [(1.0, 0.0), (0.0, 1.0), (3e-2, 1e-3)],
                         ids=["rec", "nonrec", "both"])
def test_regularization_loss_matches_reference(kind, lambdas):
  """"trace" skips the unfactored GEMMs, "l2" does not; each group takes
  its own strength."""
  jtree, ttree = trees()
  rec, nonrec = lambdas
  jcfg = jtn.RegularizerConfig(kind=kind, lambda_rec=rec, lambda_nonrec=nonrec)
  tcfg = tn.RegularizerConfig(kind=kind, lambda_rec=rec, lambda_nonrec=nonrec)
  got = float(tn.regularization_loss(ttree, tcfg))
  want = float(jtn.regularization_loss(jtree, jcfg))
  np.testing.assert_allclose(got, want, rtol=RTOL)
  if kind == "trace":
    by_hand = sum(
        tcfg.strength_for(leaf.group)
        * float(tn.variational_trace_norm_penalty(leaf.u, leaf.v))
        for leaf in ttree if leaf.is_factored)
    np.testing.assert_allclose(got, by_hand, rtol=RTOL)


def test_regularization_loss_has_gradients_on_the_factors():
  _, ttree = trees()
  for p in ttree.parameters():
    p.requires_grad_(True)
  loss = tn.regularization_loss(ttree, tn.RegularizerConfig(
      kind="trace", lambda_rec=1.0, lambda_nonrec=1.0))
  loss.backward()
  for leaf in ttree:
    if leaf.is_factored:      # d/dU (||U||^2 / 2) = U
      torch.testing.assert_close(leaf.u.grad, leaf.u.detach())
    else:                     # unfactored: skipped under "trace"
      assert leaf.w.grad is None


def test_trace_norm_metrics_match_reference():
  jtree, ttree = trees()
  got = tn.trace_norm_metrics(ttree)
  want = jtn.trace_norm_metrics(jtree)
  assert sorted(got) == sorted(want)
  assert "stack[1]" in got
  for name, row in want.items():
    for key in ("nu", "trace_norm", "frobenius"):
      np.testing.assert_allclose(float(got[name][key]), float(row[key]),
                                 rtol=RTOL, err_msg=f"{name} {key}")
    assert int(got[name]["rank90"]) == int(row["rank90"])


def test_nu_extremes():
  """Rank one gives 0; equal singular values (an orthogonal matrix) 1."""
  w = np.outer(rnd(3, (20,)), rnd(4, (12,)))
  np.testing.assert_allclose(float(tn.nu_coefficient(torch.from_numpy(w))),
                             0.0, atol=1e-5)
  q, _ = np.linalg.qr(rnd(4, (16, 16)))
  np.testing.assert_allclose(float(tn.nu_coefficient(torch.from_numpy(q))),
                             1.0, rtol=1e-5)
