"""The port's CTC loss and greedy decode against the reference's
(`repro.models.ctc`) and against `torch.nn.functional.ctc_loss`, on
log-probs drawn from a numpy seed. The batches hold a label sequence of
length 0, repeated labels (which forbid the blank skip) and frames past
`logit_lengths` (which must not count).

Tolerances, f32: the loss within 1e-5 relative, its gradient with
respect to the log-probs within 1e-5 (the same log-space recursion in
both, summed in another order); the decode exactly."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ctc as jctc  # noqa: E402
from repro_torch.models import ctc  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


T, V = 14, 6
#: (label sequence, logit length) per batch row: length 0, repeats (a
#: run of three, an alternation), and rows with frames past their length
ROWS = [([], 9), ([2, 2, 3], T), ([1, 2, 1, 2], 11), ([4, 4, 4], T),
        ([5], 4), ([3, 1, 5, 2, 4], 12)]


def batch(seed: int):
  rng = np.random.RandomState(seed)
  logits = rng.randn(len(ROWS), T, V).astype(np.float32) * 2
  lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
  width = max(len(r) for r, _ in ROWS)
  labels = np.zeros((len(ROWS), width), np.int32)
  for i, (r, _) in enumerate(ROWS):
    labels[i, :len(r)] = r
    labels[i, len(r):] = rng.randint(1, V, size=width - len(r))  # padding
  lens = np.array([n for _, n in ROWS], np.int32)
  label_lens = np.array([len(r) for r, _ in ROWS], np.int32)
  return lp.astype(np.float32), lens, labels, label_lens


def port_loss_and_grad(lp, lens, labels, label_lens):
  x = torch.from_numpy(lp).requires_grad_(True)
  loss = ctc.ctc_loss(x, torch.from_numpy(lens), torch.from_numpy(labels),
                      torch.from_numpy(label_lens))
  (g,) = torch.autograd.grad(loss, x)
  return float(loss.detach()), g.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_and_grad_match_reference(seed):
  lp, lens, labels, label_lens = batch(seed)
  got, g_got = port_loss_and_grad(lp, lens, labels, label_lens)
  f = lambda x: jctc.ctc_loss(x, jnp.asarray(lens), jnp.asarray(labels),
                              jnp.asarray(label_lens))
  want, g_want = jax.value_and_grad(f)(jnp.asarray(lp))
  np.testing.assert_allclose(got, float(want), rtol=1e-5)
  np.testing.assert_allclose(g_got, np.asarray(g_want), atol=1e-5)
  # frames past a row's logit length take no gradient
  for i, (_, n) in enumerate(ROWS):
    assert not g_got[i, n:].any()


@pytest.mark.parametrize("seed", [0, 3])
def test_ctc_loss_matches_torch_ctc(seed):
  """A second check: torch's own CTC with reduction="none", then the
  batch mean (its "mean" mode divides by the target lengths)."""
  lp, lens, labels, label_lens = batch(seed)
  got, _ = port_loss_and_grad(lp, lens, labels, label_lens)
  nll = torch.nn.functional.ctc_loss(
      torch.from_numpy(lp).transpose(0, 1), torch.from_numpy(labels).long(),
      torch.from_numpy(lens).long(), torch.from_numpy(label_lens).long(),
      blank=0, reduction="none")
  np.testing.assert_allclose(got, float(nll.mean()), rtol=1e-5)


def brute_force_ctc(log_probs, labels, blank=0):
  """-log of the sum over every alignment (tiny cases only)."""
  t, v = log_probs.shape
  total = -np.inf
  for path in itertools.product(range(v), repeat=t):
    collapsed = [s for j, s in enumerate(path) if j == 0 or s != path[j - 1]]
    if [s for s in collapsed if s != blank] == list(labels):
      total = np.logaddexp(total, sum(log_probs[i, s]
                                      for i, s in enumerate(path)))
  return -total


@pytest.mark.parametrize("labels", [[1], [1, 1], [2, 1, 2]])
def test_ctc_matches_brute_force(labels):
  rng = np.random.RandomState(len(labels))
  logits = rng.randn(5, 4)
  lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
  got = ctc.ctc_loss(torch.from_numpy(lp)[None], torch.tensor([5]),
                     torch.tensor([labels + [0] * (4 - len(labels))]),
                     torch.tensor([len(labels)]))
  np.testing.assert_allclose(float(got), brute_force_ctc(lp, labels),
                             rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_decode_matches_reference(seed):
  lp, lens, _, _ = batch(seed)
  # sharpen so repeats and blanks appear in the best path
  lp = lp.copy()
  lp[:, ::3, 0] += 3.0
  lp[:, 1::4, 2] += 4.0
  got = ctc.ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens))
  want = jctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lens))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert (got[:, -1] == -1).any()


def test_ctc_loss_of_labels_of_width_zero_is_the_blank_path():
  """Labels of width 0 (the reference cannot index them): the loss is
  the all-blank path's."""
  lp, lens, _, _ = batch(4)
  empty, zero = np.zeros((len(ROWS), 0), np.int32), np.zeros(len(ROWS),
                                                             np.int32)
  got, _ = port_loss_and_grad(lp, lens, empty, zero)
  blank_path = np.mean([-lp[i, :n, 0].sum() for i, (_, n) in enumerate(ROWS)])
  np.testing.assert_allclose(got, blank_path, rtol=1e-5)
