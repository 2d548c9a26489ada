"""The port's numpy-only copy of the synthetic speech data draws the
reference's batches exactly, for several (seed, step) pairs."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import speech as jspeech  # noqa: E402
from repro_torch.data import speech as tspeech  # noqa: E402


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_batch_at_identical(seed, step):
  kw = dict(seed=seed, global_batch=4)
  want = jspeech.batch_at(jspeech.SpeechDataConfig(**kw), step)
  got = tspeech.batch_at(tspeech.SpeechDataConfig(**kw), step)
  assert set(got) == set(want)
  for k in want:
    assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got[k], want[k])


def test_cer_identical():
  rng = np.random.RandomState(0)
  labels = rng.randint(1, 32, size=(3, 10)).astype(np.int32)
  lengths = np.array([10, 7, 4], np.int32)
  decoded = np.where(rng.rand(3, 10) < 0.8, labels, -1)
  assert tspeech.cer(decoded, labels, lengths) == \
      jspeech.cer(decoded, labels, lengths)
