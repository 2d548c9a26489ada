"""The DeepSeek family's loss against the reference's, on the CPU at the
SMOKE configs in f32: `loss_fn` (cross-entropy, the MoE aux loss and
deepseek-v3's MTP head) and its gradients on `deepseek-v3-671b`, and
`launch/train.py` through both stages with both configs.

Tolerances: the loss and its parts within 1e-5 relative, each leaf's
gradient within 1e-4 relative in norm (f32 forward and backward, summed
in another order). Routes are continuous draws with no exact ties (see
`test_torch_deepseek.py`).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays, reference_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.factored import param_tree, trainable  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


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


# ----------------------------------------------------------------------------
# The loss and its gradients.
# ----------------------------------------------------------------------------

def test_loss_mtp_and_gradients_match_reference():
  """deepseek-v3's loss = xent + 1e-3 aux + 0.3 MTP xent: the total, its
  metrics and every leaf's gradient (the router's through the
  renormalized top-k weights and the aux loss, the expert stacks', the
  MTP head's) against jax.value_and_grad of the reference's."""
  arch = "deepseek-v3-671b"
  port = transformer.init_lm(tcfg(arch), device="cpu",
                             generator=torch.Generator().manual_seed(0))
  jp = reference_tree(port, lambda k: jtf.init_lm(k, jcfg(arch)))
  batch = lm.batch_at(lm.LMDataConfig(vocab_size=512, seq_len=32,
                                         global_batch=4), 0)

  def loss(p):
    return jtf.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jcfg(arch))
  (want, want_m), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
  want_grads = path_arrays(grads)
  params = trainable(bridge.from_reference(path_arrays(jp), tcfg(arch),
                                           device="cpu"))
  got, metrics = transformer.loss_fn(params, batch, tcfg(arch))
  assert sorted(metrics) == ["moe_aux", "mtp", "xent"]
  np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
  for k in metrics:
    np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]),
                               rtol=1e-5, err_msg=k)
  tree = param_tree(params)
  grads = dict(zip(tree, torch.autograd.grad(got, list(tree.values()))))
  assert sorted(grads) == sorted(want_grads)
  assert {"moe_layers/moe/router", "mtp/proj/w", "mtp/norm",
          "moe_layers/moe/w_down/w", "mtp/layer/attn/wq_b/w"} <= set(grads)
  for k, g in want_grads.items():
    rel = np.linalg.norm(grads[k].numpy() - g) / max(np.linalg.norm(g), 1e-30)
    assert rel < 1e-4, (k, rel)


# ----------------------------------------------------------------------------
# The entry point.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "deepseek-v2-lite"])
def test_launch_train_runs_both_stages(capsys, arch):
  """`launch.train --arch <deepseek> --device cpu --two-stage` end to
  end: loss lines for both stages with the MoE aux loss (and MTP's
  cross-entropy for v3), the trace-norm diagnostics, a finite final
  loss."""
  out = train_cli.main(["--arch", arch, "--device", "cpu", "--steps", "4",
                        "--batch", "2", "--seq", "32", "--two-stage",
                        "--transition", "2"])
  text = capsys.readouterr().out
  assert "stage 1" in text and "stage 2" in text and "moe_aux" in text
  assert ("mtp" in text) == (arch == "deepseek-v3-671b")
  assert "trace-norm diagnostics" in text and "rank90=" in text
  assert json.loads(text.strip().splitlines()[-1]) == out
  assert np.isfinite(out["final_loss"])
