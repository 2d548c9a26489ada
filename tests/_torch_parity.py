"""Shared helpers of the `test_torch_*` parity tests: the small DS2
widths both packages run at, and the carry of JAX params into the port
through `repro_torch.bridge` (keys are the reference's checkpoint path
strings)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.bridge import from_reference

#: DS2 widths at which every GEMM of the frame step passes the 128-lane
#: gate, so the JAX reference reaches its Pallas kernels (f32, CPU)
SMALL = dict(gru_dims=(128, 128, 256), fc_dim=128, d_model=256)


def jax_cfg():
  return jconfigs.get_smoke("deepspeech2-wsj").with_(dtype=jnp.float32,
                                                     **SMALL)


def torch_cfg():
  return tconfigs.get_smoke("deepspeech2-wsj").with_(dtype=torch.float32,
                                                     **SMALL)


def _key_str(k) -> str:
  for attr in ("key", "name", "idx"):
    if hasattr(k, attr):
      return str(getattr(k, attr))
  return str(k)


def path_arrays(params) -> dict:
  """{checkpoint path string: np.ndarray} of a JAX param tree."""
  flat, _ = jax.tree_util.tree_flatten_with_path(params)
  return {"/".join(_key_str(k) for k in path): np.asarray(leaf)
          for path, leaf in flat}


def bridged(params, cfg=None):
  """The JAX params as the port's DS2 module on the CPU."""
  return from_reference(path_arrays(params), cfg or torch_cfg(),
                        device="cpu")


def collapse(best_row) -> list:
  prev, out = -1, []
  for lab in best_row:
    if lab != 0 and lab != prev:
      out.append(int(lab))
    prev = lab
  return out


def reference_tree(params, init):
  """The port's `params` as the reference's param tree: its structure
  from `jax.eval_shape` of the reference's `init(key)` (nothing is drawn
  or compiled), its leaves the port's weights by checkpoint path (a bf16
  leaf, which `to_reference` gives as its uint16 view, viewed back)."""
  from repro_torch.bridge import to_reference
  arrays = to_reference(params)
  flat, tree = jax.tree_util.tree_flatten_with_path(
      jax.eval_shape(init, jax.random.PRNGKey(0)))
  leaves = []
  for path, shape in flat:
    a = arrays["/".join(_key_str(k) for k in path)]
    if shape.dtype == jnp.bfloat16 and a.dtype == np.uint16:
      a = a.view(jnp.bfloat16)
    leaves.append(jnp.asarray(a))
  return jax.tree_util.tree_unflatten(tree, leaves)


def run_world(args: list, env: dict, timeout: float):
  """Run a multi-rank worker script (`args`) in a session of its own and
  return its `subprocess.CompletedProcess`; on `timeout` kill the whole
  session, the ranks it spawned included (a rank left waiting in a
  collective would otherwise spin on after the test), and raise
  `subprocess.TimeoutExpired` with what it printed."""
  import os
  import signal
  import subprocess
  proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, env=env,
                          start_new_session=True)
  try:
    out, err = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    out, err = proc.communicate()
    raise subprocess.TimeoutExpired(args, timeout, output=out, stderr=err)
  return subprocess.CompletedProcess(args, proc.returncode, out, err)
