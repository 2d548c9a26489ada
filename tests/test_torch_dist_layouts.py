"""The layouts only the dry run uses (the reference's
`src/repro/launch/dryrun.py`), run by the port's dry run's own builders
on real tensors: `build_train` under both of its parameter policies
("zero1": gradients and moments 2-D; "fsdp": the parameters too),
`build_prefill` on FSDP-laid weights, and `build_decode` (expert stacks
2-D, with and without FSDP weights) stepped greedily — on a gloo world
of 4 CPU ranks as a (2, 2) ("data", "model") mesh, against the same
programs on one device.

One subprocess (`run_world`) starts the world; every rank runs each job
on the mesh, the ranks share out the one-device runs, and the fixture
merges what they wrote. Torch and the BLAS pools run one thread a rank.
"""
import os
import sys
import textwrap

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from _torch_parity import run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference's sharded-loss tolerance (tests/test_dist.py), and the
#: gradients' of each leaf's largest entry (tests/test_torch_dist_families.py)
RTOL, GRAD_ATOL = 2e-4, 1e-5

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  """Torch and the BLAS pools on one thread here (the subprocesses pin
  their own): the suite runs files in parallel workers."""
  import torch
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(1):
    yield
  torch.set_num_threads(n)


WORKER = textwrap.dedent('''
    import os, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    B, S, MAX_LEN = 4, 16, 24

    def cfg_of(arch):
      from repro_torch import configs
      return configs.get_smoke(arch).with_(dtype=torch.float32,
                                           vocab_size=64)

    def batch_of():
      toks = np.random.RandomState(0).randint(0, 64, (B, S + 1))
      return dict(tokens=toks[:, :-1], targets=toks[:, 1:])

    def on_data(t, mesh):
      return any(p.is_shard() for p, n in zip(t.placements,
                                              mesh.mesh_dim_names)
                 if n == "data")

    def init(cfg):
      from repro_torch.models.api import get_model
      return get_model(cfg).init(
          cfg, generator=torch.Generator().manual_seed(0), device="cpu")

    def train(arch, mesh, out, tag, optimizer="adamw", policy="zero1"):
      """Two microbatches' loss and gradients, then one step."""
      from repro_torch.core.factored import param_tree, trainable
      from repro_torch.dist import sharding as shd
      from repro_torch.launch import dryrun
      from repro_torch.layers.common import ShapeConfig
      from repro_torch.optim import AdamWConfig
      from repro_torch.training import TrainConfig, make_train_step
      cfg = cfg_of(arch)
      params = init(cfg)
      batch = {k: torch.from_numpy(v) for k, v in batch_of().items()}
      if mesh is None:
        # the dry run's step on one device
        tc = TrainConfig(lr=1e-3, optimizer=optimizer, microbatches=2,
                         adam=AdamWConfig(max_grad_norm=1.0))
        opt_init, step_fn = make_train_step(cfg, tc)
        params = trainable(params)
        loss, _, grads = step_fn.grads_of(params, batch)
        step_fn(params, opt_init(params), batch, 0)
      else:
        # "fsdp" is the policy the dry run takes for a config too large
        # to train TP-resident (deepseek-v3-671b at full width)
        chosen = dryrun.train_param_policy
        dryrun.train_param_policy = lambda cfg, mesh: policy
        try:
          fn, (params, opt_state, _), _ = dryrun.build_train(
              cfg, ShapeConfig("train", "train", S, B), mesh, optimizer,
              params=params, batch=batch)
        finally:
          dryrun.train_param_policy = chosen
        with shd.replicated_plain():
          loss, _, grads = fn.grads_of()
          fn()
        moments = [getattr(m, "q", m) for m in opt_state.m.values()]
        tree = param_tree(params)
        out[f"{tag}/split"] = np.array([
            sum(on_data(t, mesh) for t in tree.values()),
            sum(on_data(g, mesh) for g in grads.values()),
            sum(on_data(m, mesh) for m in moments), len(tree)])
        params = shd.gather_params(params)
      out[f"{tag}/loss"] = float(shd.gather_tree(loss))
      for k, g in grads.items():
        out[f"{tag}/grad/{k}"] = shd.gather_tree(g).numpy()
      for k, p in param_tree(params).items():
        out[f"{tag}/param/{k}"] = p.detach().numpy()

    def prefill(arch, mesh, out, tag):
      """`forward(last_only=True)` on weights laid out 2-D."""
      from repro_torch.dist import sharding as shd
      from repro_torch.launch import dryrun
      from repro_torch.layers.common import ShapeConfig
      from repro_torch.models.api import get_model
      cfg = cfg_of(arch)
      params = init(cfg)
      toks = torch.from_numpy(batch_of()["tokens"])
      with torch.no_grad():
        if mesh is None:
          logits = get_model(cfg).forward(params, toks, cfg, last_only=True)
        else:
          fn, (params, _), _ = dryrun.build_prefill(
              cfg, ShapeConfig("prefill", "prefill", S, B), mesh, fsdp=True,
              params=params, batch={"tokens": toks})
          out[f"{tag}/split"] = np.array(sum(
              on_data(t, mesh) for t in params.parameters()))
          with shd.replicated_plain():
            logits = fn()
      out[f"{tag}/logits"] = shd.gather_tree(logits).numpy()

    def decode(arch, mesh, out, tag, fsdp=False):
      """Three greedy serve steps from a zero cache."""
      from repro_torch.dist import sharding as shd
      from repro_torch.launch import dryrun
      from repro_torch.layers.common import ShapeConfig
      from repro_torch.models.api import get_model
      cfg = cfg_of(arch)
      api = get_model(cfg)
      params = init(cfg)
      state = api.init_decode_state(cfg, B, MAX_LEN, device="cpu")
      tok = torch.from_numpy(
          np.random.RandomState(0).randint(0, 64, (B, 1)))
      pos = torch.zeros((B,), dtype=torch.int64)
      if mesh is not None:
        step, (params, _, batch), _ = dryrun.build_decode(
            cfg, ShapeConfig("decode", "decode", MAX_LEN, B), mesh, fsdp,
            params=params, state=state,
            batch={"token": tok.clone(), "positions": pos.clone()})
        out[f"{tag}/split"] = np.array(sum(
            on_data(t, mesh) for t in params.parameters()))
      toks, logits = [], []
      with torch.no_grad(), shd.replicated_plain(mesh is not None):
        for i in range(3):
          if mesh is None:
            lg, state = api.decode_step(params, state, tok, pos, cfg)
          else:
            shd.assign(batch["token"], tok)
            shd.assign(batch["positions"], pos)
            lg, _ = step()
          lg = shd.gather_tree(lg)
          logits.append(lg.numpy())
          tok = lg[:, -1].argmax(-1)[:, None]
          pos = pos + 1
          toks.append(tok.numpy())
      out[f"{tag}/logits"] = np.stack(logits)
      out[f"{tag}/tokens"] = np.concatenate(toks, 1)

    JOBS = [
        ("zero1", train, "llama3-8b", {}),
        ("fsdp", train, "llama3-8b", dict(policy="fsdp")),
        ("fsdp_q", train, "deepseek-v3-671b",
         dict(policy="fsdp", optimizer="q_adam")),
        ("prefill", prefill, "llama3-8b", {}),
        ("expert_2d", decode, "deepseek-v2-lite", {}),
        ("fsdp_2d", decode, "deepseek-v3-671b", dict(fsdp=True)),
    ]

    def worker(rank, tmp):
      # a crashed rank prints its stack, and so does a hung one before
      # the test's timeout kills it
      import faulthandler
      faulthandler.enable(all_threads=True)
      faulthandler.dump_traceback_later(240, exit=True)
      torch.set_num_threads(1)
      import torch.distributed as dist
      from repro_torch.dist import mesh as M
      M.init_world(os.path.join(tmp, "store"), rank, 4, device_type="cpu")
      mesh = M.make_mesh((2, 2), ("data", "model"), device_type="cpu")
      out = {}
      for name, fn, arch, kw in JOBS:             # every rank, on the mesh
        fn(arch, mesh, out, f"{name}/mesh", **kw)
      for i, (name, fn, arch, kw) in enumerate(JOBS):   # one device
        if i % 4 == rank:
          fn(arch, None, out, f"{name}/one",
             **{k: v for k, v in kw.items() if k == "optimizer"})
      np.savez(os.path.join(tmp, f"out_{rank}.npz"),
               **{k: np.asarray(v) for k, v in out.items()
                  if rank == 0 or "/mesh" not in k})
      dist.destroy_process_group()

    if __name__ == "__main__":
      mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp("layouts"))
  script = os.path.join(tmp, "worker.py")
  with open(script, "w") as f:
    f.write(WORKER)
  env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
             OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
             MKL_NUM_THREADS="1")
  out = run_world([sys.executable, script, tmp], env, timeout=300)
  assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
  res = {}
  for r in range(4):
    res.update(np.load(os.path.join(tmp, f"out_{r}.npz")))
  return res


def _keys(world, pre: str, kind: str) -> list:
  head = f"{pre}/one/{kind}/"
  keys = [k[len(head):] for k in world if k.startswith(head)]
  assert keys
  return keys


def _close_to_leaf(got, want, err_msg=""):
  atol = GRAD_ATOL * float(np.abs(want).max()) + 1e-12
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                             err_msg=err_msg)


@pytest.mark.parametrize("job", ["zero1", "fsdp", "fsdp_q"])
def test_training_layouts_match_one_device(world, job):
  """The loss and every gradient of two microbatches, then the step's
  parameters where their gradient is live (an entry under 1e-3 of its
  leaf's largest moves by lr * g / (|g| + eps), which the gradient check
  already holds)."""
  np.testing.assert_allclose(world[f"{job}/mesh/loss"],
                             world[f"{job}/one/loss"], rtol=RTOL)
  for k in _keys(world, job, "grad"):
    _close_to_leaf(world[f"{job}/mesh/grad/{k}"],
                   world[f"{job}/one/grad/{k}"], k)
  for k in _keys(world, job, "param"):
    g0 = world[f"{job}/one/grad/{k}"]
    live = np.abs(g0) > 1e-3 * float(np.abs(g0).max())
    _close_to_leaf(world[f"{job}/mesh/param/{k}"][live],
                   world[f"{job}/one/param/{k}"][live], k)


@pytest.mark.parametrize("job", ["zero1", "fsdp", "fsdp_q"])
def test_training_layouts_split_the_data_axis(world, job):
  """"zero1": parameters TP-resident, gradients and moments 2-D; "fsdp":
  all three 2-D (every leaf the data degree divides)."""
  params, grads, moments, n = world[f"{job}/mesh/split"]
  assert grads > 0 and moments == grads
  assert params == (0 if job == "zero1" else grads)
  assert grads >= n // 2


def test_fsdp_prefill_matches_one_device(world):
  assert world["prefill/mesh/split"] > 0
  np.testing.assert_allclose(world["prefill/mesh/logits"],
                             world["prefill/one/logits"], rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize("job", ["expert_2d", "fsdp_2d"])
def test_serving_layouts_emit_the_one_device_tokens(world, job):
  assert world[f"{job}/mesh/split"] > 0
  np.testing.assert_allclose(world[f"{job}/mesh/logits"],
                             world[f"{job}/one/logits"], rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_array_equal(world[f"{job}/mesh/tokens"],
                                world[f"{job}/one/tokens"])
