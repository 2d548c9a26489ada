"""Distribution (`repro_torch.dist`, `optim.q_adam`, `optim.compress`,
`configs.specs`) against the JAX reference, and sharded execution on a
gloo world of CPU ranks.

No process group is needed for the rule tables: `rule_coverage` on a
`RuleMesh` is held entry for entry against the reference's on the same
trees, `state_shardings` against the reference's on an `AbstractMesh`.
The multi-rank checks run once for the module: one subprocess (`run_world`)
starts a world of 4 CPU ranks through a `FileStore` in a temp dir (no
TCP port, so concurrent test workers cannot collide): each takes a
shard of the compressed mean, then the (2, 2) meshes run and the
elastic checkpoint, and the ranks share out the one-device runs they
are compared with; the fixture reads what the ranks wrote.
"""
import functools
import os
import sys
import textwrap

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.layers.common import SHAPES as JSHAPES
from _torch_parity import run_world
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as tshd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama3-8b", "deepseek-v2-lite", "zamba2-7b", "xlstm-350m",
         "deepspeech2-wsj"]
MESHES = {"data2_model4": dict(data=2, model=4),
          "pod2_data2_model2": dict(pod=2, data=2, model=2)}
#: the reference's sharded-loss tolerance (tests/test_dist.py)
RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) rule parity, (b) state shardings, (c) specs: no process group.
# ---------------------------------------------------------------------------

def _by_path(entries) -> dict:
  return {(e["path"], e["field"]): e for e in entries}


def _assert_same_coverage(port, ref):
  port, ref = _by_path(port), _by_path(ref)
  assert set(port) == set(ref)
  for key, e in ref.items():
    got = port[key]
    for f in ("name", "rule", "matches", "spec", "shard_factor", "shape",
              "sharded"):
      assert got[f] == e[f], (key, f, got[f], e[f])


@functools.lru_cache(maxsize=None)
def _ref_param_specs(arch: str):
  """The reference's smoke params as ShapeDtypeStructs (one trace an
  arch for the module)."""
  return jconfigs.param_specs(jconfigs.get_smoke(arch))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_coverage_matches_reference(arch, mesh):
  """Every array leaf of the smoke tree gets the reference's rule, glob
  count, spec and shard factor, matched by path and field."""
  port = tshd.rule_coverage(tconfigs.param_specs(tconfigs.get_smoke(arch)),
                            tshd.RuleMesh(**MESHES[mesh]))
  ref = jshd.rule_coverage(_ref_param_specs(arch),
                           jshd.RuleMesh(**MESHES[mesh]))
  _assert_same_coverage(port, ref)


@pytest.fixture(scope="module")
def ptq_ds2():
  """A PTQ'd DS2 tree in both packages: the port's weights, quantized by
  each package's own `quantize_params`."""
  from _torch_parity import reference_tree
  from repro.models import deepspeech as jds
  from repro.quant import quantize_params as jquant
  from repro_torch.models.api import get_model
  from repro_torch.quant import quantize_params as tquant
  cfg = tconfigs.get_smoke("deepspeech2-wsj").with_(dtype=torch.float32)
  params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
  jcfg = jconfigs.get_smoke("deepspeech2-wsj").with_(dtype=jnp.float32)
  ref = reference_tree(params, lambda k: jds.init_model(k, jcfg))
  # the reference's quantization traced only (`rule_coverage` reads
  # shapes and dtypes)
  return tquant(params), jax.eval_shape(jquant, ref)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rule_coverage_of_a_quantized_tree(ptq_ds2, mesh):
  port, ref = ptq_ds2
  _assert_same_coverage(tshd.rule_coverage(port, tshd.RuleMesh(**MESHES[mesh])),
                        jshd.rule_coverage(ref, jshd.RuleMesh(**MESHES[mesh])))


def _flat(tree, prefix=""):
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
  return {prefix: tree}


def _jflat(tree):
  from _torch_parity import _key_str
  flat, _ = jax.tree_util.tree_flatten_with_path(tree)
  return {"/".join(_key_str(k) for k in p): x for p, x in flat}


def test_state_shardings_shard_the_long_context():
  """Full-width zamba2-7b at long_500k (meta tensors): the 524288 axis is
  sharded, leaf for leaf with the reference's specs."""
  from jax.sharding import AbstractMesh
  cfg, shape = tconfigs.get_config("zamba2-7b"), tconfigs.SHAPES["long_500k"]
  state = tconfigs.decode_state_specs(cfg, shape)
  port = _flat(tshd.state_shardings(state, tshd.RuleMesh(data=4, model=2),
                                    shape))
  ref = _jflat(jshd.state_shardings(
      jconfigs.decode_state_specs(jconfigs.get_config("zamba2-7b"),
                                  JSHAPES["long_500k"]),
      AbstractMesh((4, 2), ("data", "model")), JSHAPES["long_500k"]))
  assert set(port) == set(ref)
  for k in ref:
    assert str(port[k].spec) == str(ref[k].spec), k
  assert any(524288 in _flat(state)[k].shape and "model" in str(port[k].spec)
             for k in port)


_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same_specs(port: dict, ref: dict):
  assert set(port) == set(ref)
  for k, s in ref.items():
    assert tuple(port[k].shape) == tuple(s.shape), k
    assert port[k].dtype == _DTYPES[jnp.dtype(s.dtype)], k
    assert port[k].is_meta, k


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_specs_match_reference(arch):
  """`input_specs` and `decode_state_specs` for every shape `shapes_for`
  keeps, `param_specs` of the smoke config: the reference's shapes and
  dtypes, on the meta device."""
  assert [s.name for s in tconfigs.shapes_for(arch)] == \
      [s.name for s in jconfigs.shapes_for(arch)]
  cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
  for shape in tconfigs.shapes_for(arch):
    js = JSHAPES[shape.name]
    _same_specs(tconfigs.input_specs(cfg, shape),
                jconfigs.input_specs(jcfg, js))
    if shape.kind == "decode":
      _same_specs(_flat(tconfigs.decode_state_specs(cfg, shape)),
                  _jflat(jconfigs.decode_state_specs(jcfg, js)))
  port = tconfigs.param_specs(tconfigs.get_smoke(arch))
  _same_specs({k.replace(".", "/"): t for k, t in port.state_dict().items()},
              _jflat(_ref_param_specs(arch)))


# ---------------------------------------------------------------------------
# (d) q_adam.
# ---------------------------------------------------------------------------

def test_q_adam_tracks_the_reference():
  """100 steps on the reference's quadratic problem (tests/test_optim.py):
  the port's int8 moments track the reference's within 1e-4 (one int8
  rounding that flips between the packages moves a param by at most
  lr * (1/127) relative)."""
  from repro.optim import q_adam as jq
  from repro.optim.adamw import AdamWConfig as JCfg
  from repro_torch.optim import q_adam as tq
  from repro_torch.optim.adamw import AdamWConfig as TCfg

  jp = {"w": jnp.full((16, 32), 2.0), "b": jnp.full((32,), -1.5)}
  tp = {"w": torch.full((16, 32), 2.0), "b": torch.full((32,), -1.5)}
  js, ts = jq.init(jp), tq.init(tp)
  jgrad = jax.jit(jax.grad(lambda p: jnp.sum(p["w"] ** 2)
                           + jnp.sum(p["b"] ** 2)))
  japply = jax.jit(lambda p, g, s: jq.apply(p, g, s, 0.02, JCfg()))
  for _ in range(100):
    jp, js, _ = japply(jp, jgrad(jp), js)
    tp, ts, _ = tq.apply(tp, {k: 2.0 * v for k, v in tp.items()}, ts, 0.02,
                         TCfg())
  for k in tp:
    np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-4)
  for mom in ("m", "v"):
    for k in tp:
      np.testing.assert_allclose(
          tq._dequantize(getattr(ts, mom)[k]).numpy(),
          np.asarray(jq._dequantize(getattr(js, mom)[k])), rtol=1e-4,
          atol=1e-7)


def test_q_adam_diverges_on_ds2_as_the_reference_does():
  """q_adam's DS2 blow-up is the reference's: 4 trace-norm steps of the
  f32 smoke DS2, each step's gradients taken by the port and fed to the
  port's q_adam and to the reference's `apply` on the same tree. The two
  track each other within 1e-4 of each leaf's largest entry (their f32
  gradient-norm sums differ in order), and both step past 1e4 x lr (an
  entry whose int8 v rounds to 0 steps by m / eps), while AdamW on the
  same weights and batches steps ~1 x lr and its loss stays put."""
  from repro.optim import q_adam as jq
  from repro.optim.adamw import AdamWConfig as JCfg
  from repro_torch.core.factored import param_tree, trainable
  from repro_torch.core.tracenorm import RegularizerConfig
  from repro_torch.data.speech import SpeechDataConfig, batch_at
  from repro_torch.models.api import get_model
  from repro_torch.optim import adamw, q_adam as tq
  from repro_torch.optim.adamw import AdamWConfig as TCfg
  from repro_torch.training.trainer import TrainConfig, make_train_step
  lr = 1e-3
  cfg = tconfigs.get_smoke("deepspeech2-wsj").with_(dtype=torch.float32)
  _, step = make_train_step(cfg, TrainConfig(
      regularizer=RegularizerConfig(kind="trace", lambda_rec=1e-4,
                                    lambda_nonrec=1e-4)))
  init = get_model(cfg).init
  pq = trainable(init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu"))
  pa = trainable(init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu"))
  sq, sa = tq.init(pq), adamw.init(pa)
  # copies here and for the gradients: on the CPU `jnp.asarray` may alias
  # the numpy buffer, which the port's in-place update would then change
  # under the reference's asynchronously dispatched step
  jp = {k: jnp.asarray(v.detach().numpy().copy())
        for k, v in param_tree(pq).items()}
  js = jq.init(jp)
  japply = jax.jit(lambda p, g, s: jq.apply(p, g, s, lr,
                                            JCfg(max_grad_norm=1.0)))
  data = SpeechDataConfig(vocab_size=cfg.vocab_size, feat_dim=cfg.feat_dim,
                          global_batch=4)

  def copy(params):
    return {k: v.detach().numpy().copy()
            for k, v in param_tree(params).items()}

  def largest_step(before, after):
    return max(float(np.abs(after[k] - before[k]).max()) / lr
               for k in before)
  losses = {"q": [], "a": []}
  steps = {"q": [], "ref": [], "a": []}
  for i in range(4):
    batch = batch_at(data, i)
    for tag, params in (("q", pq), ("a", pa)):
      loss, _, grads = step.grads_of(params, batch)
      losses[tag].append(float(loss))
      before = copy(params)
      if tag == "q":
        ref_before = {k: np.asarray(v) for k, v in jp.items()}
        jp, js, _ = japply(jp, {k: jnp.asarray(g.numpy().copy())
                                for k, g in grads.items()}, js)
        pq, sq, _ = tq.apply(pq, grads, sq, lr, TCfg(max_grad_norm=1.0))
        ref_after = {k: np.asarray(v) for k, v in jp.items()}
        steps["ref"].append(largest_step(ref_before, ref_after))
        after = copy(pq)
        for k in after:
          np.testing.assert_allclose(
              after[k], ref_after[k], rtol=0,
              atol=1e-4 * float(np.abs(ref_after[k]).max()), err_msg=k)
      else:
        pa, sa, _ = adamw.apply(pa, grads, sa, lr, TCfg(max_grad_norm=1.0))
        after = copy(pa)
      steps[tag].append(largest_step(before, after))
  assert max(steps["q"]) > 1e4 and max(steps["ref"]) > 1e4, steps
  assert max(steps["a"]) < 1.1, steps
  assert losses["q"][-1] > 10 * losses["q"][0], losses
  assert losses["a"][-1] < 2 * losses["a"][0], losses


def test_q_adam_state_bytes_and_optimizer():
  """int8 moments are under 0.3x AdamW's f32 moments, and
  `make_optimizer("q_adam")` gives them."""
  from repro_torch.optim import adamw, make_optimizer, q_adam
  params = {"w": torch.zeros((256, 1024), dtype=torch.bfloat16)}
  init, apply = make_optimizer("q_adam")
  assert (init, apply) == (q_adam.init, q_adam.apply)
  sq, sa = init(params), adamw.init(params)
  f_bytes = sum(t.numel() * t.element_size() for mom in (sa.m, sa.v)
                for t in mom.values())
  assert q_adam.state_bytes(sq) < 0.3 * f_bytes


# ---------------------------------------------------------------------------
# (e), (f): one gloo world.
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    def ds2_batch():
      rng = np.random.RandomState(0)
      return 4, dict(feats=rng.randn(4, 16, 80).astype(np.float32),
                     feat_lengths=np.array([16, 12, 16, 8], np.int32),
                     labels=rng.randint(1, 32, (4, 2)).astype(np.int32),
                     label_lengths=np.array([2, 1, 2, 1], np.int32))

    def lm_batch():
      from repro_torch.data.lm import LMDataConfig, batch_at
      return 8, batch_at(LMDataConfig(vocab_size=64, seq_len=32,
                                      global_batch=8), 0)

    def cfg_of(arch):
      from repro_torch import configs
      cfg = configs.get_smoke(arch).with_(dtype=torch.float32)
      return cfg if arch == "deepspeech2-wsj" else cfg.with_(vocab_size=64)

    def train(arch, mesh, optimizer, out, tag):
      from repro_torch.core.compress import FactorizationPlan
      from repro_torch.core.factored import iter_factored_leaves, param_tree
      from repro_torch.core.schedule import TwoStageSchedule
      from repro_torch.core.svd import TruncationSpec
      from repro_torch.core.tracenorm import RegularizerConfig
      from repro_torch.dist import sharding as shd
      from repro_torch.training import TrainConfig, Trainer
      b, batch = ds2_batch() if arch == "deepspeech2-wsj" else lm_batch()
      # DS2 trains through the paper's two stages: trace norm, then the
      # transition at step 1
      sched = None if arch != "deepspeech2-wsj" else TwoStageSchedule(
          total_steps=2, transition_step=1,
          regularizer=RegularizerConfig(kind="trace", lambda_rec=1e-4,
                                        lambda_nonrec=1e-4),
          truncation=TruncationSpec(variance_threshold=0.9, round_to=8))
      tr = Trainer(cfg_of(arch), TrainConfig(lr=1e-2, optimizer=optimizer),
                   mesh=mesh, batch_size=b, device="cpu", schedule=sched,
                   plan=FactorizationPlan(min_dim=32))
      with shd.replicated_plain(mesh is not None):
        loss, _, grads = tr._step_fn.grads_of(tr.params, tr._put_batch(batch))
      out[f"{tag}/loss"] = float(shd.gather_tree(loss))
      for k, g in grads.items():
        out[f"{tag}/grad/{k}"] = shd.gather_tree(g).numpy()
        if mesh is not None:
          p = param_tree(tr.params)[k]
          assert list(g.placements) == list(p.placements), k
      tr.train_step(batch)
      for k, p in param_tree(shd.gather_params(tr.params)
                             if mesh else tr.params).items():
        out[f"{tag}/param/{k}"] = p.detach().numpy()
      if sched is not None:
        out[f"{tag}/loss2"] = tr.train_step(batch)["loss"]
        out[f"{tag}/ranks"] = np.array(
            [leaf.rank for leaf in iter_factored_leaves(tr.params)])
        out[f"{tag}/stage"] = tr.stage
      if optimizer == "q_adam":
        for k, q in tr.opt_state.m.items():
          out[f"{tag}/mscale/{k}"] = shd.gather_tree(q.scale).numpy()
          out[f"{tag}/vscale/{k}"] = shd.gather_tree(
              tr.opt_state.v[k].scale).numpy()

    def engine(policy, mesh, out, tag):
      from repro_torch.kernels import dispatch
      from repro_torch.models.api import get_model
      from repro_torch.serving.engine import LMEngine
      cfg = cfg_of("llama3-8b")
      params = get_model(cfg).init(
          cfg, generator=torch.Generator().manual_seed(0), device="cpu")
      prompts = np.random.RandomState(0).randint(0, 64, (4, 3))
      eng = LMEngine(cfg, params, batch_size=4, max_len=24, mesh=mesh,
                     kernel_policy=policy,
                     device=None if mesh is not None else "cpu")
      # admission writes each slot into the ranks' blocks: count the
      # DTensors gathered inside insert_slot
      from torch.distributed.tensor import DTensor
      from repro_torch.models.api import ModelApi
      insert, full = ModelApi.insert_slot, DTensor.full_tensor
      admits = {"calls": 0, "gathers": 0}

      def counted_full(self, *a, **k):
        admits["gathers"] += 1
        return full(self, *a, **k)

      def counted_insert(*a, **k):
        admits["calls"] += 1
        DTensor.full_tensor = counted_full
        try:
          return insert(*a, **k)
        finally:
          DTensor.full_tensor = full
      ModelApi.insert_slot = counted_insert
      try:
        with dispatch.record_dispatch() as log:
          out[f"{tag}/tokens"] = eng.generate(prompts, steps=3).tokens
      finally:
        ModelApi.insert_slot = insert
      out[f"{tag}/log"] = np.array(sorted(set(map(str, log))))
      out[f"{tag}/admits"] = np.array([admits["calls"], admits["gathers"]])
      if mesh is not None:
        kv = eng.state["dense"]["k"]
        out[f"{tag}/kv_shapes"] = np.array([kv.shape, kv.to_local().shape])

    def ds2_serve(factored, mesh, out, tag):
      from repro_torch.core.compress import FactorizationPlan, to_stage1
      from repro_torch.dist import sharding as shd
      from repro_torch.kernels import dispatch
      from repro_torch.models import deepspeech
      cfg = cfg_of("deepspeech2-wsj").with_(gru_dims=(128, 128, 256),
                                            fc_dim=128, d_model=256)
      params = deepspeech.init_model(
          cfg, generator=torch.Generator().manual_seed(0), device="cpu")
      if factored:
        params = to_stage1(params, FactorizationPlan())
      if mesh is not None:
        params = shd.distribute_params(params,
                                       shd.param_shardings(params, mesh))
      state = deepspeech.init_decode_state(cfg, 2, device="cpu")
      frames = torch.tensor(np.random.RandomState(1).randn(3, 2, 160),
                            dtype=torch.float32)
      policy = dispatch.decode_policy(2)
      lps = []
      with torch.no_grad(), shd.replicated_plain(mesh is not None), \\
          dispatch.record_dispatch() as log:
        for x in frames:
          lp, state = deepspeech.decode_step(params, state, x, cfg, policy)
          lps.append(shd.gather_tree(lp).numpy())
      out[f"{tag}/logprobs"] = np.stack(lps)
      out[f"{tag}/log"] = np.array([f"{n}:{r}" for n, r in log])

    def worker(rank, tmp):
      # a hung rank prints its stack before the test's timeout kills it
      import faulthandler
      faulthandler.dump_traceback_later(280, exit=True)
      torch.set_num_threads(1)
      import torch.distributed as dist
      from repro_torch.dist import mesh as M
      from repro_torch.optim.compress import compressed_grad_mean
      out = {}
      M.init_world(os.path.join(tmp, "store"), rank, 4, device_type="cpu")
      # (e) the compressed mean, a shard a rank
      x = np.arange(4 * 16, dtype=np.float32).reshape(4, 16) / 7.0
      mean, err = compressed_grad_mean({"g": torch.tensor(x[rank])},
                                       {"g": torch.zeros(16)})
      np.save(os.path.join(tmp, f"psum_{rank}.npy"),
              np.stack([mean["g"].numpy(), err["g"].numpy()]))
      # (f)
      try:
        M.make_mesh((3, 2), ("data", "model"), device_type="cpu")
      except ValueError as e:
        out["err/too_few"] = str(e)
      try:
        M.make_mesh((2, 2), ("data",), device_type="cpu")
      except ValueError as e:
        out["err/rank"] = str(e)
      mesh = M.make_mesh((2, 2), ("data", "model"), device_type="cpu")
      # llama3-8b steps q_adam, whose first update is AdamW's (the moments
      # are quantized only for storage); DS2 AdamW through the transition
      jobs = [(train, (arch, opt), f"{arch}/{opt}") for arch, opt in
              (("llama3-8b", "q_adam"), ("deepspeech2-wsj", "adamw"))]
      jobs += [(engine, ("cuda",), "engine/cuda")]
      jobs += [(ds2_serve, (f,), f"ds2/{f}") for f in (False, True)]
      for fn, args, tag in jobs:            # every rank, on the mesh
        fn(*args[:1], mesh, *args[1:], out, f"{tag}/mesh")
      # the one-device runs, spread over the ranks
      for i, (fn, args, tag) in enumerate(jobs):
        if i % 4 == rank:
          fn(*args[:1], None, *args[1:], out, f"{tag}/one")
      # the elastic checkpoint: saved Shard(0) on ("data",), restored
      # Shard(1) on ("model",)
      from torch.distributed.tensor import Shard
      from repro_torch.checkpoint import CheckpointManager
      from repro_torch.dist import sharding as shd
      m_data = M.make_mesh((4,), ("data",), device_type="cpu")
      m_model = M.make_mesh((4,), ("model",), device_type="cpu")
      full = torch.arange(64.0).reshape(8, 8)
      xd = shd.distribute_tensor_local(full, m_data, [Shard(0)])
      mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
      mgr.save(0, {"x": xd})
      tgt = shd.NamedSharding(m_model, shd.P(None, "model"))
      back, _ = mgr.restore({"x": xd}, shardings={"x": tgt})
      out["ckpt/placements"] = str(list(back["x"].placements))
      out["ckpt/local_shape"] = list(back["x"].to_local().shape)
      out["ckpt/equal"] = bool(torch.equal(back["x"].full_tensor(), full))
      np.savez(os.path.join(tmp, f"out_{rank}.npz"),
               **{k: np.asarray(v) for k, v in out.items()
                  if rank == 0 or "/one/" in k})
      dist.destroy_process_group()

    if __name__ == "__main__":
      # importing the distribution modules starts no process group and
      # touches no CUDA state
      import torch.distributed as dist
      import repro_torch.dist, repro_torch.launch.mesh  # noqa: E401,F401
      import repro_torch.optim.compress  # noqa: F401
      with open(os.path.join(sys.argv[1], "import.json"), "w") as f:
        json.dump({"group": dist.is_initialized(),
                   "cuda": torch.cuda.is_initialized()}, f)
      mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp("world"))
  script = os.path.join(tmp, "worker.py")
  with open(script, "w") as f:
    f.write(WORKER)
  env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
             OMP_NUM_THREADS="1")
  out = run_world([sys.executable, script, tmp], env, timeout=300)
  assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
  with open(os.path.join(tmp, "import.json")) as f:
    res = {"import": json.load(f)}
  for r in range(4):
    res.update(np.load(os.path.join(tmp, f"out_{r}.npz")))
  res["psum"] = [np.load(os.path.join(tmp, f"psum_{r}.npy"))
                 for r in range(4)]
  return res


def test_importing_dist_starts_no_process_group(world):
  assert world["import"] == {"group": False, "cuda": False}


def test_make_mesh_refuses_a_bad_shape(world):
  assert "needs 6 devices, got 4" in str(world["err/too_few"])
  assert "rank mismatch" in str(world["err/rank"])


def test_sharded_transition_matches_one_device(world):
  """DS2 on a (2, 2) mesh through the transition: the factors gathered,
  truncated on every rank alike and laid out again by the same rules;
  the stage-2 step's loss within rtol 2e-4 of one device's, the same
  ranks."""
  pre = "deepspeech2-wsj/adamw"
  assert int(world[f"{pre}/mesh/stage"]) == 2
  np.testing.assert_array_equal(world[f"{pre}/mesh/ranks"],
                                world[f"{pre}/one/ranks"])
  np.testing.assert_allclose(world[f"{pre}/mesh/loss2"],
                             world[f"{pre}/one/loss2"], rtol=RTOL)


@pytest.mark.parametrize("arch,opt", [("llama3-8b", "q_adam"),
                                      ("deepspeech2-wsj", "adamw")])
def test_sharded_train_step_matches_one_device(world, arch, opt):
  """A (2, 2) mesh step: the loss and every gradient (already reduced
  into its parameter's placements) within rtol 2e-4 of the one-device
  step, and the updated parameters too (an atol of 1e-6 of the leaf's
  largest entry for the entries near 0). AdamW's first step moves a
  parameter by lr * g / (|g| + eps): an entry whose gradient is under
  1e-3 of its leaf's largest, where the gradient check's own atol (1e-6
  of the largest, f32 summation order) leaves g free by a percent or
  more, is held by the gradient check alone. (q_adam's first update is
  AdamW's: it quantizes the moments for storage only.)"""
  pre = f"{arch}/{opt}"
  np.testing.assert_allclose(world[f"{pre}/mesh/loss"],
                             world[f"{pre}/one/loss"], rtol=RTOL)
  keys = [k[len(f"{pre}/one/grad/"):] for k in world
          if k.startswith(f"{pre}/one/grad/")]
  assert keys
  for k in keys:
    g1, g0 = world[f"{pre}/mesh/grad/{k}"], world[f"{pre}/one/grad/{k}"]
    np.testing.assert_allclose(g1, g0, rtol=RTOL,
                               atol=1e-6 * float(np.abs(g0).max()) + 1e-12)
    live = np.abs(g0) > 1e-3 * float(np.abs(g0).max())
    p0 = world[f"{pre}/one/param/{k}"]
    np.testing.assert_allclose(world[f"{pre}/mesh/param/{k}"][live],
                               p0[live], rtol=RTOL,
                               atol=1e-6 * float(np.abs(p0).max()),
                               err_msg=k)


def test_q_adam_sharded_scales_equal_unsharded(world):
  """q_adam under a (2, 2) mesh: every moment's per-row scale (a max over
  the model ranks for a column-split parameter) equals the one-device
  scale."""
  pre = "llama3-8b/q_adam"
  keys = [k.split("/mscale/")[1] for k in world
          if k.startswith(f"{pre}/one/mscale/")]
  assert keys
  for k in keys:
    for mom in ("mscale", "vscale"):
      np.testing.assert_allclose(world[f"{pre}/mesh/{mom}/{k}"],
                                 world[f"{pre}/one/{mom}/{k}"], rtol=RTOL,
                                 atol=1e-12)


def test_lm_engine_on_a_mesh_emits_the_one_device_tokens(world):
  """Greedy tokens under the "cuda" policy (its plain versions here, on
  local shards where a GEMM reaches a kernel regime; the plain path on
  the DTensors elsewhere) and the same routing decisions."""
  np.testing.assert_array_equal(world["engine/cuda/mesh/tokens"],
                                world["engine/cuda/one/tokens"])
  np.testing.assert_array_equal(world["engine/cuda/mesh/log"],
                                world["engine/cuda/one/log"])
  regimes = {s.split("'")[3] for s in world["engine/cuda/one/log"]}
  assert regimes == {"decode_matvec", "jnp"}


def test_lm_engine_on_a_mesh_admits_without_a_gather(world):
  """Each of the 4 admissions writes its slot into the ranks' blocks of
  the decode state (batch on "data", length on "model") and gathers no
  DTensor; the KV cache stays split."""
  assert list(world["engine/cuda/mesh/admits"]) == [4, 0]
  full, local = world["engine/cuda/mesh/kv_shapes"]
  assert local[-4:-2].tolist() == [full[-4] // 2, full[-3] // 2]


@pytest.mark.parametrize("factored", [False, True])
def test_sharded_dispatch_matches_one_device(world, factored):
  """DS2 frame steps at the 128-lane widths under the "cuda" policy on
  model-split weights: the kernels' plain versions on local shards
  (gru_cell on a gathered U, the rank-local factors' two launches around
  one all-reduce, row-parallel partial sums) give the one-device
  log-probs, with the same routing decisions."""
  pre = f"ds2/{factored}"
  np.testing.assert_array_equal(world[f"{pre}/mesh/log"],
                                world[f"{pre}/one/log"])
  regimes = {s.split(":")[1] for s in world[f"{pre}/one/log"]}
  # the 32-way output head stays under the 128-lane gate
  assert regimes == ({"lowrank_gemm", "jnp"} if factored else
                     {"decode_matvec", "gru_cell", "jnp"})
  np.testing.assert_allclose(world[f"{pre}/mesh/logprobs"],
                             world[f"{pre}/one/logprobs"], rtol=1e-5,
                             atol=1e-5)


def test_compressed_grad_mean_matches_reference(world):
  """The int8 mean over 4 ranks: the reference's `compressed_psum` under
  `jax.vmap(axis_name="pod")` on the same 4 shards gives the same mean
  and residuals, and the mean is within 2% of the exact one."""
  from repro.optim.compress import compressed_psum
  x = np.arange(4 * 16, dtype=np.float32).reshape(4, 16) / 7.0
  jm, je = jax.vmap(lambda a, e: compressed_psum(a, "pod", e),
                    axis_name="pod")(jnp.asarray(x), jnp.zeros((4, 16)))
  for r, got in enumerate(world["psum"]):
    np.testing.assert_allclose(got[0], np.asarray(jm[r]), rtol=1e-6)
    np.testing.assert_allclose(got[1], np.asarray(je[r]), atol=1e-6)
  want = x.mean(axis=0)
  rel = np.linalg.norm(world["psum"][0][0] - want) / np.linalg.norm(want)
  assert rel < 0.02, rel


def test_elastic_checkpoint_reshards(world):
  """Saved as Shard(0) over ("data",), restored as Shard(1) over
  ("model",): the values are the saved ones, in the layout asked for."""
  assert bool(world["ckpt/equal"])
  assert str(world["ckpt/placements"]) == "[Shard(dim=1)]"
  assert list(world["ckpt/local_shape"]) == [8, 2]
