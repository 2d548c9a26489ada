"""Sharded execution of the DeepSeek, zamba, xLSTM and Whisper families,
and of speculation and the prefix cache, on a gloo world of CPU ranks,
against the same runs on one device; and the port's constraint sites
against the reference's.

The constraint sites need no process group: each family's forward (for
Whisper, `encode`), `loss_fn`, `decode_step` and `decode_window` run
once with a `cs` that records the logical names it is given, the
reference's traced by `jax.make_jaxpr` (nothing executes; every
`lax.scan` body is recorded once and repeated its trip count), the
port's in one CPU call. The names must come in the same order.

The multi-rank checks run once for the module: one subprocess (`run_world`)
starts a world of 4 CPU ranks through a `FileStore` in a temp dir, every
rank runs each job on a (2, 2) ("data", "model") mesh (and two training
jobs on the same ranks as a (1, 4) mesh), the ranks share out the same
jobs on one device, and the fixture merges what they wrote.
Torch and the BLAS pools run one thread a rank.
"""
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from _torch_parity import run_world
from repro_torch import configs as tconfigs
from repro_torch.models import api as tapi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the families this module puts on a mesh (the dense transformer and
#: DS2 are `tests/test_torch_dist.py`'s)
ARCHS = ["deepseek-v2-lite", "deepseek-v3-671b", "zamba2-7b", "xlstm-350m",
         "whisper-small"]
#: the reference's sharded-loss tolerance (tests/test_dist.py)
RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The constraint sites: no process group.
# ---------------------------------------------------------------------------

def _ref_names(trace) -> list:
  """The logical names `trace(cs)` passes to `cs`, in order, each
  `lax.scan` body's repeated its trip count."""
  seq = []

  def cs(x, name):
    seq.append(name)
    return x
  scan = jax.lax.scan

  def counted_scan(f, init, xs=None, length=None, **kw):
    seq.append(("<", length if length is not None
                else jax.tree.leaves(xs)[0].shape[0]))
    out = scan(f, init, xs, length=length, **kw)
    seq.append((">",))
    return out
  jax.lax.scan = counted_scan
  try:
    trace(cs)
  finally:
    jax.lax.scan = scan

  def expand(i):
    out = []
    while i < len(seq):
      e = seq[i]
      if isinstance(e, str):
        out.append(e)
        i += 1
      elif e[0] == "<":
        body, i = expand(i + 1)
        out += body * e[1]
      else:
        return out, i + 1
    return out, i
  return expand(0)[0]


def _port_names(run) -> list:
  seq = []

  def cs(x, name):
    seq.append(name)
    return x
  run(cs)
  return seq


NAME_ARCHS = ["llama3-8b"] + ARCHS
PROGRAMS = ["forward", "loss_fn", "decode_step", "decode_window"]


def _programs(arch: str) -> dict:
  """{program: (reference trace(cs), port run(cs))} at a small size."""
  b, s, max_len = 2, 16, 24
  jcfg = jconfigs.get_smoke(arch).with_(vocab_size=64, dtype=jnp.float32)
  tcfg = tconfigs.get_smoke(arch).with_(vocab_size=64, dtype=torch.float32)
  ja, ta = japi.get_model(jcfg), tapi.get_model(tcfg)
  jp = jconfigs.param_specs(jcfg)
  tp = ta.init(tcfg, generator=torch.Generator().manual_seed(0),
               device="cpu")
  tok = np.zeros((b, s), np.int32)
  batch = dict(tokens=tok, targets=tok)
  out = {}
  if tcfg.family == "whisper":       # the encoder stands for the forward
    frames = np.zeros((b, s, tcfg.d_model), np.float32)
    batch["frames"] = frames
    out["forward"] = (
        lambda cs: jax.make_jaxpr(
            lambda p, f: ja.encode(p, f, jcfg, cs))(jp, frames),
        lambda cs: ta.encode(tp, torch.tensor(frames), tcfg, cs=cs))
  else:
    out["forward"] = (
        lambda cs: jax.make_jaxpr(
            lambda p, t: ja.forward(p, t, jcfg, cs))(jp, tok),
        lambda cs: ta.forward(tp, torch.tensor(tok).long(), tcfg, cs=cs))
  out["loss_fn"] = (
      lambda cs: jax.make_jaxpr(
          lambda p, bt: ja.loss_fn(p, bt, jcfg, cs))(jp, batch),
      lambda cs: ta.loss_fn(tp, batch, tcfg, cs))
  jstate = jax.eval_shape(lambda: ja.init_decode_state(jcfg, b, max_len))
  pos = np.zeros((b,), np.int32)
  for name, w, jfn, tfn in (
      ("decode_step", 1, ja.decode_step, ta.decode_step),
      ("decode_window", 3, ja.decode_window_batched,
       ta.decode_window_batched)):
    tk = np.zeros((b, w), np.int32)
    out[name] = (
        lambda cs, jfn=jfn, tk=tk: jax.make_jaxpr(
            lambda p, st, t, q: jfn(p, st, t, q, jcfg, cs))(
                jp, jstate, tk, pos),
        lambda cs, tfn=tfn, tk=tk: tfn(
            tp, ta.init_decode_state(tcfg, b, max_len, device="cpu"),
            torch.tensor(tk).long(), torch.tensor(pos).long(), tcfg, cs=cs))
  return out


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("arch", NAME_ARCHS)
def test_constraint_sites_match_reference(arch, program):
  """The port passes `cs` the reference's logical names in the
  reference's order: layer for layer, block for block (the MoE's
  "gecd", "gecf", "gecd", MLA's three "bshd_q", Mamba2's "bsi", the
  "layer_params" of every scanned body)."""
  trace, run = _programs(arch)[program]
  ref = _ref_names(trace)
  assert ref, "the reference records no constraint"
  assert _port_names(run) == ref


# ---------------------------------------------------------------------------
# One gloo world.
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import os, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    B, S, MAX_LEN = 4, 16, 24
    CUT_HEADS = ("llama3-8b", "zamba2-7b")

    def cfg_of(arch):
      from repro_torch import configs
      return configs.get_smoke(arch).with_(dtype=torch.float32,
                                           vocab_size=64)

    def batch_of(arch):
      rng = np.random.RandomState(0)
      toks = rng.randint(0, 64, (B, S + 1))
      out = dict(tokens=toks[:, :-1], targets=toks[:, 1:])
      if arch == "whisper-small":
        out["frames"] = rng.randn(B, S, 128).astype(np.float32)
      return out

    def routes(log):
      return (np.concatenate([e["experts"].reshape(-1) for e in log])
              if log else np.zeros((0,), np.int64))

    def train(arch, mesh, out, tag):
      """The loss and gradients of one batch, then AdamW's step on
      them (the step `Trainer.train_step` takes). deepseek-v2-lite
      trains in the paper's first stage, its expert stacks factored at
      full rank under the trace norm; the other families dense."""
      from repro_torch.core.compress import FactorizationPlan
      from repro_torch.core.factored import iter_factored_leaves, param_tree
      from repro_torch.core.schedule import TwoStageSchedule
      from repro_torch.core.svd import TruncationSpec
      from repro_torch.core.tracenorm import RegularizerConfig
      from repro_torch.dist import sharding as shd
      from repro_torch.layers import moe
      from repro_torch.optim import make_optimizer
      from repro_torch.training import TrainConfig, Trainer
      sched = None if arch != "deepseek-v2-lite" else TwoStageSchedule(
          total_steps=2, transition_step=1,
          regularizer=RegularizerConfig(kind="trace", lambda_rec=1e-4,
                                        lambda_nonrec=1e-4),
          truncation=TruncationSpec(variance_threshold=0.9, round_to=8))
      tr = Trainer(cfg_of(arch), TrainConfig(lr=1e-2), mesh=mesh,
                   batch_size=B, device="cpu", schedule=sched,
                   plan=FactorizationPlan(include=("*expert*",), min_dim=16))
      out[f"{tag}/experts"] = np.array(sum(
          "expert" in leaf.name and leaf.is_factored
          for leaf in iter_factored_leaves(tr.params)))
      with shd.replicated_plain(mesh is not None), \\
          moe.record_routes() as log:
        loss, _, grads = tr._step_fn.grads_of(
            tr.params, tr._put_batch(batch_of(arch)))
        params, _, _ = make_optimizer("adamw")[1](
            tr.params, grads, tr.opt_state, 1e-2, tr.train_cfg.adam)
      out[f"{tag}/loss"] = float(shd.gather_tree(loss))
      out[f"{tag}/routes"] = routes(log)
      tree = param_tree(params)
      placed = []
      for k, g in grads.items():
        out[f"{tag}/grad/{k}"] = shd.gather_tree(g).numpy()
        if mesh is not None:
          placed.append(list(g.placements) == list(tree[k].placements))
      out[f"{tag}/placed"] = np.array(placed, bool)
      for k, p in param_tree(shd.gather_params(params) if mesh
                             else params).items():
        out[f"{tag}/param/{k}"] = p.detach().numpy()
      if mesh is None and arch == "zamba2-7b":
        # the same gradients on one device from weights moved by 1e-7
        # of themselves: the model's own f32 noise floor
        tr = Trainer(cfg_of(arch), TrainConfig(), batch_size=B,
                     device="cpu")
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
          for p in param_tree(tr.params).values():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
        _, _, grads = tr._step_fn.grads_of(tr.params,
                                           tr._put_batch(batch_of(arch)))
        for k, g in grads.items():
          out[f"{tag}/pgrad/{k}"] = g.numpy()

    def prompts():
      return np.random.RandomState(0).randint(0, 64, (B, 2))

    def tensors(mod):
      return list(mod.parameters()) + list(mod.buffers())

    def signatures(state):
      """(shape, placements) of every sharded DTensor leaf of a decode
      state and of its layer views (the leading stack dim dropped)."""
      from torch.distributed.tensor import Shard
      out = set()
      for t in ([state] if not isinstance(state, dict) else
                [x for v in state.values() for x in (
                    v.values() if isinstance(v, dict) else [v])]):
        if isinstance(t, dict):
          out |= signatures(t)
          continue
        if not hasattr(t, "placements") or not any(
            p.is_shard() for p in t.placements):
          continue
        out.add((tuple(t.shape), repr(list(t.placements))))
        if all(not p.is_shard() or p.dim > 0 for p in t.placements):
          view = [Shard(p.dim - 1) if p.is_shard() else p
                  for p in t.placements]
          out.add((tuple(t.shape[1:]), repr(view)))
      return out

    def engine(arch, mesh, out, tag, steps=2, stage2=False, given=False,
               **kw):
      """Greedy `generate` under the "cuda" policy (its plain versions
      here): tokens, dispatch log, routes, the DTensors gathered inside
      the admission's state surgery, and the sharded decode-state leaves
      (or layer views of them) gathered anywhere in the run. `stage2`
      serves the truncated-SVD model at rank 16 (every matched GEMM
      factored); `given` hands the engine its rank-8 draft."""
      from torch.distributed.tensor import DTensor
      from repro_torch.kernels import dispatch
      from repro_torch.layers import moe
      from repro_torch.models.api import ModelApi, get_model
      from repro_torch.serving.engine import LMEngine
      from repro_torch.serving.speculative import make_draft_params
      cfg = cfg_of(arch)
      params = get_model(cfg).init(
          cfg, generator=torch.Generator().manual_seed(0), device="cpu")
      if stage2:
        params = make_draft_params(params, rank=16)
      if given:
        kw["draft_params"] = make_draft_params(params, rank=8)
      eng = LMEngine(cfg, params, batch_size=B, max_len=MAX_LEN, mesh=mesh,
                     kernel_policy="cuda",
                     device=None if mesh is not None else "cpu", **kw)
      sigs = signatures(eng.state) | signatures(eng.draft_state or {})
      full, redistribute = DTensor.full_tensor, DTensor.redistribute
      gathers, moved, in_surgery = [0], [], [False]

      def watch(t, want):
        if (tuple(t.shape), repr(list(t.placements))) in sigs and any(
            p.is_shard() and not (q is not None and q.is_shard()
                                  and q.dim == p.dim)
            for p, q in zip(t.placements, want)):
          moved.append(tuple(t.shape))

      def watched_full(self, *a, **k):
        gathers[0] += in_surgery[0]
        watch(self, [None] * len(self.placements))
        return full(self, *a, **k)

      def watched_redistribute(self, device_mesh=None, placements=None,
                               **k):
        if placements is not None:
          watch(self, list(placements))
        return redistribute(self, device_mesh, placements, **k)

      def counting(fn):
        def wrapped(*a, **k):
          in_surgery[0] = True
          try:
            return fn(*a, **k)
          finally:
            in_surgery[0] = False
        return wrapped
      surgery = {n: getattr(ModelApi, n) for n in
                 ("insert_slot", "splice_prefix", "prefix_view")}
      for n, fn in surgery.items():
        setattr(ModelApi, n, counting(fn))
      DTensor.full_tensor = watched_full
      DTensor.redistribute = watched_redistribute
      try:
        with dispatch.record_dispatch() as log, moe.record_routes() as rl:
          res = eng.generate(prompts(), steps=steps)
      finally:
        for n, fn in surgery.items():
          setattr(ModelApi, n, fn)
        DTensor.full_tensor, DTensor.redistribute = full, redistribute
      out[f"{tag}/tokens"] = res.tokens
      out[f"{tag}/log"] = np.array(sorted(set(map(str, log))))
      out[f"{tag}/routes"] = routes(rl)
      out[f"{tag}/gathers"] = np.array(gathers[0])
      out[f"{tag}/moved"] = np.array(len(moved))
      out[f"{tag}/sigs"] = np.array(len(sigs))
      if kw:
        out[f"{tag}/accept"] = np.array(res.accept_rate)
      if eng.draft_params is not None:
        mine = {id(t) for t in tensors(eng.params)}
        out[f"{tag}/shared"] = np.array(sum(
            id(t) in mine for t in tensors(eng.draft_params)))
      return eng

    def spec(arch, mesh, out, tag):
      engine(arch, mesh, out, tag, speculate=2, draft_rank=8)
      if mesh is None:                 # vanilla greedy on one device
        engine(arch, None, out, tag.replace("/one", "/vanilla"))

    def spec_stage2(arch, mesh, out, tag):
      """speculate=2 on a factored (stage-2) target with its rank-8 draft
      handed to the engine; and the draft `make_draft_params` makes of
      the engine's target (on a mesh, DTensor factors), its factors."""
      from repro_torch.core.factored import param_tree
      from repro_torch.dist import sharding as shd
      from repro_torch.serving.speculative import make_draft_params
      eng = engine(arch, mesh, out, tag, speculate=2, stage2=True,
                   given=True)
      draft = make_draft_params(eng.params, rank=8)
      for k, t in param_tree(shd.gather_params(draft)).items():
        out[f"{tag}/draft/{k}"] = t.detach().numpy()

    def shared_prompts():
      """Five prompts, four opening with one 6-token template."""
      rng = np.random.RandomState(3)
      template = rng.randint(1, 64, size=(6,))
      return [rng.randint(1, 64, size=(rng.randint(1, 4),)) if i == 2 else
              np.concatenate([template, rng.randint(1, 64, size=(
                  rng.randint(1, 4),))]) for i in range(5)]

    def prefix(arch, mesh, out, tag):
      """The shared prompts through a cache of ~2.5 full-prompt
      snapshots: forks, hits and evictions."""
      from repro_torch.models.api import get_model
      from repro_torch.serving.engine import LMEngine
      from repro_torch.serving.prefix_cache import PrefixCache, snapshot_bytes
      cfg = cfg_of(arch)
      api = get_model(cfg)
      params = api.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
      ps = shared_prompts()
      one = snapshot_bytes(api.prefix_view(
          cfg, api.init_decode_state(cfg, 1, MAX_LEN, device="cpu"),
          len(ps[0]))) + 8 * len(ps[0])
      cache = PrefixCache(2.5 * one / (1 << 20))
      eng = LMEngine(cfg, params, batch_size=B, max_len=MAX_LEN, mesh=mesh,
                     device=None if mesh is not None else "cpu",
                     prefix_cache=cache)
      uids = [eng.submit(p, max_new_tokens=2, eos_id=None) for p in ps]
      fin = {f.uid: f for f in eng.run()}
      out[f"{tag}/tokens"] = np.concatenate([fin[u].tokens for u in uids])
      st = cache.stats()
      out[f"{tag}/stats"] = np.array([st[k] for k in (
          "hits", "misses", "evictions", "inserts", "entries", "bytes")])

    def worker(rank, tmp):
      # a hung rank prints its stack before the test's timeout kills it
      import faulthandler
      faulthandler.dump_traceback_later(280, exit=True)
      torch.set_num_threads(1)
      import torch.distributed as dist
      from repro_torch.dist import mesh as M
      M.init_world(os.path.join(tmp, "store"), rank, 4, device_type="cpu")
      mesh = M.make_mesh((2, 2), ("data", "model"), device_type="cpu")
      archs = sys.argv[2].split(",")
      jobs = [(train, a) for a in archs] + [(engine, a) for a in archs]
      jobs += [(spec, a) for a in ("zamba2-7b", "llama3-8b")]
      jobs += [(spec_stage2, "llama3-8b")]
      jobs += [(prefix, a) for a in ("xlstm-350m", "qwen3-4b")]
      out = {}
      for fn, arch in jobs:            # every rank, on the mesh
        fn(arch, mesh, out, f"{fn.__name__}/{arch}/mesh")
      # the same ranks as a (1, 4) mesh, whose model degree cuts
      # llama3-8b's 2 kv heads
      mesh14 = M.make_mesh((1, 4), ("data", "model"), device_type="cpu")
      for arch in CUT_HEADS:
        train(arch, mesh14, out, f"train/{arch}/mesh14")
      jobs += [(train, a) for a in CUT_HEADS if a not in archs]
      for i, (fn, arch) in enumerate(jobs):   # one device, spread
        if i % 4 == rank:
          fn(arch, None, out, f"{fn.__name__}/{arch}/one")
      np.savez(os.path.join(tmp, f"out_{rank}.npz"),
               **{k: np.asarray(v) for k, v in out.items()
                  if rank == 0 or "/mesh" not in k})
      dist.destroy_process_group()

    if __name__ == "__main__":
      mp.spawn(worker, args=(sys.argv[1],), nprocs=4, join=True)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp("families"))
  script = os.path.join(tmp, "worker.py")
  with open(script, "w") as f:
    f.write(WORKER)
  env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
             OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
             MKL_NUM_THREADS="1")
  out = run_world([sys.executable, script, tmp, ",".join(ARCHS)], env,
                  timeout=300)
  assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
  res = {}
  for r in range(4):
    res.update(np.load(os.path.join(tmp, f"out_{r}.npz")))
  return res


def _leaves(world, pre: str, kind: str) -> list:
  head = f"{pre}/one/{kind}/"
  keys = [k[len(head):] for k in world if k.startswith(head)]
  assert keys
  return keys


#: the gradients' tolerance, of each leaf's largest entry: 1e-5 (f32
#: summation order: the model axis splits the GEMMs' sums), but for
#: zamba, whose smoke gradients move by more than that on one device when
#: its weights move by 1e-7 of themselves
#: (`test_zamba_gradients_move_that_much_on_one_device`)
GRAD_ATOL = {"zamba2-7b": 1e-4}


def _close_to_leaf(got, want, arch, err_msg=""):
  """Within rtol 2e-4, or `GRAD_ATOL` of the leaf's largest entry."""
  atol = GRAD_ATOL.get(arch, 1e-5) * float(np.abs(want).max()) + 1e-12
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                             err_msg=err_msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_match_one_device(world, arch):
  """Trainer(mesh=) on (2, 2): the loss within rtol 2e-4 and every
  gradient within 1e-5 of its leaf's largest entry of the one-device
  run's (zamba: `GRAD_ATOL`), each gradient in its parameter's
  placements."""
  pre = f"train/{arch}"
  np.testing.assert_allclose(world[f"{pre}/mesh/loss"],
                             world[f"{pre}/one/loss"], rtol=RTOL)
  assert world[f"{pre}/mesh/placed"].all()
  assert world[f"{pre}/mesh/placed"].size == len(_leaves(world, pre, "grad"))
  for k in _leaves(world, pre, "grad"):
    _close_to_leaf(world[f"{pre}/mesh/grad/{k}"],
                   world[f"{pre}/one/grad/{k}"], arch, k)


def test_zamba_gradients_move_that_much_on_one_device(world):
  """Why zamba's gradients get `GRAD_ATOL`: on one device, weights moved
  by 1e-7 of themselves (f32's rounding) move some leaf's gradient by
  more than 1e-5 of its largest entry, as much as the mesh moves it."""
  pre = "train/zamba2-7b"

  def worst(kind):
    return max(float(np.abs(world[f"{pre}/{kind}/{k}"]
                            - world[f"{pre}/one/grad/{k}"]).max()
                     / np.abs(world[f"{pre}/one/grad/{k}"]).max())
               for k in _leaves(world, pre, "grad"))
  assert worst("one/pgrad") > 1e-5
  assert worst("mesh/grad") < 2 * worst("one/pgrad")


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_model_degree_four_matches_one_device(world, arch):
  """Trainer(mesh=) on (1, 4): llama3-8b, whose 2 kv heads the model
  degree cuts (`dist.sharding.split_heads`), and zamba2-7b, whose
  attention backward hands a permuted local gradient to DTensor
  (`sharding._DenseGrad`), give the one-device loss and gradients at
  the (2, 2) mesh's tolerances."""
  pre = f"train/{arch}"
  np.testing.assert_allclose(world[f"{pre}/mesh14/loss"],
                             world[f"{pre}/one/loss"], rtol=RTOL)
  assert world[f"{pre}/mesh14/placed"].all()
  for k in _leaves(world, pre, "grad"):
    _close_to_leaf(world[f"{pre}/mesh14/grad/{k}"],
                   world[f"{pre}/one/grad/{k}"], arch, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_one_device(world, arch):
  """AdamW's step on those gradients: every parameter where its
  gradient is live (an entry under 1e-3 of its leaf's largest moves by
  lr * g / (|g| + eps), which the gradient check already holds)."""
  pre = f"train/{arch}"
  for k in _leaves(world, pre, "param"):
    g0 = world[f"{pre}/one/grad/{k}"]
    live = np.abs(g0) > 1e-3 * float(np.abs(g0).max())
    _close_to_leaf(world[f"{pre}/mesh/param/{k}"][live],
                   world[f"{pre}/one/param/{k}"][live], arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_a_mesh_emits_the_one_device_tokens(world, arch):
  """LMEngine(mesh=) greedy: the one-device tokens and the same routing
  decisions of every GEMM."""
  pre = f"engine/{arch}"
  np.testing.assert_array_equal(world[f"{pre}/mesh/tokens"],
                                world[f"{pre}/one/tokens"])
  np.testing.assert_array_equal(world[f"{pre}/mesh/log"],
                                world[f"{pre}/one/log"])
  assert any("decode_matvec" in s for s in world[f"{pre}/one/log"])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_a_mesh_admits_without_a_gather(world, arch):
  """Admission writes each slot into the ranks' blocks: no DTensor is
  gathered inside `insert_slot` (nor `splice_prefix`, `prefix_view`)."""
  assert int(world[f"engine/{arch}/mesh/gathers"]) == 0


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "deepseek-v3-671b"])
@pytest.mark.parametrize("job", ["train", "engine"])
def test_deepseek_routes_match_one_device(world, arch, job):
  """Every MoE call routes every token to the one-device run's experts
  (the route log holds whole tensors under the mesh)."""
  pre = f"{job}/{arch}"
  assert world[f"{pre}/one/routes"].size
  np.testing.assert_array_equal(world[f"{pre}/mesh/routes"],
                                world[f"{pre}/one/routes"])


@pytest.mark.parametrize("arch", ["zamba2-7b", "llama3-8b"])
def test_speculative_engine_on_a_mesh(world, arch):
  """speculate=2 with a rank-8 draft laid out on the mesh (zamba's
  carries snapshotted, rewound and replayed as DTensors): the one-device
  speculative tokens, which are vanilla greedy's, at the same accept
  rate."""
  pre = f"spec/{arch}"
  np.testing.assert_array_equal(world[f"{pre}/mesh/tokens"],
                                world[f"{pre}/one/tokens"])
  np.testing.assert_array_equal(world[f"{pre}/one/tokens"],
                                world[f"spec/{arch}/vanilla/tokens"])
  assert float(world[f"{pre}/mesh/accept"]) == \
      float(world[f"{pre}/one/accept"])
  assert int(world[f"{pre}/mesh/gathers"]) == 0


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen3-4b"])
def test_prefix_cache_on_a_mesh(world, arch):
  """A prefix cache under the mesh: the one-device tokens, and the same
  hits, misses, evictions, inserts, entries and bytes (a sharded
  snapshot is charged its global bytes)."""
  pre = f"prefix/{arch}"
  np.testing.assert_array_equal(world[f"{pre}/mesh/tokens"],
                                world[f"{pre}/one/tokens"])
  np.testing.assert_array_equal(world[f"{pre}/mesh/stats"],
                                world[f"{pre}/one/stats"])
  hits, _, evictions = world[f"{pre}/one/stats"][:3]
  assert hits > 0 and evictions > 0


@pytest.mark.parametrize("run", [f"engine/{a}/mesh" for a in ARCHS] + [
    "spec/zamba2-7b/mesh", "spec/llama3-8b/mesh",
    "spec_stage2/llama3-8b/mesh"])
def test_engine_on_a_mesh_gathers_no_state_leaf(world, run):
  """No sharded decode-state leaf, nor a layer view of one (the KV and
  latent caches split on their length, the carries split on their
  rows), is gathered anywhere in the run, prefill, decode, windows and
  admissions alike: each rank attends over its own block of a cache,
  the blocks combined across the model axis (`softmax_mix`), and runs a
  recurrence on its own rows."""
  assert int(world[f"{run}/sigs"]) > 0
  assert int(world[f"{run}/moved"]) == 0


def test_speculative_engine_on_a_mesh_drafts_a_factored_target(world):
  """speculate=2 on llama3-8b factored at rank 16 (a stage-2 model) with
  its rank-8 draft handed to the engine: the mesh run emits the
  one-device tokens at the same accept rate, and the draft keeps
  sharing with the laid-out target every tensor it shared with the
  target, as on one device. `make_draft_params` of the mesh's target
  truncates its DTensor factors gathered whole: the one-device draft's
  factors."""
  pre = "spec_stage2/llama3-8b"
  np.testing.assert_array_equal(world[f"{pre}/mesh/tokens"],
                                world[f"{pre}/one/tokens"])
  assert float(world[f"{pre}/mesh/accept"]) == \
      float(world[f"{pre}/one/accept"])
  assert int(world[f"{pre}/mesh/shared"]) == \
      int(world[f"{pre}/one/shared"]) > 0
  keys = _leaves(world, pre, "draft")
  assert any(k.endswith("/u") for k in keys)
  for k in keys:
    np.testing.assert_allclose(world[f"{pre}/mesh/draft/{k}"],
                               world[f"{pre}/one/draft/{k}"],
                               rtol=1e-5, atol=1e-6, err_msg=k)


def test_deepseek_trains_factored_experts_on_a_mesh(world):
  """deepseek-v2-lite's training job (whose loss, gradients and step
  the tests above hold to one device's) runs the paper's first stage
  with its expert stacks factored: the MoE's experts multiplied out of
  DTensor factors on each rank, and their factors' gradients."""
  pre = "train/deepseek-v2-lite"
  assert int(world[f"{pre}/one/experts"]) == 3
  assert int(world[f"{pre}/mesh/experts"]) == 3
  assert {"moe_layers/moe/w_gate/u", "moe_layers/moe/w_up/v",
          "moe_layers/moe/w_down/u"} <= set(_leaves(world, pre, "grad"))
