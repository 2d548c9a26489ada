"""The port's dry run (`repro_torch.launch.dryrun`): smoke train and
decode cells of llama3-8b and a smoke train cell of whisper-small on a
(4, 2) mesh over a fake world of 8 ranks (as `tests/test_dist.py` runs the reference's on 8 virtual
devices), and the layout choices and parameter counts of every arch
against the reference's.

Both run in subprocesses: the fake default process group must not
outlive its test in an xdist worker, and the reference's dry run sets
`XLA_FLAGS` when it is imported.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
from threadpoolctl import threadpool_limits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _run(code: str, **env) -> str:
  out = subprocess.run(
      [sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
      text=True, timeout=240,
      env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **env))
  assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
  return out.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def smoke_cells():
  return json.loads(_run('''
      import json
      import torch
      torch.set_num_threads(1)
      import torch.distributed as dist
      from repro_torch import configs
      from repro_torch.launch import dryrun
      from repro_torch.layers.common import ShapeConfig
      train = ShapeConfig("smoke_train", "train", 64, 8)
      decode = ShapeConfig("smoke_decode", "decode", 64, 8)
      cells = {(4, 2): [("llama3-8b", train), ("llama3-8b", decode),
                        ("whisper-small", train)],
               (1, 8): [("whisper-small", train)],
               (1, 1): [("llama3-8b", decode)]}
      out = {}
      for mesh_shape, todo in cells.items():
        with dryrun.fake_world(mesh_shape[0] * mesh_shape[1]):
          mesh = dryrun.fake_mesh(mesh_shape, ("data", "model"))
          for arch, shape in todo:
            out[f"{arch}/{shape.kind}/{mesh_shape}"] = dryrun.run_cell(
                arch, shape, "small", mesh, save=False, verbose=False,
                cfg_override=configs.get_smoke(arch))
        out["torn_down"] = not dist.is_initialized()
      print(json.dumps(out))
  '''))


@pytest.mark.parametrize("cell_name", [
    "llama3-8b/train/(4, 2)", "llama3-8b/decode/(4, 2)",
    "whisper-small/train/(4, 2)", "whisper-small/train/(1, 8)"])
def test_smoke_cells_give_per_device_ledgers(smoke_cells, cell_name):
  """Whisper's training on (4, 2) reshapes a split dim into another,
  which DTensor lays out as a strided shard (`_strided_offsets_unfaked`
  lets fake tensors run it); on (1, 8) its 4 smoke heads do not divide
  the model degree (`dist.sharding.merge_heads` gathers the merged
  columns' gradient)."""
  cell = smoke_cells[cell_name]
  kind = cell_name.split("/")[1]
  assert cell["devices"] == 8
  assert cell["flops"] > 0 and cell["dot_flops"] > 0
  assert cell["hbm_bytes"] > 0
  assert cell["dominant"] in ("compute", "memory", "collective")
  assert cell["unknown_ops"] == {}
  mem = cell["memory"]
  assert 0 < mem["input_bytes"] < mem["peak_bytes"]
  # the state (decode) and the parameters and moments (train) are
  # written in place
  assert mem["credited_bytes"] == mem["donated_bytes"] > 0
  if kind == "train":
    assert cell["collective_bytes"] > 0 and cell["n_collectives"] > 0
    assert cell["collective_wire_bytes"] > 0
    assert "all-gather" in cell["collective_by_kind"]
  assert smoke_cells["torn_down"]


def test_per_device_flops_are_a_share_of_the_model(smoke_cells):
  """A decode cell on 8 devices does under 1/4 of one device's dot
  FLOPs a device (data degree 4; the model axis splits the GEMMs
  again)."""
  one = smoke_cells["llama3-8b/decode/(1, 1)"]
  eight = smoke_cells["llama3-8b/decode/(4, 2)"]
  assert one["devices"] == 1 and one["collective_bytes"] == 0
  assert eight["dot_flops"] < one["dot_flops"] / 4


@pytest.fixture(scope="module")
def reference_choices():
  return json.loads(_run('''
      import json
      from repro import configs
      from repro.launch import dryrun

      class Mesh:            # axis names and sizes: all the rules read
        def __init__(self, **axes):
          self.shape, self.axis_names = axes, tuple(axes)
      out = {}
      for arch in configs.ARCH_NAMES:
        cfg = configs.get_config(arch)
        specs = configs.param_specs(cfg)
        row = dict(counts=list(dryrun.param_counts(cfg)),
                   optimizer=dryrun.pick_optimizer(arch))
        for name, mesh in (("single", Mesh(data=16, model=16)),
                           ("multi", Mesh(pod=2, data=16, model=16))):
          row[name] = [bool(dryrun.needs_fsdp_serving(cfg, specs, mesh)),
                       dryrun.train_param_policy(cfg, mesh)]
        out[arch] = row
      print(json.dumps(out))
  '''))


def test_layout_choices_and_counts_equal_the_reference(reference_choices):
  """Parameter counts (total, MoE-active) and the layout choices: the
  reference's 8 GB and 6 GB a chip, restated as shares of the H100's
  80 GB, choose alike for every arch; only deepseek-v3-671b serves and
  trains 2-D."""
  from repro_torch import configs
  from repro_torch.dist.sharding import RuleMesh
  from repro_torch.launch import dryrun
  assert set(reference_choices) == set(configs.ARCH_NAMES)
  meshes = {"single": RuleMesh(data=16, model=16),
            "multi": RuleMesh(pod=2, data=16, model=16)}
  for arch, want in reference_choices.items():
    cfg = configs.get_config(arch)
    specs = configs.param_specs(cfg)
    assert list(dryrun.param_counts(cfg)) == want["counts"], arch
    assert dryrun.pick_optimizer(arch) == want["optimizer"]
    for name, mesh in meshes.items():
      got = [dryrun.needs_fsdp_serving(cfg, specs, mesh),
             dryrun.train_param_policy(cfg, mesh)]
      assert got == want[name], (arch, name)
      assert got == ([True, "fsdp"] if arch == "deepseek-v3-671b"
                     else [False, "zero1"]), (arch, name)
  assert dryrun.SERVE_SHARE * dryrun.CARD_BYTES == pytest.approx(8e9)
  assert dryrun.TRAIN_SHARE * dryrun.CARD_BYTES == pytest.approx(6e9)
