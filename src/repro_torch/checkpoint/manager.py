"""Checkpointing: one `.npy` per leaf plus a JSON manifest, in the
reference's on-disk layout (`repro.checkpoint.manager`), so a checkpoint
written by either package loads in the other.

Layout:
  <dir>/step_000000042.tmp/...   (written first)
  <dir>/step_000000042/          (atomic rename on completion)
      manifest.json              {"step", "extra", "leaves": {path ->
                                  {"file", "dtype", "shape"}}}
      <leaf>.npy                 one file per leaf

Leaves are keyed by the reference's path strings: a tree is nested
mappings (keys joined with "/"), NamedTuples (by field: `AdamState` gives
"opt/step", "opt/m/...") and `nn.Module`s (by `state_dict()` name with
"/" for ".": "params/grus/gru0/rec/u"). bf16 is stored as its `uint16`
view with the dtype string "bfloat16". Restore is driven by a template
of the same structure; it raises on a missing leaf or a wrong shape and
warns on a stored leaf the template does not name. Async saves copy
every leaf to the host inline and write on a background thread, so the
step loop can go on updating its tensors in place.
"""
from __future__ import annotations

import copy
import json
import os
import re
import shutil
import threading
import warnings
from typing import Any, Optional

import numpy as np
import torch
from torch import nn


def _join(prefix: str, key: str) -> str:
  return f"{prefix}/{key}" if prefix else key


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
  """(path, leaf) pairs of a tree of mappings, NamedTuples and modules;
  a leaf is a tensor, a numpy array or a Python number."""
  if isinstance(tree, nn.Module):
    return [(_join(prefix, k.replace(".", "/")), t)
            for k, t in tree.state_dict(keep_vars=True).items()]
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return [pair for f in tree._fields
            for pair in flatten(getattr(tree, f), _join(prefix, f))]
  if isinstance(tree, dict):
    return [pair for k, v in tree.items()
            for pair in flatten(v, _join(prefix, str(k)))]
  return [(prefix, tree)]


def to_host(leaf: Any) -> tuple[np.ndarray, str]:
  """A leaf as a numpy array that owns its data, and its dtype string
  (bf16: the uint16 view and "bfloat16")."""
  if isinstance(leaf, torch.Tensor):
    from repro_torch.dist.sharding import is_dtensor
    if is_dtensor(leaf):
      leaf = leaf.full_tensor()          # gathered whole, on every rank
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
      return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
  elif isinstance(leaf, (bool, int)):
    arr = np.asarray(leaf, np.int32)
  else:
    arr = np.array(leaf, copy=True)
  return arr, str(arr.dtype)


def from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
  """A stored array as a CPU tensor with the same bits."""
  if dtype == "bfloat16":
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                            .view(np.int16).copy()).view(torch.bfloat16)
  return torch.from_numpy(np.array(arr, copy=True))


def _fname(path_str: str) -> str:
  return re.sub(r"[^A-Za-z0-9_.-]", "_", path_str) + ".npy"


def _rebuild(template: Any, prefix: str, take) -> Any:
  """`template`'s structure with every leaf replaced by take(path, leaf)."""
  if isinstance(template, nn.Module):
    out = copy.deepcopy(template)
    loaded = {k: take(_join(prefix, k.replace(".", "/")), t)
              for k, t in template.state_dict(keep_vars=True).items()}
    out.load_state_dict(loaded, strict=True, assign=True)
    return out
  if isinstance(template, tuple) and hasattr(template, "_fields"):
    return type(template)(*(_rebuild(getattr(template, f), _join(prefix, f),
                                     take) for f in template._fields))
  if isinstance(template, dict):
    return {k: _rebuild(v, _join(prefix, str(k)), take)
            for k, v in template.items()}
  return take(prefix, template)


class CheckpointManager:

  def __init__(self, directory: str, *, keep: int = 3):
    self.directory = directory
    self.keep = keep
    os.makedirs(directory, exist_ok=True)
    self._thread: Optional[threading.Thread] = None

  # -- save -----------------------------------------------------------------

  def save(self, step: int, tree: Any, *, extra: Optional[dict] = None,
           blocking: bool = True) -> None:
    """Copy every leaf to the host and persist. blocking=False writes on a
    background thread (the copy is made here, so the live tree can keep
    changing); a write still in flight finishes first, whichever kind
    this one is (two writes of one step would race on its directory). In
    a world of several ranks every rank gathers its DTensors (a
    collective), rank 0 alone writes, blocking, and the ranks meet at a
    barrier after the write."""
    host = [(p, *to_host(x)) for p, x in flatten(tree)]
    self.wait()
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
      if dist.get_rank() == 0:
        self._write(step, host, extra)
      dist.barrier()
      return
    if blocking:
      self._write(step, host, extra)
    else:
      self._thread = threading.Thread(
          target=self._write, args=(step, host, extra), daemon=True)
      self._thread.start()

  def wait(self) -> None:
    if self._thread is not None:
      self._thread.join()
      self._thread = None

  def _step_dir(self, step: int) -> str:
    return os.path.join(self.directory, f"step_{step:09d}")

  def _write(self, step: int, host: list, extra: Optional[dict]) -> None:
    final = self._step_dir(step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
      shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for pstr, arr, dtype in host:
      fn = _fname(pstr)
      np.save(os.path.join(tmp, fn), arr)
      manifest["leaves"][pstr] = {
          "file": fn, "dtype": dtype, "shape": list(arr.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
      json.dump(manifest, f)
    if os.path.exists(final):
      shutil.rmtree(final)
    os.rename(tmp, final)
    self._gc()

  def _gc(self) -> None:
    for s in self.all_steps()[:-self.keep] if self.keep else []:
      shutil.rmtree(self._step_dir(s), ignore_errors=True)

  # -- restore ----------------------------------------------------------------

  def all_steps(self) -> list[int]:
    out = []
    for d in os.listdir(self.directory):
      m = re.fullmatch(r"step_(\d+)", d)
      if m:
        out.append(int(m.group(1)))
    return sorted(out)

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def _resolve(self, step: Optional[int]) -> int:
    if step is None:
      step = self.latest_step()
      if step is None:
        raise FileNotFoundError(f"no checkpoints in {self.directory}")
    return step

  def manifest(self, step: Optional[int] = None) -> dict:
    """The manifest of `step` (default: the latest)."""
    with open(os.path.join(self._step_dir(self._resolve(step)),
                           "manifest.json")) as f:
      return json.load(f)

  def read(self, path: str, step: Optional[int] = None
           ) -> tuple[np.ndarray, str]:
    """One stored leaf as it lies on disk: (array, dtype string)."""
    step = self._resolve(step)
    ent = self.manifest(step)["leaves"][path]
    return (np.load(os.path.join(self._step_dir(step), ent["file"])),
            ent["dtype"])

  def restore(self, template: Any, *, step: Optional[int] = None,
              shardings: Any = None) -> tuple[Any, dict]:
    """Rebuild `template`'s structure with the stored leaves; returns
    (tree, manifest extra). Tensors land on the template tensor's device
    (in the stored dtype), Python ints stay ints. A missing leaf raises
    KeyError, a wrong shape ValueError; a stored leaf the template does
    not name warns (a calibrated tree restored into an uncalibrated
    template would otherwise change serving numerics quietly).

    `shardings` (a tree matching `template`, or `param_shardings`' dict
    for a module, of `dist.sharding.NamedSharding`) lays each leaf out
    as a DTensor by the placements given: the elastic path, where a
    checkpoint saved on any layout lands on this one. Without it a
    DTensor leaf of the template keeps the template's layout."""
    from repro_torch.dist import sharding as shd
    step = self._resolve(step)
    d = self._step_dir(step)
    manifest = self.manifest(step)
    consumed = set()
    by_path = {} if shardings is None else {
        p.replace(".", "/"): s for p, s in flatten(shardings)}

    def take(pstr: str, t: Any) -> Any:
      consumed.add(pstr)
      ent = manifest["leaves"].get(pstr)
      if ent is None:
        raise KeyError(f"checkpoint {d} missing leaf {pstr}")
      arr = np.load(os.path.join(d, ent["file"]))
      shape = tuple(t.shape) if hasattr(t, "shape") else ()
      if tuple(arr.shape) != shape:
        raise ValueError(
            f"shape mismatch for {pstr}: ckpt {arr.shape} vs {shape}")
      if isinstance(t, (bool, int)):
        return type(t)(arr)
      if isinstance(t, torch.Tensor):
        x = from_host(arr, ent["dtype"]).to(t.device)
        if pstr in by_path:
          return shd.lay_out(x, by_path[pstr])
        if shd.is_dtensor(t):
          return shd.distribute_tensor_local(x, t.device_mesh, t.placements)
        return x
      return arr

    tree = _rebuild(template, "", take)
    unused = sorted(set(manifest["leaves"]) - consumed)
    if unused:
      warnings.warn(
          f"checkpoint {d} has {len(unused)} leaves the template does not "
          f"reference (first few: {unused[:4]}); they were NOT restored",
          stacklevel=2)
    return tree, manifest.get("extra", {})
