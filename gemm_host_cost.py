"""Host time of `kernels.dispatch.gemm` with nothing listening: this
tree's against another tree's, on the CPU, in one process.

    python3 gemm_host_cost.py OTHER_TREE [...]

OTHER_TREE is a `git archive` of another commit unpacked (e.g. into
`build/parent`). Its `src/repro_torch/kernels/dispatch.py` is loaded
beside this tree's as a module of its own (everything it imports comes
from this tree, so only the dispatcher differs), and the two are timed
in turn, ROUNDS times in the order other, this, this, other: 10,000
`gemm` calls of a (2, 16) x (16, 16) weight under the plain policy (the
Python cost of a call, which a host-bound step pays thousands of times),
the best of REPEATS repeats, in microseconds a call, on one thread.
Prints each tree's least and median round: on a shared host the least
is the one least disturbed by other load.
"""
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

CALLS = 10_000
REPEATS = 5
ROUNDS = 10


def load_dispatch(tree: str):
  path = os.path.join(tree, "src", "repro_torch", "kernels", "dispatch.py")
  spec = importlib.util.spec_from_file_location(f"dispatch_{abs(hash(tree))}",
                                                path)
  mod = importlib.util.module_from_spec(spec)
  sys.modules[spec.name] = mod          # its dataclasses look it up
  spec.loader.exec_module(mod)
  return mod


def per_call_us(dispatch, leaf, x) -> float:
  policy = dispatch.JNP_ONLY
  best = float("inf")
  for _ in range(REPEATS):
    t0 = time.perf_counter()
    for _ in range(CALLS):
      dispatch.gemm(leaf, x, policy)
    best = min(best, time.perf_counter() - t0)
  return best / CALLS * 1e6


def main() -> None:
  torch.set_num_threads(1)
  from repro_torch.core.factored import dense
  from repro_torch.kernels import dispatch as this
  leaf = dense(16, 16, name="w", device="cpu",
               generator=torch.Generator().manual_seed(0))
  x = torch.randn(2, 16)
  for other_tree in sys.argv[1:]:
    other = load_dispatch(other_tree)
    runs = {other_tree: [], HERE: []}
    with torch.no_grad():
      for mod in (other, this):           # warm both
        per_call_us(mod, leaf, x)
      for _ in range(ROUNDS):
        for tree, mod in ((other_tree, other), (HERE, this), (HERE, this),
                          (other_tree, other)):
          runs[tree].append(per_call_us(mod, leaf, x))
    out = {t: {"least_us_per_call": min(v),
               "median_us_per_call": statistics.median(v), "runs": len(v)}
           for t, v in runs.items()}
    out["this_over_other"] = {
        "least": min(runs[HERE]) / min(runs[other_tree]),
        "median": statistics.median(runs[HERE]) /
        statistics.median(runs[other_tree])}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
  main()
