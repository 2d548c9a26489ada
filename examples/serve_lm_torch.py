"""Serve an LM through the PyTorch port's continuous-batching decode
engine: mixed-length requests sharing a few slots (the paper's low-batch
regime), the same model served (a) dense and (b) stage-2 factored,
comparing weight bytes per decode step (the quantity the kernels
stream).

    PYTHONPATH=src python examples/serve_lm_torch.py
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
        --requests 3 --wide-layers 0

The same flow as `examples/serve_lm.py` (the JAX package's), on the
qwen3-4b smoke config in f32, under the kernel policy
(`KernelPolicy(mode="decode")`: factored leaves to `lowrank_gemm`,
decode GEMMs to `decode_matvec`). At smoke width most GEMMs are
narrower than the kernels' 128-lane gate and take the plain path, as the
reference's comment says of its smoke dims (only the 128 x 128 ones
reach `decode_matvec`, and no factored rank reaches `lowrank_gemm`). So
the example then serves qwen3-4b at full width cut to `--wide-layers`
layers (bf16, seeded random weights drawn on the card, as
`chip_smoke.py` phase 8 does), dense and stage-2 factored, where the
kernels launch: it prints
each kernel's launch count (`kernels.ops.LAUNCHES`; on the CPU the
wrappers run their plain versions and count none). A full-width model
is never built on the CPU (`--wide-layers 0` there). `--device`
defaults to the GPU and raises without one.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.compress import FactorizationPlan, to_stage1, to_stage2
from repro_torch.core.factored import count_params, frozen
from repro_torch.core.svd import TruncationSpec
from repro_torch.kernels import dispatch, ops
from repro_torch.models.api import get_model
from repro_torch.serving import LMEngine


def serve(tag, cfg, params, requests, device) -> dict:
  policy = dispatch.KernelPolicy(mode="decode")
  eng = LMEngine(cfg, params, batch_size=4, max_len=64,
                 kernel_policy=policy, device=device)
  for prompt, budget in requests:
    eng.submit(prompt, max_new_tokens=budget)
  ops.reset_launches()
  t0 = time.perf_counter()
  finished = eng.run(temperature=0.7)
  dt = time.perf_counter() - t0
  launches = {k: v for k, v in ops.LAUNCHES.items() if v}
  tokens = sum(len(f.tokens) for f in finished)
  print(f"  [{tag}] params {count_params(params):,}; {tokens} tokens over "
        f"{len(finished)} requests, {tokens / dt:.1f} tok/s, "
        f"occupancy {eng.occupancy:.2f}; launches {launches or 'none'}; "
        f"sample {finished[0].tokens[:6].tolist()}")
  return dict(tokens=tokens, requests=len(finished), launches=launches,
              occupancy=eng.occupancy, params=count_params(params))


def compress(params, plan: FactorizationPlan, spec: TruncationSpec):
  """The stage-2 model of `params`: the truncated SVD of every GEMM the
  plan matches."""
  return frozen(to_stage2(params, plan, spec))


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default=None,
                  help="torch device (default: the GPU)")
  ap.add_argument("--requests", type=int, default=8)
  ap.add_argument("--wide-layers", type=int, default=1,
                  help="layers of the full-width qwen3-4b (0: skip; the "
                       "card only)")
  args = ap.parse_args(argv)
  device = torch.device("cuda" if args.device is None else args.device)

  cfg = configs.get_smoke("qwen3-4b").with_(vocab_size=512,
                                            dtype=torch.float32)
  params = frozen(get_model(cfg).init(
      cfg, generator=torch.Generator().manual_seed(0), device=device))
  rng = np.random.RandomState(0)
  # mixed-length requests through 4 slots: retired slots refill mid-run
  requests = [(rng.randint(1, 512, size=(rng.randint(3, 12),)),
               int(rng.randint(4, 16))) for _ in range(args.requests)]
  out = {}
  print("== dense serving ==")
  out["dense"] = serve("dense", cfg, params, requests, device)
  print("== stage-2 factored serving (paper's compressed path) ==")
  plan = FactorizationPlan(min_dim=64)
  factored = compress(to_stage1(params, plan), plan,
                      TruncationSpec(variance_threshold=0.8, round_to=8))
  out["factored"] = serve("factored", cfg, factored, requests, device)
  p0, p1 = count_params(params), count_params(factored)
  print(f"  {100 * (1 - p1 / p0):.0f}% fewer weight bytes to stream "
        f"per decode step")

  if args.wide_layers:
    wcfg = configs.get_config("qwen3-4b").with_(num_layers=args.wide_layers)
    print(f"== qwen3-4b at full width, {args.wide_layers} of its "
          f"{configs.get_config('qwen3-4b').num_layers} layers (bf16) ==")
    wide = frozen(get_model(wcfg).init(
        wcfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device))
    wreq = [(rng.randint(1, wcfg.vocab_size, size=(rng.randint(3, 12),)),
             int(rng.randint(4, 16))) for _ in range(args.requests)]
    out["wide_dense"] = serve("wide dense", wcfg, wide, wreq, device)
    # rank 256 of every layer GEMM; the 151936-row head stays dense
    wide = compress(wide, FactorizationPlan(exclude=("lm_head",)),
                    TruncationSpec(fixed_rank=256))
    out["wide_factored"] = serve("wide factored", wcfg, wide, wreq, device)
  return out


if __name__ == "__main__":
  main()
