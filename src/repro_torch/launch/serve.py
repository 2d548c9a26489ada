"""Serving entry point of the port: streams DS2 speech through the
continuous-batching `StreamingSpeechServer` (the `deepspeech` branch of
`repro.launch.serve`).

Example (on a machine with a GPU; `--device cpu` runs the plain path):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepspeech2-wsj \
      --full --kernels cuda --batch 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.speech import SpeechDataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.models.deepspeech import init_model
from repro_torch.serving.engine import StreamingSpeechServer


def main() -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
  ap.add_argument("--batch", type=int, default=4,
                  help="server slots (concurrent streams)")
  ap.add_argument("--num-requests", type=int, default=None,
                  help="utterances to queue (default: 2 x --batch)")
  ap.add_argument("--full", action="store_true",
                  help="the full config (default: the smoke config)")
  ap.add_argument("--kernels", choices=["plain", "cuda"], default="plain",
                  help="'cuda' routes the frame step through the CUDA "
                       "kernels (kernels.dispatch); 'plain' is plain "
                       "PyTorch")
  ap.add_argument("--quantize", action="store_true",
                  help="one-shot PTQ before serving: every GEMM leaf "
                       "becomes int8 + per-column scales")
  ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args()

  device = resolve_device(args.device)
  cfg = (configs.get_config(args.arch) if args.full
         else configs.get_smoke(args.arch))
  params = init_model(cfg, generator=torch.Generator().manual_seed(args.seed),
                      device=device)
  if args.quantize:
    from repro_torch.core.factored import iter_gemm_leaves
    from repro_torch.quant import QuantizedLinear, quantize_params
    params = quantize_params(params)
    n_int8 = sum(leaf.num_params for leaf in iter_gemm_leaves(params)
                 if isinstance(leaf, QuantizedLinear))
    print(f"PTQ'd {n_int8} GEMM params to int8")

  server = StreamingSpeechServer(cfg, params, batch_size=args.batch,
                                 kernel_policy=args.kernels, device=device)
  n_utts = args.num_requests or 2 * args.batch
  dc = SpeechDataConfig(vocab_size=cfg.vocab_size, feat_dim=cfg.feat_dim,
                        global_batch=max(args.batch, 1))
  rng = np.random.RandomState(args.seed)
  for i in range(n_utts):
    row = batch_at(dc, i)["feats"][i % dc.global_batch]
    t = int(rng.randint(17, min(64, row.shape[0]) + 1))
    server.submit(row[:t])                  # arbitrary lengths by design
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  results = server.run(chunk_frames=16)
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  dt = time.perf_counter() - t0
  frames = sum(r.frames for r in results)
  where = (torch.cuda.get_device_name(device) if device.type == "cuda"
           else "cpu")
  print(f"fleet served {len(results)} utterances ({frames} frames) "
        f"through {args.batch} slots in {dt:.3f}s on {where} "
        f"({len(results) / dt:.1f} streams/s, {frames / dt:.0f} frames/s, "
        f"occupancy {server.occupancy:.2f}, kernels {args.kernels})")
  for r in results[:4]:
    print(f"  utt {r.uid}: {r.frames} frames -> {len(r.labels)} labels; "
          f"sample {r.labels[:6]}")


if __name__ == "__main__":
  main()
