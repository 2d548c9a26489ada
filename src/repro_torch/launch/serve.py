"""Serving entry point of the port: drives a queue of mixed-length
requests through the continuous-batching `LMEngine` (vanilla, or
self-speculative with the truncated-SVD draft: `--speculate`), or streams
DS2 speech through the `StreamingSpeechServer` — the counterpart of
`repro.launch.serve` without the prefix cache.

Examples (on a machine with a GPU; `--device cpu` runs the plain path):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --full --kernels cuda --batch 4 --num-requests 8 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --device cpu --speculate 3 --draft-rank 8 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite \
      --device cpu --speculate 3 --draft-rank 8 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --device cpu --speculate 2
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
from repro_torch.models.api import get_model
from repro_torch.serving.engine import LMEngine, StreamingSpeechServer
from repro_torch.serving.speculative import (RankController,
                                             make_draft_params)


def main(argv=None) -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
  ap.add_argument("--batch", type=int, default=4,
                  help="engine / server slots (concurrent streams)")
  ap.add_argument("--num-requests", type=int, default=None,
                  help="requests or utterances to queue (default: --batch "
                       "for an LM, 2 x --batch for speech); extras refill "
                       "slots as earlier ones retire")
  ap.add_argument("--steps", type=int, default=16,
                  help="LM: per-request new-token budget (requests draw "
                       "varying budgets up to this)")
  ap.add_argument("--prompt-len", type=int, default=8,
                  help="LM: mean prompt length; requests draw varying "
                       "lengths around this")
  ap.add_argument("--max-len", type=int, default=128)
  ap.add_argument("--temperature", type=float, default=0.8)
  ap.add_argument("--eos-id", type=int, default=None,
                  help="LM: token id retiring a request early")
  ap.add_argument("--full", action="store_true",
                  help="the full config (default: the smoke config)")
  ap.add_argument("--kernels", choices=["plain", "cuda"], default="plain",
                  help="'cuda' routes the decode step (and the frame "
                       "step) through the CUDA kernels (kernels.dispatch);"
                       " 'plain' is plain PyTorch")
  ap.add_argument("--quantize", action="store_true",
                  help="one-shot PTQ before serving: every GEMM leaf "
                       "becomes int8 + per-column scales")
  ap.add_argument("--speculate", type=int, default=0, metavar="K",
                  help="LM: self-speculative decoding: a low-rank draft "
                       "of the same params proposes K tokens a step, the "
                       "target verifies them in one window. Greedy "
                       "(--temperature 0) emits vanilla greedy's tokens; "
                       "temperature > 0 rejection-samples, matching "
                       "vanilla sampling's distribution")
  ap.add_argument("--draft-rank", type=int, default=None,
                  help="fixed truncated-SVD rank of the draft's GEMMs "
                       "(default: the explained-variance rule at 0.9)")
  ap.add_argument("--adapt-rank", action="store_true",
                  help="online draft-rank controller: walk --draft-rank "
                       "to keep the measured accept rate inside "
                       "--rank-band (needs --draft-rank)")
  ap.add_argument("--rank-band", type=float, nargs=2, default=(0.5, 0.85),
                  metavar=("LO", "HI"),
                  help="target accept-rate band for --adapt-rank")
  ap.add_argument("--rank-step", type=int, default=16,
                  help="rank change per --adapt-rank adjustment")
  ap.add_argument("--rank-interval", type=int, default=8,
                  help="engine iterations per --adapt-rank measurement")
  ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args(argv)
  if args.adapt_rank and args.draft_rank is None:
    ap.error("--adapt-rank needs --draft-rank (a starting rank to walk)")
  if args.adapt_rank and args.quantize:
    ap.error("--adapt-rank rebuilds the draft from the served params, "
             "which int8 leaves cannot be factored from: drop one flag")

  device = resolve_device(args.device)
  cfg = (configs.get_config(args.arch) if args.full
         else configs.get_smoke(args.arch))
  # a full-width LM is drawn on the card (a CPU draw of 8B values takes
  # minutes); DS2 and the smoke configs draw on the CPU
  on_card = (args.full and device.type == "cuda"
             and cfg.family in ("transformer", "zamba"))
  gen_device = device if on_card else "cpu"
  gen = torch.Generator(device=gen_device).manual_seed(args.seed)
  params = get_model(cfg).init(cfg, generator=gen, device=device)
  if args.speculate and cfg.family == "deepspeech":
    # the streaming CTC server is frame-synchronous: there is no token
    # sequence to draft
    print("--speculate applies to the LM engine only; the deepspeech "
          "family streams frame-synchronously — ignoring")
    args.speculate = 0
  draft = None
  if args.speculate and args.quantize:
    # int8 leaves cannot be factored: the draft comes from the float
    # weights, before PTQ
    draft = make_draft_params(params, rank=args.draft_rank)
  if args.quantize:
    from repro_torch.core.factored import iter_gemm_leaves
    from repro_torch.quant import QuantizedLinear, quantize_params
    params = quantize_params(params)
    n_int8 = sum(leaf.num_params for leaf in iter_gemm_leaves(params)
                 if isinstance(leaf, QuantizedLinear))
    print(f"PTQ'd {n_int8} GEMM params to int8")
  where = (torch.cuda.get_device_name(device) if device.type == "cuda"
           else "cpu")
  if cfg.family == "deepspeech":
    serve_speech(args, cfg, params, device, where)
  else:
    serve_lm(args, cfg, params, device, where, draft)


def _timed(device, fn):
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  out = fn()
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  return out, time.perf_counter() - t0


def serve_lm(args, cfg, params, device, where, draft=None) -> None:
  controller = None
  if args.adapt_rank:
    controller = RankController(band=tuple(args.rank_band),
                                step=args.rank_step,
                                interval=args.rank_interval)
  engine = LMEngine(cfg, params, batch_size=args.batch,
                    max_len=args.max_len, kernel_policy=args.kernels,
                    eos_id=args.eos_id, speculate=args.speculate,
                    draft_params=draft, draft_rank=args.draft_rank,
                    rank_controller=controller, device=device)
  spec = ""
  if args.speculate:
    from repro_torch.core.factored import count_params
    print(f"speculating {args.speculate} tokens a step with a "
          f"{count_params(engine.draft_params)}-param low-rank draft "
          f"(target {count_params(params)})")
  rng = np.random.RandomState(args.seed)
  lo, hi = max(1, args.prompt_len // 2), 2 * args.prompt_len
  for _ in range(args.num_requests or args.batch):
    prompt = rng.randint(1, cfg.vocab_size, size=(rng.randint(lo, hi + 1),))
    engine.submit(prompt, max_new_tokens=int(rng.randint(1, args.steps + 1)))
  finished, dt = _timed(device, lambda: engine.run(
      temperature=args.temperature))
  tokens = sum(len(f.tokens) for f in finished)
  ttfts = sorted(f.ttft_s for f in finished if f.ttft_s is not None)
  ttft_p50 = ttfts[len(ttfts) // 2] * 1e3 if ttfts else float("nan")
  if args.speculate:
    # None until something was drafted: "no data", not 0
    rate = engine.accept_rate
    spec = (f", accept rate {rate:.2f}" if rate is not None
            else ", accept rate n/a")
    if args.adapt_rank:
      spec += (f", draft rank {engine.draft_rank} "
               f"({len(engine.rank_history)} adjustments)")
  print(f"served {len(finished)} requests ({tokens} tokens) through "
        f"{args.batch} slots in {dt:.3f}s on {where} ({tokens / dt:.1f} "
        f"tok/s, TTFT p50 {ttft_p50:.1f} ms, occupancy "
        f"{engine.occupancy:.2f}{spec}, kernels {args.kernels})")
  for f in finished[:4]:
    print(f"  req {f.uid}: prompt {len(f.prompt)} -> {len(f.tokens)} "
          f"tokens ({f.finish_reason}); sample {f.tokens[:6].tolist()}")


def serve_speech(args, cfg, params, device, where) -> None:
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
  results, dt = _timed(device, lambda: server.run(chunk_frames=16))
  frames = sum(r.frames for r in results)
  print(f"fleet served {len(results)} utterances ({frames} frames) "
        f"through {args.batch} slots in {dt:.3f}s on {where} "
        f"({len(results) / dt:.1f} streams/s, {frames / dt:.0f} frames/s, "
        f"occupancy {server.occupancy:.2f}, kernels {args.kernels})")
  for r in results[:4]:
    print(f"  utt {r.uid}: {r.frames} frames -> {len(r.labels)} labels; "
          f"sample {r.labels[:6]}")

if __name__ == "__main__":
  main()
