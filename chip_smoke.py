#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

  python3 chip_smoke.py          # from the repository root; needs one GPU

1. Prints the card (`nvidia-smi` name and power limit), the torch and CUDA
   versions, and builds the five CUDA kernels from `src/repro_torch/
   kernels/csrc/` (nvcc, one process per source, into `build/kernels/`).
2. Holds each kernel against its plain PyTorch version (`kernels/ref.py`)
   on the card at every full-width `deepspeech2-wsj` shape the serving
   path launches it with, at batch 1, 4 and 16 in bf16 (and once in f32);
   `decode_matvec` and `lowrank_gemm` also at ragged shapes (m and n off
   every tile and vector width) at batch 1, 4, 5, 16 and 17 in bf16 and
   f32, `lowrank_gemm` there also with a plan forced to several waves of
   blocks, alone and beside a long product on a second stream (its ticket
   order cannot deadlock), `int8_gemm` at ragged and unaligned shapes (m
   off every quad, n off every lane's columns, w_q rows off a 16-byte
   boundary), `gru_cell` at ragged H (200 off its unit tile; 333 and 1030
   off a 16-byte row of U) at batch 1, 4, 5, 16 and 17 in bf16 and f32,
   also with k ranges of 8 rows, alone and beside a busy stream, every
   `gru_cell` case called twice (the calls must agree bit for bit: its
   split-K sums run in a fixed order); `decode_matvec` at the full-width
   `llama3-8b` decode shapes at batch 4, and `flash_attention` at the
   prefill's grouped-kv (1, 4096, 32 q / 8 kv heads, 128) (k and v not
   repeated; the plain version repeats them), at (1, 4096, 32, 128), at (1, 32768, 32, 128)
   (its plain version by query-row chunks) and at (1, 1024, 32, 128)
   causal bf16, once causal in f32 and once non-causal at a ragged
   (1, 1500, 12, 64) in bf16, and at zamba2-7b's head width 112 causal
   at (1, 4096, 32, 112) in bf16 (timed), non-causal at a ragged GQA
   (1, 1000, 32 / 8, 112) and causal in f32: bf16 within atol = rtol =
   1e-2 (one bf16
   rounding of the output is 2^-8 relative), f32 within 1e-4 (summation
   order), int8 bit for bit; `flash_attention` also row by row against
   each row's own scale (`FLASH_ROW_RTOL`). Times the kernel, the plain
   version and the PyTorch library call (`torch.matmul`,
   `scaled_dot_product_attention` on the (b, h, s, d) transpose, with
   `enable_gqa` for grouped kv heads, ...) with CUDA events (median of
   20-50 launches, queued behind a device sleep so the host does not
   starve the card) and prints one JSON line per kernel and shape;
   `int8_gemm` has no one-call library equivalent at b <= 16 and gets a
   yardstick instead, `torch._int_mm` on x_q zero-padded to 32 rows, no
   dequant (`int_mm_padded_ms`), and `gru_cell` (no PyTorch call has its
   gate order) `torch.matmul(h, U)`, the recurrent product without the
   gates (`matmul_h_u_ms`). Then it traces one `lowrank_gemm` call
   at the largest factored leaf with `torch.profiler` and requires exactly
   one device kernel (the fused launch). Weights
   that fit stay warm in the 50 MB L2 across those launches; at the
   `llama3-8b` decode shapes `decode_matvec` and `torch.matmul` are also
   timed cold, with the L2 evicted before every timed call by reading a
   256 MB buffer (outside the events), as a real decode step finds them;
   so are `gru_cell` and its yardstick at the DS2 shapes at batch 4.
   `decode_matvec` and `lowrank_gemm` are also held, at the f32
   tolerance, and timed with f32 activations over bf16 weights at one
   xlstm-350m recurrent head, (4, 256) x (256, 1024) and its rank-128
   factors (their library call: `torch.matmul` on f32 copies of the
   weights, made outside the timed call).
3. Serves the full-width config (bf16, random weights from seed 0) with
   4 slots and 8 utterances of 17..64 frames, through
   `StreamingSpeechServer`, three times: dense, factored (rank 256 on
   every leaf `FactorizationPlan()` matches) and PTQ'd int8 — each with
   the "cuda" policy and again with the "plain" policy on the card. It
   requires every expected kernel's launch count to rise and no other,
   the routing log to equal the expected table, the per-frame log-probs
   of the two policies to agree (dense/factored within atol 0.05, see
   `SERVE_ATOL`; PTQ'd exactly) and PTQ'd labels to be equal.
4. Prefill: full-width `llama3-8b` (bf16, random weights from a seeded
   CUDA generator), `transformer.forward(last_only=True)` on one
   4096-token prompt under the "cuda" and the "plain" policy. Requires
   exactly 32 `flash_attention` launches (one a layer) and one
   `decode_matvec` (the head at the last position; the layers' GEMMs have
   a flat batch of 4096 and stay plain) for the kernel run, none for the
   plain run, last-position log-probs within
   `PREFILL_ATOL`, and equal greedy tokens unless the plain run's top-2
   gap is below that tolerance. Prints prefill tokens/s for each.
5. Serving: `LMEngine` on the same weights, 4 slots, 8 requests with
   prompts of 4..16 tokens and budgets of 1..16 drawn as `launch.serve`
   draws them, greedy. Correctness: a recorded "plain" run, and a
   recorded "cuda" run fed the plain run's sampled tokens (teacher
   forcing), so every call of both sees the same inputs; every call's
   live log-probs must agree within `LM_SERVE_ATOL` (a MoE model's, up to
   its sequence's first route flip: phase 11), and their argmax may
   differ only where the plain run's top-2 gap is below it. Requires every
   GEMM of the "cuda" runs to route to `decode_matvec` (225 launches a
   step: 32 layers x 7 GEMMs and the head) and no launch under "plain".
   Then one run of each policy with no hooks prints tok/s and TTFT p50:
   smoke readings of a tiny mix, not serving metrics. Last, it times a
   batch-4 decode step with each stack's per-layer views (`layers()`)
   kept and with them rebuilt, and `layers()` alone.
6. Training: the port's two-stage recipe on the card. First one f32
   `Trainer` step at the DS2 smoke width on the card and on the CPU from
   the same weights (the CPU trainer's, through a checkpoint) and batch:
   the loss within `TRAIN_LOSS_RTOL`, each gradient within
   `TRAIN_GRAD_RTOL` and each leaf's update within `TRAIN_UPDATE_RTOL`
   (relative, in norm). Then full `deepspeech2-wsj` (bf16, random
   weights from seed 0) for 8 steps of batch 16 from `data/speech.batch_at`
   with `TwoStageSchedule`: trace norm at lambda 1e-4 on both groups,
   `launch/train.py`'s plan, the transition at step 4. Requires finite
   losses, stage 2 from step 4, fewer parameters after the transition,
   and every factored leaf's rank a multiple of 8 and <= min(m, n); prints
   the ranks, `compression_report`'s totals, the first 5 GEMMs' nu and
   each stage's median step (its first step and its profiled one left
   out), and `torch.profiler`'s device time of one step of each stage (by
   kernel, and the device's idle share of the stage's median step). Saves the
   trained state with `CheckpointManager`, restores it into a fresh
   `Trainer` and requires every leaf equal bit for bit. Last, it holds
   `lowrank_gemm` and `int8_gemm` against their plain versions at the
   trained shapes (uneven ranks) and serves the trained weights and their
   PTQ'd form as phase 3 does (`launches_by_path` key `ds2_trained`).
7. Speculative serving, after phase 5, on llama3-8b at full width cut to
   `SPEC_LAYERS` (4) layers (seeded random weights as phase 4's): the
   ported `make_draft_params` builds the rank-128 truncated-SVD draft on
   the card (timed, 29 SVDs; every GEMM leaf factored, the embedding and
   norms the target's own storage). `lowrank_gemm` is held against its plain
   version, and timed against two `torch.matmul` calls and its bound, at
   each distinct draft shape at batch 1 (a draft prefill) and 4 (a draft
   step), and `decode_matvec` at the target's shapes at the verify
   window's 16 rows. One 16-row `decode_window` against the 4 steps it
   stands for (log-probs within `LM_SERVE_ATOL`). Then
   `LMEngine(speculate=3, kernel_policy="cuda")` serves phase 5's 8
   requests greedily: every draft GEMM must route to `lowrank_gemm` and
   every target GEMM (admission steps and verify windows) to
   `decode_matvec`, with exactly 29 launches a counted call; each
   request's tokens equal vanilla greedy's under the same policy up to
   its first flip, which must sit at a vanilla log-prob gap below
   `LM_SERVE_ATOL` (a near-tie). Draft build time, accept rate and tok/s
   (hook-free runs of both engines) are smoke readings; with random
   weights the accept rate is near 0. A speculative engine under the
   "plain" policy launches nothing (`launches_by_path` key
   `lm_speculative`).
8. The rest of the dense family at full width, after phase 6: `qwen3-4b`
   (qk-norm, bf16, seeded random weights) cut to `QWEN_LAYERS` (12 of its
   36 layers) has `decode_matvec`
   held and timed, warm and cold, at its decode step's shapes (batch 4),
   then runs phase 4's 4096-token prefill (exactly 12 `flash_attention`
   launches) and phase 5's serving (exactly 85 `decode_matvec` launches
   a step) under both policies with their tolerances; `stablelm-3b` at
   full width (head width 80) cut to `STABLELM_LAYERS` layers runs the
   prefill through the d = 80 kernel, one launch a layer, so a decline
   to the plain path fails the phase. Phase 2 holds the d = 80 kernel
   at stablelm's prefill shape (timed, against SDPA) and at ragged
   lengths in bf16 and f32, causal and not.
9. The two-stage recipe on the transformer: first phase 6's f32 card
   vs CPU step at the `qwen3-4b` smoke width; then `qwen3-4b` at full
   width cut to `LM_TRAIN_LAYERS` layers (bf16, remat "full", random
   weights from a seeded CUDA generator) trained `TRAIN_STEPS` steps of
   `data/lm.py` batches of `LM_TRAIN_BATCH` x `LM_TRAIN_SEQ` tokens,
   transition at `TRAIN_TRANSITION`, with phase 6's checks on losses,
   stages and ranks; prints ms a step by stage (one step a stage under
   `torch.profiler`, as in phase 6), the transition's ms, the ranks and
   the parameters against the dense model. The trained model,
   frozen, has `lowrank_gemm` held and timed at its shapes, and is served
   as in phase 5 with every GEMM through `lowrank_gemm` (15 launches a
   step).
10. Whisper, after phase 9: full-width `whisper-small` (12 + 12 layers,
   bf16, random weights from a seeded CUDA generator; `attn_block_kv`
   500, the block the reference needs for 1500 frames), 4 streams of
   1500 frames of seeded random features (the frontend is a stub, as in
   the reference). (a) `encode` under "cuda" and "plain": exactly 12
   non-causal `flash_attention` launches and no other (every GEMM has
   6000 rows) and none under "plain", memories within `WHISPER_ATOL`.
   (b) A teacher-forced greedy loop of `api.decode_step` from the plain
   memory, 4 slots, `WHISPER_STEPS` steps: exactly 96 `decode_matvec`
   launches a step (12 layers x self q/k/v/o, cross q/o, ffn in/out;
   the cross k/v over 6000 rows and the tied head stay plain),
   log-probs within `LM_SERVE_ATOL`, argmax flips only at near-ties;
   ms an encode and a step under both policies. (c) LiteASR:
   `calibrate_activation_stats` over `encode_unrolled` (plain policy)
   for `WHISPER_CALIB_BATCHES` batches, `to_stage2` over "enc/*" at rank
   `WHISPER_RANK` with those stats and without (the weight spectrum);
   the calibrated model encodes with exactly 72 `lowrank_gemm` + 12
   flash launches, within `WHISPER_ATOL` of "plain", and its
   activation-weighted error sum over the 72 layer GEMMs,
   sum_i tr((W - UV)^T C_i (W - UV)), must not exceed the spectrum-only
   truncation's. (d) Calibrated PTQ: `calibrate_activation_ranges`,
   `quantize_params(calib=)` (encoder leaves static scales, decoder
   leaves dynamic, as the reference), an encode with exactly 72
   `int8_gemm` + 12 flash launches and `WHISPER_PTQ_STEPS` decode steps
   with exactly 120 `int8_gemm` launches each, both within tolerance of
   "plain". (e) Kernel rows: non-causal flash at (4, 1500, 12, 64)
   against SDPA, `decode_matvec` at the decode step's shapes (cold and
   warm) against `torch.matmul`, `lowrank_gemm` and `int8_gemm` at the
   encoder's 6000-row shapes against two `torch.matmul` / `torch._int_mm`
   (a yardstick: no dequant).
11. DeepSeek, after phase 10 (MLA, the capacity-routed MoE with shared
   experts; MLA attention runs the reference's blockwise softmax in
   plain PyTorch, so no flash launch). (b) `deepseek-v2-lite` at full
   width in f32 cut to `DS_F32_LAYERS` layers: 4 prompts of
   `DS_F32_PREFILL` tokens through one `decode_window`, then
   `DS_F32_STEPS` teacher-forced decode steps under "plain" and "cuda",
   under `moe.record_routes()`: routes identical, log-probs within
   `DS_F32_ATOL`, exactly 25 `decode_matvec` launches a step. (a), (c)
   `DS_LAYERS` layers (1 dense + 8 MoE of its 1 + 26) in bf16:
   `decode_matvec` held and timed (warm and cold)
   at the decode step's shapes; the 4096-token prefill under both
   policies (one launch, the head; no flash; log-probs held to the
   head's bf16 rounding, `HEAD_ONLY_RTOL`); `LMEngine` as in phase 5
   (55 launches a step), gated on the route log: every first route
   difference between the policies (not caused by an earlier one of its
   sequence at a lower layer and an earlier or equal position) must be a
   near-tie (`ROUTE_LOGIT_GAP`), log-probs are held to `LM_SERVE_ATOL`
   up to a sequence's first flip, and a third run on the plain run's
   routes (`moe.replay_routes`) is held to it at every call and measures
   how far the arithmetic alone moves the router's logit gaps, which
   must stay below `ROUTE_LOGIT_GAP`; then one decode step and one
   prefill timed and profiled (`profile_paths`). (d) The f32
   card-vs-CPU step at `deepseek-v3-671b`'s smoke width (q-LoRA, MTP);
   `deepseek-v2-lite` at full width cut to `DS_TRAIN_LAYERS` (1 dense +
   1 MoE), bf16, trained as phase 9 (every GEMM of at least 32 wide
   factored, the expert stacks included), then frozen and served with
   exactly 13 `lowrank_gemm` launches a step. (e) `deepseek-v3-671b` at
   full width cut to `DS3_LAYERS` (3 dense + 1 MoE of 256 experts,
   top-8, q-LoRA 1536, MTP head built): `decode_matvec` at its shapes,
   then as (b) in bf16 with `DS3_PREFILL` tokens and `DS3_STEPS` steps
   (29 launches a step), gated on the route log as (c).
12. zamba2-7b, after phase 11: the first carry family (a Mamba2
   backbone, its chunked SSD scan plain PyTorch in f32, and one shared
   attention block before each group of 6 layers, head width 112). (a)
   Cut to `ZAMBA_LAYERS` (4 groups and a tail of 3, of the full
   model's 13 groups and 3) in bf16 (seeded CUDA generator): every GEMM
   of a batch-4 decode step must classify to `decode_matvec`
   (3 x 27 Mamba2 + 7 x 4 shared + the head = 110 launches a step),
   which is held and timed, warm and cold, at those shapes. (b) Phase
   4's 4096-token prefill under both policies: exactly 4
   `flash_attention` launches (one a group, d = 112) and the head's
   `decode_matvec`, each flash call held in place against its plain
   version on its own inputs; the policies' log-probs are compared on
   an f32 copy of the weights within `F32_LOGPROB_ATOL` (two bf16 runs
   of this model part by as much as bf16 from f32), and the residual
   stream's drift after each group and the tail is printed for both
   precisions (`check_prefill(drift=)`). (c) Phase 5's
   `LMEngine` serving (110 launches a step; log-probs compared on the
   f32 copy likewise), then one decode step and one prefill timed and
   profiled (`profile_paths`): the SSD scan's share of the prefill's
   device time (its calls marked with `record_function`) and the
   device's idle shares.
   (e) Cut to `ZAMBA_CUT_LAYERS` (one group and one tail layer): the
   rank-128 draft built on the card, `lowrank_gemm` held at its shapes,
   the engine's masked replay against the steps it stands for (accepted
   lengths 1..4, carries bit for bit), then, with the target's residual
   beyond the draft shrunk to `ZAMBA_SPEC_RESIDUAL` so that the draft
   agrees on some tokens, `LMEngine(speculate=3)` as phase 7 holds
   llama3-8b's, which must take a masked replay (live slots committing
   different lengths) at least once (`check_cut_speculative`, shared
   with phase 13). (d) Phase 6's f32 card-vs-CPU step
   at the zamba smoke width (updates within `ZAMBA_UPDATE_RTOL`), then
   the cut model trained as phase 9 and served with every GEMM through
   `lowrank_gemm` (29 launches a step).
13. xlstm-350m, after phase 12: 12 (mLSTM, sLSTM) pairs, d 1024, 4 heads
   (bf16, seeded CUDA generator). (b, first) every GEMM of a batch-4
   decode step but the mLSTM's gate projection must classify to
   `decode_matvec` (per pair up, qkv, down, wx, out and the 4 recurrent
   heads on f32 activations, and the head: 109 launches a step), held
   and timed, warm and cold. (a) One `XLSTM_PREFILL_LEN`-token (1024)
   batch-1 prefill under both policies through
   `check_prefill(recurrent=)`, teacher-forced: the layer GEMMs stay
   plain and each token of each pair launches 4 recurrent
   `decode_matvec`s (49,152); log-probs at every position
   compared on an f32 copy (F32_LOGPROB_ATOL; the bf16 difference and
   the drift after each pair are printed, see the comment above
   `XLSTM_PROFILE_LEN`). (b) Phase 5's `LMEngine` serving (109 launches
   a step, compared on the f32 copy), then one decode step and a
   64-token prefill timed and profiled (`profile_paths`) for the
   device's busy share. (e) The prefix cache
   (`check_prefix_cache`): an engine with a `PrefixCache` of 256 MB and
   `publish_on_retire` against one without, 8 requests (6 opening with a
   16-token template) and a second turn of 2 conversations: tokens equal
   token for token, hits in the first turn, evictions (an xlstm snapshot
   is ~50 MB); a state spliced at the template and stepped on equals the
   cold prefill's bit for bit; TTFT p50 with and without hits. (c) Cut
   to `XLSTM_CUT_LAYERS` (2 pairs): the rank-128 draft built on the card
   (the gate projection shared), `lowrank_gemm` held and timed at its
   shapes (the recurrent heads on f32 activations), then in f32 the
   masked replay against its steps, the residuals shrunk
   (`XLSTM_SPEC_RESIDUAL`) and `LMEngine(speculate=3)` as phase 7 (its
   windows launch the recurrent heads position by position), which must
   take a masked replay. (d) Phase 6's f32 card-vs-CPU step at the xlstm
   smoke width, then the cut model trained as phase 9 and served through
   `lowrank_gemm` (19 launches a step). (e, last) The prefix cache again
   on qwen3-4b at full width cut to `PREFIX_QWEN_LAYERS` (4) layers (KV
   rows sliced; no eviction, so every second-turn hit reaches the first
   turn's fed length).
14. Distribution, after phase 13, on an NCCL world of one
   (`dist.make_mesh((1, 1), ("data", "model"))`, which initialises it).
   (a) Full-width `deepspeech2-wsj` trained as phase 6 (bf16, 8 steps of
   batch 16 through the transition) with `optimizer="q_adam"` under
   `Trainer(mesh=)` and again with no mesh: the losses, stages and every
   parameter must be equal bit for bit; q_adam's moment bytes
   (`torch.cuda.memory_allocated` around its init on the mesh's
   parameters) must stay under `Q_ADAM_BYTES_RATIO` of AdamW's; both
   trained stage-2 models (the mesh's gathered) are served as phase 6
   serves its own, with equal labels and launch counts. (b)
   `LMEngine(mesh=)` on `qwen3-4b` at full width cut to
   `PREFIX_QWEN_LAYERS` layers against `mesh=None`, phase 5's 8
   requests under "cuda": tokens and `decode_matvec` launches equal.
   `compressed_grad_mean` through the world's all-reduces, within
   `COMPRESS_REL` of the exact mean. (c) `deepseek-v2-lite` at full
   width cut to phase 11's 2 layers (its expert stacks left dense,
   `MESH_DS_EXCLUDE`) trained through the transition under a mesh and
   with none: losses, parameters and routes bit for bit. (d)
   `LMEngine(mesh=)` against `mesh=None` on deepseek-v2-lite, zamba2-7b,
   xlstm-350m (cut, `MESH_LAYERS`) and whisper-small; (e) zamba2-7b's
   speculative engine; (f) qwen3-4b's prefix cache: tokens, launches,
   replays and cache statistics equal. (g) `flash_attention` under
   `heads_local`: whisper-small's `encode` and the zamba2-7b cut's
   prefill on the mesh and with none, bit for bit with equal launches.
   Two ranks sharing the card (gloo on CUDA tensors) are not run:
   DTensor's all-gather dies there (`chip_gloo_probe.py`).
15. The examples and the static auditor (ROADMAP A5b, A7a): (a)
   `examples/quickstart_torch.py`, `compress_model_torch.py` and
   `serve_lm_torch.py` on the card (serve_lm's full-width qwen3-4b runs
   launch `decode_matvec` and `lowrank_gemm`); (b)
   `repro_torch.analysis.run_audit` on the default grid at smoke scale
   under both policies on the card, with its budgets, held to the port's
   baseline (the CPU's findings) and to its `budgets.json` (the CPU's
   ledgers): nothing new, nothing stale, no ratchet-stale ledger, and so
   no finding only the card shows (`CARD_ONLY_KEYS`) and no cost, memory
   or compression budget finding; (c) a warmed qwen3-4b decode step at
   full width (`QWEN_LAYERS`) walked under `KernelPolicy(mode="decode")`:
   no bypass, each kernel scope one launch of its kernel, no sync under
   `set_sync_debug_mode("error")`, every state storage kept, the
   liveness estimate beside `max_memory_allocated`'s rise, and the step's
   cost ledger (FLOPs, HBM bytes, the roofline terms at the H100's
   peaks, `dist.hlo_cost`) beside its measured time.
16. Prints each phase's seconds, the card line, `{"kernels": [...]}`
   with each kernel's numbers, all measured in this run but the computed
   bounds, then, as the last line, `{"ok": true, "device": {...}}`. Any
   failure raises: the script exits non-zero and prints no result line.

On an H100 the build takes about 30 s (nvcc, the five sources in
parallel) and phases 2-6 about a minute and a half; phase 7's draft
build runs 29 exact SVDs on the card (225 before its depth cuts, ~257 s).
Phases 8, 11 and 12 run their serving paths cut in depth (`QWEN_LAYERS`,
`DS_LAYERS`, `ZAMBA_LAYERS`): at 36, 27 and 81 layers they took ~78,
~228 and ~250 s, and the script came within 100 s of its 1200 s limit.
Phase 15's arrival cut phase 7 from 8 layers to 4 (29 SVDs).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  torch.int8: 1979e12}
BATCHES = (1, 4, 16)
SERVE_BATCH = 4
#: per-frame log-prob agreement of the "cuda" and "plain" policies in
#: bf16. The two round at different places (the kernels keep hu and the
#: rank intermediate in f32; the plain path rounds them to bf16) and the
#: difference travels through the recurrence (measured: <= 5e-3 on an
#: H100 at full width, 8 utterances).
SERVE_ATOL = 0.05
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
#: flash_attention is also held row by row to the row's own scale: a late
#: causal row averages thousands of rows of v, so its outputs are tens of
#: times smaller than an early row's, and TOL's absolute part says little
#: there. Each output row (one query position of one head) must have max_d |err|
#: <= FLASH_ROW_RTOL * max_d |want|. In bf16 both sides round their f32
#: result once, which differs by at most one ulp of the row's largest
#: value (<= 2^-7 of it); the limit allows a second ulp for the f32 sums
#: (the kernel rounds P to bf16 for the PV product, the plain version
#: does not). Measured on an H100: 2^-7 in every bf16 case, 2e-6 in f32.
FLASH_ROW_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
LM_ARCH = "llama3-8b"
PREFILL_LEN = 4096
#: last-position log-prob agreement of the prefill under the "cuda"
#: (flash kernel) and "plain" (blockwise) policies in bf16: the kernel
#: rounds P to bf16 for the PV product and the plain path does not, and a
#: one-ulp flip travels through 32 layers (measured: 0.086 on an H100 at
#: full width, one 4096-token prompt)
PREFILL_ATOL = 0.25
#: a prefill with no flash (MLA's) runs the same plain code below the head
#: under both policies, and only the head's one-row GEMM differs
#: (decode_matvec against cuBLAS): each rounds its f32 logit to bf16, so a
#: logit differs by at most one bf16 ulp, <= 2^-7 of the largest |logit|,
#: and a log-prob (the logit less the log-sum-exp, which moves by at most
#: the largest logit change) by twice that: the limit is HEAD_ONLY_RTOL x
#: max |logit| (measured: 0.0156, one ulp at a logit in [2, 4), on an H100
#: at full deepseek-v2-lite width, one 4096-token prompt)
HEAD_ONLY_RTOL = 2.0 ** -6
#: per-call log-prob agreement of the LMEngine under both policies in
#: bf16, both fed the same tokens: the decode_matvec kernel sums in f32 in
#: another order than cuBLAS, and each step's KV rows carry the difference
#: forward (measured: 0.117 on an H100 at full width over all 100 calls)
LM_SERVE_ATOL = 0.25
#: (b, s, h, h_kv, d, causal, dtype, timed): the prefill's shape first
#: (llama3-8b's 8 kv heads, read in place), the same with repeated heads
#: (the shape of the kernel's first version), then the reference's
#: prefill_32k length (its plain version by row chunks)
#: (the qwen3-4b prefill's shape is llama3-8b's), then stablelm-3b's
#: prefill at head width 80 and ragged d = 80 cases in both types and
#: modes, then zamba2-7b's shared-block prefill at head width 112 (32
#: heads, no GQA) and ragged d = 112 cases
FLASH_CASES = [(1, PREFILL_LEN, 32, 8, 128, True, torch.bfloat16, True),
               (1, PREFILL_LEN, 32, 32, 128, True, torch.bfloat16, True),
               (1, 32768, 32, 32, 128, True, torch.bfloat16, True),
               (1, 1024, 32, 32, 128, True, torch.bfloat16, True),
               (1, 1500, 12, 12, 64, False, torch.bfloat16, True),
               (1, 512, 8, 8, 128, True, torch.float32, False),
               (1, PREFILL_LEN, 32, 32, 80, True, torch.bfloat16, True),
               (1, 1000, 32, 32, 80, True, torch.bfloat16, False),
               (1, 1500, 32, 8, 80, False, torch.bfloat16, False),
               (1, 700, 8, 8, 80, True, torch.float32, False),
               (1, 500, 8, 2, 80, False, torch.float32, False),
               (1, PREFILL_LEN, 32, 32, 112, True, torch.bfloat16, True),
               (1, 1000, 32, 8, 112, False, torch.bfloat16, False),
               (1, 512, 8, 8, 112, True, torch.float32, False)]
#: (m, n) and (m, r, n) off every tile and vector width, at RAGGED_BATCHES
RAGGED_MATVEC = [(1000, 700), (4100, 1030), (333, 130)]
RAGGED_LOWRANK = [(1000, 130, 700), (333, 72, 1030)]
RAGGED_INT8 = [(37, 13), (640, 2304), (1536, 32), (37, 2304), (1536, 13)]
#: gru_cell's hidden sizes off the unit tile (200) and off a 16-byte row
#: of U (333, 1030: scalar loads)
RAGGED_GRU = (200, 333, 1030)
RAGGED_BATCHES = (1, 4, 5, 16, 17)
#: rows x_q is zero-padded to for int8_gemm's torch._int_mm yardstick
#: (it refuses 16 rows or fewer)
INT_MM_ROWS = 32
#: the L2 is evicted before each cold timed call by reading this many bytes
L2_FLUSH_BYTES = 256 << 20
#: phase 6: full-width training, batch, steps and the stage transition
TRAIN_BATCH = 16
TRAIN_STEPS = 8
TRAIN_TRANSITION = 4
TRAIN_LAMBDA = 1e-4
#: one f32 smoke-width step on the card against the CPU from the same
#: weights and batch: the loss (relative), each gradient (relative, in
#: norm) — f32 sums in another order, cuDNN's conv algorithms — and each
#: leaf's update (relative, in norm): Adam's first step moves each weight
#: by about lr * sign(g), so a gradient within rounding of zero may move
#: its weight the other way on the other device
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_UPDATE_RTOL = 1e-2
#: zamba2-7b's smoke step: its updates differ by 1.7e-2 (measured on an
#: H100 80GB HBM3 at 700 W, gradients within 3.4e-4): a leaf of m entries
#: of which f move the other way differs by 2 sqrt(f / m), so 1.7e-2 is
#: ~7e-5 of a leaf's entries. The limit is the next power of two above
#: that reading; each run prints the share of entries whose update sign
#: differs (`update_sign_flips`) for every arch
ZAMBA_UPDATE_RTOL = 2.0 ** -5
#: phase 9: the transformer's training batch (data/lm.py) and, at full
#: qwen3-4b width, the depth it is cut to
LM_TRAIN_BATCH = 4
LM_TRAIN_SEQ = 256
LM_TRAIN_LAYERS = 2
#: phase 8: qwen3-4b's depth at full width (12 of its 36 layers: the
#: script's time limit), and stablelm-3b's for its full-width prefill
#: through the d = 80 flash kernel (every layer has the same shapes)
QWEN_LAYERS = 12
STABLELM_LAYERS = 4
#: phase 7: draft tokens an iteration and the draft's truncated-SVD rank
#: (at or above the 128-lane gate, so every draft GEMM reaches
#: lowrank_gemm)
SPEC_K = 3
DRAFT_RANK = 128
#: phase 7's depth: llama3-8b at full width cut to 4 layers (4 x 7 + 1 =
#: 29 draft SVDs; all 32 layers took 225, ~257 s of the script's time)
SPEC_LAYERS = 4
LM_GEMMS = ("attn_q", "attn_k", "attn_v", "attn_o", "ffn_gate", "ffn_up",
            "ffn_down")
#: phase 10: whisper-small's streams, frames (the reference's 30 s
#: window) and the kv block its encoder needs for them, decode steps,
#: calibration batches and the truncation rank (above the 128-lane gate,
#: so every factored encoder GEMM reaches lowrank_gemm)
WHISPER_BATCH = 4
WHISPER_FRAMES = 1500
WHISPER_BLOCK_KV = 500
WHISPER_STEPS = 32
WHISPER_PTQ_STEPS = 8
WHISPER_CALIB_BATCHES = 2
WHISPER_RANK = 256
#: memory agreement of an encode under the "cuda" and "plain" policies in
#: bf16 (flash rounds P to bf16 for the PV product; lowrank_gemm keeps
#: the rank intermediate in f32 where the plain path rounds it to bf16;
#: both travel through 12 layers)
WHISPER_ATOL = 0.25
#: the per-layer GEMMs of whisper's encoder and decoder, by leaf
WHISPER_ENC = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/w_in",
               "ffn/w_out")
WHISPER_DEC_STEP = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "xattn/wq",
                    "xattn/wo", "ffn/w_in", "ffn/w_out")
#: phase 11: DeepSeek. deepseek-v2-lite at full width in f32 cut to
#: DS_F32_LAYERS layers (1 dense + 3 MoE), DS_F32_PREFILL prompt tokens a
#: row and DS_F32_STEPS decode steps, where routes must be identical and
#: log-probs within DS_F32_ATOL (f32 sums in another order); trained at
#: full width cut to DS_TRAIN_LAYERS (1 dense + 1 MoE); deepseek-v3-671b
#: at full width cut to DS3_LAYERS (3 dense + 1 MoE). Its bf16 prefill,
#: serving and profiles run deepseek-v2-lite at full width cut to
#: DS_LAYERS (1 dense + 8 MoE of its 1 + 26: the script's time limit)
DS_ARCH = "deepseek-v2-lite"
DS3_ARCH = "deepseek-v3-671b"
DS_LAYERS = 9
DS_F32_LAYERS = 4
DS_F32_PREFILL = 512
DS_F32_STEPS = 8
DS_F32_ATOL = 1e-3
DS_TRAIN_LAYERS = 2
DS3_LAYERS = 4
DS3_PREFILL = 512
DS3_STEPS = 4
#: phase 12: zamba2-7b at full width (head width 112) cut to ZAMBA_LAYERS
#: (4 groups of 6 Mamba2 blocks behind the shared attention block, then 3
#: tail layers, the full model's 81 layers being 13 groups and a tail of
#: 3: the script's time limit), and to ZAMBA_CUT_LAYERS (one group of 6
#: and one tail layer, so `main`, `tail` and the shared block all run)
#: for the two-stage recipe and the self-speculative engine
ZAMBA_ARCH = "zamba2-7b"
ZAMBA_LAYERS = 27
ZAMBA_CUT_LAYERS = 7
#: the share of each weight that the rank-128 draft leaves out which the
#: speculative target keeps (`shrink_residuals`): small enough that the
#: draft's greedy tokens agree with the target's on a 32000-word
#: vocabulary about a third of the time, so that slots accept different
#: lengths and both the masked and the unmasked replay run (the run
#: prints the accept rate and each replay's commits)
ZAMBA_SPEC_RESIDUAL = 0.0025
#: log-prob agreement of the two policies where a model is compared in
#: f32 (`check_prefill` and `check_lm_serving` with a `compare` copy, the
#: speculative engine's window): zamba2-7b's, whose bf16 runs part too
#: far. `check_prefill(drift=)` measures why, at the prompt's last
#: position after each group; at all 81 layers, after each of the 13
#: groups (an H100 80GB HBM3 at 700 W): both precisions
#: carry a difference forward at about one rate (2.3x a group in bf16,
#: 2.1x in f32, over groups 1-4; f32 then 1.2-1.5x), but the bf16
#: policies start ~1400x further apart (0.059 relative after the first
#: group against 4.3e-5: the flash kernel rounds P to bf16, where the f32
#: runs differ by summation order), so bf16 reaches 0.73 by the 4th
#: group and saturates near 1.2 (decorrelated). The f32 prefill's
#: log-probs were 0.0175 apart, serving's 0.031; the limit is 2^-3.
#: Where the policies are compared on an f32 copy, the bf16 model's own
#: flash calls are held in place against their plain versions, and the
#: CPU tests hold each bf16 stage to the reference's own bf16 rounding
F32_LOGPROB_ATOL = 2.0 ** -3
#: the GEMMs of a zamba layer stack and shared block, by logical name
ZAMBA_GEMMS = ("mamba/ssm_in_zx", "mamba/ssm_in_bcdt", "mamba/ssm_out",
               "shared/attn_q", "shared/attn_k", "shared/attn_v",
               "shared/attn_o", "shared/ffn_gate", "shared/ffn_up",
               "shared/ffn_down")
#: phase 13: xlstm-350m at full width (24 layers: 12 (mLSTM, sLSTM)
#: pairs, d 1024, 4 heads), its prefill length, and the depth (2 pairs)
#: its speculative engine and its training run at. The sLSTM's recurrent
#: GEMM takes f32 activations over the weights' type, one head at a time:
#: (256, 1024) at full width, and rank-128 factors in the draft
XLSTM_ARCH = "xlstm-350m"
XLSTM_PREFILL_LEN = 1024
XLSTM_CUT_LAYERS = 4
XLSTM_REC = "pairs/slstm_rec"
XLSTM_REC_SHAPE = (256, DRAFT_RANK, 1024)
#: the GEMMs of an xlstm pair, by logical name (the recurrent one apart)
XLSTM_GEMMS = ("pairs/mlstm_up", "pairs/mlstm_qkv", "pairs/mlstm_ifg",
               "pairs/mlstm_down", "pairs/slstm_nonrec", "pairs/slstm_out")
#: as ZAMBA_SPEC_RESIDUAL, for the 4-layer xlstm target and its draft
XLSTM_SPEC_RESIDUAL = 0.0025
#: phase 13 compares the policies' log-probs on an f32 copy of the
#: weights (F32_LOGPROB_ATOL), as phase 12 does. The prefill prints both
#: precisions and the residual stream's drift after each pair: on an H100
#: 80GB HBM3 at 700 W the bf16 policies were 0.0019 apart after the first
#: pair and 0.045 after the 12th (the f32 ones 2.3e-7 and 2.3e-5), and
#: a 1024-token prefill's log-probs 0.92 apart with 117 argmax flips
#: (f32: 4.1e-4, none). The two differ only in the order the recurrent
#: GEMM sums in; one flipped bf16 rounding of the sLSTM's output then reaches
#: the next mLSTM, whose normaliser max(|q . n|, exp(-m)) divides by a
#: sum that cancels, and serving parted by 0.30 at its first call. The
#: CPU tests hold each bf16 block to the reference's own bf16 rounding.
#: XLSTM_PROFILE_LEN: the tokens of the prefill `profile_paths` profiles:
#: the sLSTM's per-token loop makes ~300 device kernels a token (a
#: 1024-token trace would run to hundreds of MB), and each token costs
#: the same
XLSTM_PROFILE_LEN = 64
#: the prefix cache (phase 13 (e)): the reference's default capacity, the
#: template most requests open with, the conversations that take a
#: second turn, and qwen3-4b's depth there. A cold xlstm-350m admission
#: steps its prompt one token at a time (~40-80 ms a step on the host)
PREFIX_CACHE_MB = 256.0
PREFIX_TEMPLATE = 16
PREFIX_TURNS_2 = 2
PREFIX_QWEN_LAYERS = 4
#: a route that differs between the "cuda" and "plain" runs in bf16 must,
#: where it first differs, be a near-tie: a logit gap ln(p_k / p_(k+1))
#: between the last chosen and the first unchosen expert below this. The
#: two policies' x at the router differ by bf16 rounding summed over the
#: layers below (decode_matvec sums in another order than cuBLAS), and a
#: route can part only where that moves the gap between two experts'
#: logits by more than the gap itself. `router_drift` measures the move
#: on the same routes (the kernel run replaying the plain run's); on an
#: H100 at 700 W it was at most 0.153 (full-depth deepseek-v2-lite
#: serving; 0.061 for the trained 2-layer model and the 4-layer
#: deepseek-v3, 8e-6 in f32). The bound is the next power of two above
#: that reading, 2^-2, and the run fails if its own drift reaches it
ROUTE_LOGIT_GAP = 2.0 ** -2
KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces)
    "gru_cell": ("src/repro_torch/kernels/csrc/gru_cell.cu",
                 "src/repro/kernels/gru_cell.py:36"),
    "decode_matvec": ("src/repro_torch/kernels/csrc/decode_matvec.cu",
                      "src/repro/kernels/decode_matvec.py:38"),
    "lowrank_gemm": ("src/repro_torch/kernels/csrc/lowrank_gemm.cu",
                     "src/repro/kernels/lowrank_gemm.py:44"),
    "int8_gemm": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                  "src/repro/kernels/int8_gemm.py:41"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:62"),
}


def fail(msg: str) -> None:
  raise RuntimeError(msg)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


_FLUSH = []


def flush_l2() -> None:
  """Evict the L2 (50 MB on an H100) by reading a larger buffer: what
  stays is clean lines of that buffer, so the next kernel's reads come
  from device memory and cause no write-backs."""
  if not _FLUSH:
    _FLUSH.append(torch.ones(L2_FLUSH_BYTES // 4, device="cuda"))
  torch.amax(_FLUSH[0])


def time_ms(fn, reps: int = 50, cold: bool = False) -> float:
  """Median device time of one call of `fn`, by CUDA events around each
  of `reps` calls. The calls are queued behind a device sleep, so the
  card runs them back to back instead of waiting on the host. cold:
  evict the L2 before each call (outside the events)."""
  fn()
  torch.cuda.synchronize()
  ev = [(torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
  torch.cuda._sleep(100_000_000)
  for start, end in ev:
    if cold:
      flush_l2()
    start.record()
    fn()
    end.record()
  torch.cuda.synchronize()
  return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes: int, ops: int, dtype) -> tuple[float, str]:
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(shape, gen, dtype, scale=1.0):
  return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version.
# ---------------------------------------------------------------------------

def case(kernel, label, b, dtype, fn, plain, lib=None, nbytes=0, ops=0,
         exact=False, path=None, weight=1, reps=50, cold=False,
         yardstick=None, stable=False, act=None):
  """One comparison. `path` names the main path whose per-step sums the
  case feeds ("ds2" frame step, "lm_decode" step, "lm_prefill" call);
  `weight` is its launches in one step; nbytes/ops give the bound; `reps`
  the timed calls of each version; `cold` also times the kernel, the
  library call and the yardstick with the L2 evicted before each call;
  `yardstick` is (name, fn): a PyTorch call timed beside the kernel that
  does not compute the same function, reported as `<name>_ms`
  (int8_gemm's `torch._int_mm` at 32 rows, no dequant: "int_mm_padded";
  gru_cell's `torch.matmul(h, U)`, the product without the gates:
  "matmul_h_u"); `stable`: a second call must give the same bits; `act`:
  the activations' type where it is not `dtype` (the weights'): f32
  activations over bf16 weights are held to the f32 tolerance, and their
  operations bounded at f32's peak (the FMAs are f32)."""
  return dict(kernel=kernel, label=label, batch=b, dtype=dtype, fn=fn,
              plain=plain, lib=lib, nbytes=nbytes, ops=ops, exact=exact,
              path=path, weight=weight, reps=reps, cold=cold,
              yardstick=yardstick, stable=stable, act=act or dtype)


_BUSY: list = []


def beside_busy_stream(fn):
  """fn() on the current stream while a second stream runs eight f32
  4096 x 4096 products (tens of ms on every SM) that it does not wait
  for."""
  if not _BUSY:
    _BUSY.append((torch.cuda.Stream(), torch.ones(4096, 4096, device="cuda")))
  side, a = _BUSY[0]
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(8):
      a @ a
  return fn()


def chunked_attention(q, k, v, rows: int = 2048):
  """`ref.flash_attention` (causal) by query-row chunks: row block
  [r0, r1) against keys [0, r1), each block's f32 scores whole. At
  s = 32768 the unchunked score matrix would take 137 GB. k and v have
  as many heads as q."""
  s, d = q.shape[1], q.shape[-1]
  out = torch.empty_like(q)
  pos = torch.arange(s, device=q.device)
  for r0 in range(0, s, rows):
    r1 = min(s, r0 + rows)
    sc = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].float(),
                      k[:, :r1].float()) / (d ** 0.5)
    sc = sc.masked_fill(pos[None, :r1] > pos[r0:r1, None], float("-inf"))
    out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                                 v[:, :r1].float()).to(q.dtype)
  return out


def kernel_cases(dense, fact, quant, lm, gen):
  """Every full-width shape of the paths, for each kernel."""
  from repro_torch import configs
  from repro_torch.core.factored import iter_factored_leaves, iter_gemm_leaves
  from repro_torch.kernels import ref
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.flash_attention import flash_attention
  from repro_torch.kernels.gru_cell import _launch as gru_launch
  from repro_torch.kernels.gru_cell import gru_cell
  from repro_torch.kernels.gru_cell import plan as gru_plan
  from repro_torch.kernels.int8_gemm import int8_gemm
  from repro_torch.kernels.lowrank_gemm import _launch as lowrank_launch
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm, lowrank_plan

  bf16 = torch.bfloat16
  leaves = {leaf.name: leaf for leaf in iter_factored_leaves(dense)}
  cases = []
  for b in BATCHES:
    path = "ds2" if b == SERVE_BATCH else None
    for name, leaf in leaves.items():
      if name.endswith("/rec") or name == "out":
        continue                       # rec -> gru_cell; out -> plain
      w = leaf.w
      m, n = w.shape
      x = randn((b, m), gen, bf16)
      cases.append(case("decode_matvec", f"{name} {m}x{n}", b, bf16,
                        lambda x=x, w=w: decode_matvec(x, w),
                        lambda x=x, w=w: ref.decode_matvec(x, w),
                        lambda x=x, w=w: torch.matmul(x, w),
                        2 * (b * m + m * n + b * n), 2 * b * m * n,
                        path=path))
    for i in range(3):
      u = dense.grus[f"gru{i}"].rec.w
      hid = u.shape[0]
      xw = randn((b, 3 * hid), gen, bf16)
      h = randn((b, hid), gen, bf16, 0.5)
      bias = randn((3 * hid,), gen, torch.float32, 0.1)
      # no PyTorch call computes the gates; the yardstick is the
      # recurrent product alone
      cases.append(case("gru_cell", f"gru{i}/rec {hid}x{3 * hid}", b, bf16,
                        lambda a=(xw, h, u, bias): gru_cell(*a),
                        lambda a=(xw, h, u, bias): ref.gru_cell(*a), None,
                        2 * (b * 3 * hid + 2 * b * hid + 3 * hid * hid)
                        + 4 * 3 * hid, 6 * b * hid * hid, path=path,
                        cold=b == SERVE_BATCH, stable=True,
                        yardstick=("matmul_h_u",
                                   lambda h=h, u=u: torch.matmul(h, u))))
    for leaf in iter_factored_leaves(fact):
      if not leaf.is_factored:
        continue
      u, v = leaf.u, leaf.v
      (m, r), n = u.shape, v.shape[1]
      x = randn((b, m), gen, bf16)
      cases.append(case("lowrank_gemm", f"{leaf.name} {m}x{r}x{n}", b, bf16,
                        lambda a=(x, u, v): lowrank_gemm(*a),
                        lambda a=(x, u, v): ref.lowrank_gemm(*a),
                        lambda x=x, u=u, v=v: torch.matmul(torch.matmul(x, u),
                                                           v),
                        2 * (b * m + m * r + r * n + b * n),
                        2 * b * r * (m + n), path=path))
    for leaf in iter_gemm_leaves(quant):
      wq, ws = leaf.w_q, leaf.w_scale
      m, n = wq.shape
      xq, xs = ref.quantize_rowwise(randn((b, m), gen, bf16))
      # torch._int_mm refuses batch <= 16: its yardstick pads x_q to 32
      # zero rows (outside the timed call) and leaves out the dequant
      xq32 = torch.zeros((INT_MM_ROWS, m), dtype=torch.int8, device="cuda")
      xq32[:b] = xq
      cases.append(case("int8_gemm", f"{leaf.name} {m}x{n}", b, torch.int8,
                        lambda a=(xq, wq, xs, ws): int8_gemm(*a),
                        lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a), None,
                        b * m + m * n + 4 * (b + n + b * n), 2 * b * m * n,
                        exact=True, path=path,
                        yardstick=("int_mm_padded",
                                   lambda a=xq32, w=wq: torch._int_mm(a, w))))
  cases += decode_cases(step_leaves(lm, configs.get_config(LM_ARCH)), gen,
                        "lm_decode")
  n_layers = lm.dense_layers.ln1.shape[0]
  # ragged shapes (not timed): every lane width, tile edge and batch tile
  for dtype in (bf16, torch.float32):
    for b in RAGGED_BATCHES:
      for m, n in RAGGED_MATVEC:
        x, w = randn((b, m), gen, dtype), randn((m, n), gen, dtype, 0.05)
        cases.append(case("decode_matvec", f"ragged {m}x{n}", b, dtype,
                          lambda x=x, w=w: decode_matvec(x, w),
                          lambda x=x, w=w: ref.decode_matvec(x, w)))
      for m, r, n in RAGGED_LOWRANK:
        x = randn((b, m), gen, dtype)
        u, v = randn((m, r), gen, dtype, 0.05), randn((r, n), gen, dtype, 0.1)
        cases.append(case("lowrank_gemm", f"ragged {m}x{r}x{n}", b, dtype,
                          lambda a=(x, u, v): lowrank_gemm(*a),
                          lambda a=(x, u, v): ref.lowrank_gemm(*a)))
        # several waves of blocks (k ranges of 8 rows), alone and while a
        # long product holds SMs on a second stream: the ticket order
        # keeps the fused launch from deadlocking
        p = dataclasses.replace(
            lowrank_plan(b, m, r, n, w_bytes=x.element_size()),
            split1=math.ceil(m / 8), kper1=8, split2=math.ceil(r / 8),
            kper2=8)
        cases.append(case("lowrank_gemm", f"oversubscribed {m}x{r}x{n}", b,
                          dtype, lambda a=(x, u, v), p=p: lowrank_launch(*a,
                                                                        p),
                          lambda a=(x, u, v): ref.lowrank_gemm(*a)))
        cases.append(case("lowrank_gemm", f"beside a busy stream {m}x{r}x{n}",
                          b, dtype,
                          lambda a=(x, u, v), p=p: beside_busy_stream(
                              lambda: lowrank_launch(*a, p)),
                          lambda a=(x, u, v): ref.lowrank_gemm(*a)))
      for hid in RAGGED_GRU:
        g = (randn((b, 3 * hid), gen, dtype), randn((b, hid), gen, dtype, 0.5),
             randn((hid, 3 * hid), gen, dtype, 0.05),
             randn((3 * hid,), gen, torch.float32, 0.1))
        cases.append(case("gru_cell", f"ragged H={hid}", b, dtype,
                          lambda g=g: gru_cell(*g),
                          lambda g=g: ref.gru_cell(*g), stable=True))
        # k ranges of 8 rows (several waves of blocks at the larger H
        # and batches), alone and beside a long product on a second
        # stream: no block waits on another
        p = dataclasses.replace(gru_plan(b, hid, w_bytes=g[1].element_size()),
                                lanes=8, split=math.ceil(hid / 8),
                                k_per_split=8)
        cases.append(case("gru_cell", f"k ranges of 8 rows H={hid}", b,
                          dtype, lambda g=g, p=p: gru_launch(*g, p),
                          lambda g=g: ref.gru_cell(*g), stable=True))
        cases.append(case("gru_cell", f"beside a busy stream H={hid}", b,
                          dtype, lambda g=g, p=p: beside_busy_stream(
                              lambda: gru_launch(*g, p)),
                          lambda g=g: ref.gru_cell(*g), stable=True))
    # int8_gemm at ragged shapes: m off every quad, n off every lane's
    # columns, rows of w_q off a 16-byte boundary (a view one byte in)
    for b in RAGGED_BATCHES:
      for m, n in RAGGED_INT8:
        xq, xs = ref.quantize_rowwise(randn((b, m), gen, torch.float32))
        wq, ws = ref.quantize_colwise(randn((m, n), gen, torch.float32))
        flat = torch.zeros(m * n + 1, dtype=torch.int8, device="cuda")
        flat[1:] = wq.flatten()
        for label, w in (("ragged", wq), ("unaligned", flat[1:].view(m, n))):
          cases.append(case("int8_gemm", f"{label} {m}x{n}", b, torch.int8,
                            lambda a=(xq, w, xs, ws): int8_gemm(*a),
                            lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a),
                            exact=True))
  for b, s, h, h_kv, d, causal, dtype, timed in FLASH_CASES:
    q = randn((b, s, h, d), gen, dtype)
    k, v = (randn((b, s, h_kv, d), gen, dtype) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = s * (s + 1) // 2 if causal else s * s
    size = torch.finfo(dtype).bits // 8
    long = s > PREFILL_LEN
    heads = f"{h}" if h == h_kv else f"{h}/{h_kv}"
    cases.append(case(
        "flash_attention",
        f"{'causal' if causal else 'non-causal'} ({b}, {s}, {heads}, {d})",
        b, dtype, lambda a=(q, k, v), c=causal: flash_attention(*a, causal=c),
        (lambda a=(q, k, v): chunked_attention(*a)) if long else
        (lambda a=(q, k, v), c=causal: ref.flash_attention(*a, causal=c)),
        lambda a=(qt, kt, vt), c=causal, g=h != h_kv:
        F.scaled_dot_product_attention(*a, is_causal=c, enable_gqa=g),
        2 * b * s * (h + h_kv) * d * size if timed else 0,
        4 * b * h * d * pairs,
        path=("lm_prefill" if s == PREFILL_LEN and h_kv < h else
              "stablelm_prefill" if s == PREFILL_LEN and d == 80 else
              "zamba_prefill" if s == PREFILL_LEN and d == 112 else None),
        weight=n_layers, reps=5 if long else 20))
  # f32 once per GEMM kernel: the kernels take f32 as well as bf16
  f32 = torch.float32
  x, w = randn((4, 640), gen, f32), randn((640, 2304), gen, f32, 0.04)
  u, v = randn((640, 256), gen, f32, 0.06), randn((256, 2304), gen, f32, 0.06)
  g = (randn((4, 2304), gen, f32), randn((4, 768), gen, f32, 0.5),
       randn((768, 2304), gen, f32, 0.04), randn((2304,), gen, f32, 0.1))
  cases += [
      case("decode_matvec", "f32 640x2304", 4, f32, lambda: decode_matvec(x, w),
           lambda: ref.decode_matvec(x, w)),
      case("lowrank_gemm", "f32 640x256x2304", 4, f32,
           lambda: lowrank_gemm(x, u, v), lambda: ref.lowrank_gemm(x, u, v)),
      case("gru_cell", "f32 768x2304", 4, f32, lambda: gru_cell(*g),
           lambda: ref.gru_cell(*g), stable=True),
  ]
  # f32 activations over bf16 weights: the sLSTM's recurrent GEMM, one
  # xlstm-350m head (4, 256) x (256, 1024) and its rank-128 factors, held
  # at the f32 tolerance and timed
  b, (m, r, n) = SERVE_BATCH, XLSTM_REC_SHAPE
  xr = randn((b, m), gen, f32)
  wr = randn((m, n), gen, bf16, 0.06)
  ur, vr = randn((m, r), gen, bf16, 0.08), randn((r, n), gen, bf16, 0.08)
  cases += [
      case("decode_matvec", f"f32 x over bf16 {m}x{n}", b, bf16,
           lambda: decode_matvec(xr, wr), lambda: ref.decode_matvec(xr, wr),
           matmul_lib(xr, wr), 4 * (b * m + b * n) + 2 * m * n,
           2 * b * m * n, path="xlstm_rec", cold=True, act=f32),
      case("lowrank_gemm", f"f32 x over bf16 {m}x{r}x{n}", b, bf16,
           lambda: lowrank_gemm(xr, ur, vr),
           lambda: ref.lowrank_gemm(xr, ur, vr), matmul_lib(xr, ur, vr),
           4 * (b * m + b * n) + 2 * r * (m + n), 2 * b * r * (m + n),
           path="xlstm_rec", cold=True, act=f32),
  ]
  return cases


_MLA_NAMES = {"wq": "layers/mla_q", "wq_a": "layers/mla_q_a",
              "wq_b": "layers/mla_q_b", "w_dkv": "layers/mla_dkv",
              "wo": "layers/mla_o"}


def step_leaves(lm, cfg) -> list[tuple]:
  """(logical name, layer 0's leaf, launches a decode step) of every
  GEMM a decode step routes through `gemm`: a dense LM's q, k, v and o
  projections, or MLA's q (or q-LoRA's two), dkv and o, in every layer;
  the dense layers' SwiGLU; the MoE layers' shared SwiGLU; and the head.
  (MLA's w_uk and w_uv enter the absorbed attention as products and the
  routed experts as stacked einsums: neither reaches a GEMM regime.)
  A zamba model's are `zamba_step_leaves`, an xlstm model's
  `xlstm_step_leaves`."""
  from repro_torch.models.transformer import depths
  if cfg.family == "zamba":
    return zamba_step_leaves(lm, cfg)
  if cfg.family == "xlstm":
    return xlstm_step_leaves(lm, cfg)
  n_dense, n_moe = depths(cfg)
  lp = lm.dense_layers.layers()[0]
  if cfg.mla is None:
    out = [(f"layers/attn_{k[1:]}", lp["attn"][k], cfg.num_layers)
           for k in ("wq", "wk", "wv", "wo")]
  else:
    keys = (("wq_a", "wq_b") if cfg.mla.q_lora_rank else ("wq",)) + \
        ("w_dkv", "wo")
    out = [(_MLA_NAMES[k], lp["attn"][k], cfg.num_layers) for k in keys]
  out += [(f"layers/ffn_{g}", lp["ffn"][f"w_{g}"], n_dense)
          for g in ("gate", "up", "down")]
  if n_moe and cfg.moe.num_shared:
    shared = lm.moe_layers.layers()[0]["moe"]["shared"]
    out += [(f"layers/shared/ffn_{g}", shared[f"w_{g}"], n_moe)
            for g in ("gate", "up", "down")]
  out.append(("lm_head", lm.embedding.head, 1))
  return out


def act_dtype(name: str, w: torch.Tensor) -> torch.dtype:
  """The activations' type at GEMM `name`: the weight's, but f32 at the
  sLSTM's recurrent GEMM (an f32 hidden state over the weight's type)."""
  return torch.float32 if name == XLSTM_REC else w.dtype


def matmul_lib(x: torch.Tensor, *ws: torch.Tensor):
  """The library call of x @ w1 @ ...: `torch.matmul`, on f32 copies of
  the weights (made here, outside the timed call) where x is f32 and the
  weights bf16, which no one PyTorch call multiplies."""
  ws = tuple(w.float() if x.dtype != w.dtype else w for w in ws)

  def fn():
    y = x
    for w in ws:
      y = torch.matmul(y, w)
    return y
  return fn


def plain_gemms(cfg) -> set:
  """Logical names of the GEMMs of a decode step that stay plain under
  the kernel policy (below the 128-lane gate): xlstm's (2 di, 2 heads)
  mLSTM gate projection."""
  return {"pairs/mlstm_ifg"} if cfg.family == "xlstm" else set()


def decode_cases(leaves, gen, path: str, prefix: str = "") -> list[dict]:
  """decode_matvec at each (name, 2-D leaf, launches a step) of `leaves`,
  at the engine's batch, warm and cold; `weight` is each shape's
  launches a step. x is f32 at the sLSTM's recurrent GEMM (`act_dtype`),
  the weight's type elsewhere."""
  from repro_torch.kernels import ref
  from repro_torch.kernels.decode_matvec import decode_matvec
  b = SERVE_BATCH
  cases = []
  for name, leaf, weight in leaves:
    w = leaf.w
    m, n = w.shape
    xd = act_dtype(name, w)
    x = randn((b, m), gen, xd)
    xs, ws = x.element_size(), w.element_size()
    cases.append(case("decode_matvec", f"{prefix}{name} {m}x{n}", b, w.dtype,
                      lambda x=x, w=w: decode_matvec(x, w),
                      lambda x=x, w=w: ref.decode_matvec(x, w),
                      matmul_lib(x, w),
                      xs * (b * m + b * n) + ws * m * n, 2 * b * m * n,
                      path=path, weight=weight, cold=True, act=xd))
  return cases


def check_kernels(dense, fact, quant, lm) -> list[dict]:
  gen = torch.Generator().manual_seed(1)
  return check_cases(kernel_cases(dense, fact, quant, lm, gen))


def check_cases(cases: list[dict]) -> list[dict]:
  """Each case's kernel against its plain version (and timed where the
  case gives its bytes); one JSON line and one row a case."""
  rows = []
  for c in cases:
    kernel, label, b, dtype = c["kernel"], c["label"], c["batch"], c["dtype"]
    got, want = c["fn"](), c["plain"]()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
      fail(f"{kernel} {label} b={b}: {got.shape}/{got.dtype} vs "
           f"{want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    row = dict(kernel=kernel, shape=label, batch=b, dtype=str(dtype),
               max_abs_err=max_err, path=c["path"], weight=c["weight"])
    if c["act"] != dtype:
      row["act_dtype"] = str(c["act"])
    if c["stable"]:
      again = c["fn"]()
      if not torch.equal(got, again):
        fail(f"{kernel} {label} b={b} {dtype}: two calls differ")
      del again
    if c["exact"]:
      ok = torch.equal(got, want)
    else:
      tol = TOL[c["act"]]
      ok = bool(torch.isfinite(got.float()).all()) and \
          bool((err <= tol + tol * want.float().abs()).all())
    if kernel == "flash_attention":   # (b, s, h, d): rows of d values
      ratio = float((err.amax(-1) / want.float().abs().amax(-1)).max())
      row["max_row_err_ratio"] = ratio
      if ratio > FLASH_ROW_RTOL[dtype]:
        fail(f"{kernel} {label} {dtype}: a row's max |err| is {ratio:.3g} "
             f"of its max |value| (limit {FLASH_ROW_RTOL[dtype]:.3g})")
    del got, want, err
    if not ok:
      fail(f"{kernel} {label} b={b} {dtype}: disagrees with its plain "
           f"version (max |err| {max_err:.3g})")
    if c["nbytes"]:                     # the paths' shapes: timed
      reps = c["reps"]
      bnd, by = bound_ms(c["nbytes"], c["ops"], c["act"])
      row.update(kernel_ms=time_ms(c["fn"], reps),
                 plain_ms=time_ms(c["plain"], reps),
                 library_ms=(time_ms(c["lib"], reps) if c["lib"] is not None
                             else None),
                 bound_ms=bnd, bound_by=by)
      if c["cold"]:
        row["kernel_cold_ms"] = time_ms(c["fn"], reps, cold=True)
        if c["lib"] is not None:
          row["library_cold_ms"] = time_ms(c["lib"], reps, cold=True)
      if c["yardstick"] is not None:
        name, fn = c["yardstick"]
        row["yardstick"] = name
        row[f"{name}_ms"] = time_ms(fn, reps)
        if c["cold"]:
          row[f"{name}_cold_ms"] = time_ms(fn, reps, cold=True)
    print(json.dumps(row), flush=True)
    rows.append(row)
  return rows


def check_one_lowrank_launch(fact) -> dict:
  """One lowrank_gemm call at the largest factored DS2 leaf, batch 4,
  bf16, traced with torch.profiler: the fused kernel must be the call's
  only device activity (kernel, memset or memcpy)."""
  from torch.profiler import ProfilerActivity, profile

  from repro_torch.core.factored import iter_factored_leaves
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  leaf = max((lf for lf in iter_factored_leaves(fact) if lf.is_factored),
             key=lambda lf: lf.u.numel() + lf.v.numel())
  gen = torch.Generator().manual_seed(2)
  x = randn((SERVE_BATCH, leaf.u.shape[0]), gen, torch.bfloat16)
  lowrank_gemm(x, leaf.u, leaf.v)     # its counters exist before the trace
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    lowrank_gemm(x, leaf.u, leaf.v)
    torch.cuda.synchronize()
  trace = ROOT / "build" / "lowrank_gemm_trace.json"
  trace.parent.mkdir(parents=True, exist_ok=True)
  prof.export_chrome_trace(str(trace))
  device = [(e.get("cat"), e.get("name")) for e in
            json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
  if len(device) != 1 or device[0][0] != "kernel" or \
      "lowrank" not in device[0][1]:
    fail(f"lowrank_gemm {leaf.name}: {len(device)} device activities in one "
         f"call, not one fused kernel: {device}")
  out = dict(lowrank_gemm_one_call=leaf.name,
             shape=[SERVE_BATCH, *leaf.u.shape, leaf.v.shape[1]],
             device_activities=len(device), kernel=device[0][1])
  print(json.dumps(out), flush=True)
  return out


# ---------------------------------------------------------------------------
# Phase 3: the main path — the streaming server at full width.
# ---------------------------------------------------------------------------

EXPECTED_ROUTES = {
    "dense": lambda name: ("gru_cell" if name.endswith("/rec") else
                           "jnp" if name == "out" else "decode_matvec"),
    "factored": lambda name: "jnp" if name == "out" else "lowrank_gemm",
    "int8": lambda name: "int8_gemm",
}


def utterances(cfg) -> list[np.ndarray]:
  """8 utterances of 17..64 frames, drawn as `launch.serve` draws them."""
  from repro_torch.data.speech import SpeechDataConfig, batch_at
  dc = SpeechDataConfig(vocab_size=cfg.vocab_size, feat_dim=cfg.feat_dim,
                        global_batch=SERVE_BATCH)
  rng = np.random.RandomState(0)
  out = []
  for i in range(2 * SERVE_BATCH):
    row = batch_at(dc, i)["feats"][i % SERVE_BATCH]
    out.append(row[:int(rng.randint(17, min(64, row.shape[0]) + 1))])
  return out


def serve(cfg, params, utts, policy: str):
  """One fleet run; returns (results, per-step (mask, log-probs), seconds,
  launches, routing log)."""
  from repro_torch.kernels import dispatch, ops
  from repro_torch.serving.engine import StreamingSpeechServer
  srv = StreamingSpeechServer(cfg, params, batch_size=SERVE_BATCH,
                              kernel_policy=policy)
  srv.submit(utts[0][:24])              # warm-up: cuDNN, allocator, build
  srv.run(chunk_frames=16)
  steps = []
  step = srv._frame_step

  def recording_step(x, active):
    lp = step(x, active)
    steps.append((active, lp))
    return lp
  srv._frame_step = recording_step
  for u in utts:
    srv.submit(u)
  torch.cuda.synchronize()
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    t0 = time.perf_counter()
    results = srv.run(chunk_frames=16)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
  launches = dict(ops.LAUNCHES)
  return results, steps, dt, launches, set(log)


def check_serving(cfg, forms: dict, card: str, routes=None) -> dict:
  """Serve each form under both policies. `routes` maps a form to its
  expected route for a GEMM name (default: `EXPECTED_ROUTES`); the
  kernels it names must launch, and no other."""
  routes = routes or EXPECTED_ROUTES
  utts = utterances(cfg)
  frames = sum(len(u) for u in utts)
  total = {k: 0 for k in KERNELS}
  for form, params in forms.items():
    res_k, steps_k, dt_k, launches, log = serve(cfg, params, utts, "cuda")
    res_p, steps_p, dt_p, plain_launches, _ = serve(cfg, params, utts,
                                                    "plain")
    # routing and launches
    names = {name for name, _ in log}
    want_routes = {(n, routes[form](n)) for n in names}
    if log != want_routes or len(names) != 8:
      fail(f"{form}: routing {sorted(log)} != {sorted(want_routes)}")
    kernels = {r for _, r in want_routes} - {"jnp"}
    for k, n in launches.items():
      if (n > 0) != (k in kernels):
        fail(f"{form}: kernel {k} launched {n} times on the main path")
      total[k] += n
    if any(plain_launches.values()):
      fail(f"{form}: the plain policy launched {plain_launches}")
    # outputs
    if len(res_k) != len(utts) or len(steps_k) != len(steps_p):
      fail(f"{form}: {len(res_k)} results, {len(steps_k)} vs "
           f"{len(steps_p)} steps")
    max_diff = 0.0
    for (mk, lk), (mp, lp) in zip(steps_k, steps_p):
      if not torch.equal(mk, mp) or lk.shape != (SERVE_BATCH, cfg.vocab_size):
        fail(f"{form}: step masks or shapes differ")
      a, b = lk[mk], lp[mp]
      if not bool(torch.isfinite(a).all()):
        fail(f"{form}: non-finite log-probs")
      max_diff = max(max_diff, float((a - b).abs().max()))
    atol = 0.0 if form == "int8" else SERVE_ATOL
    if max_diff > atol:
      fail(f"{form}: per-frame log-probs differ by {max_diff:.3g} > {atol}")
    lab_k = {r.uid: r.labels for r in res_k}
    lab_p = {r.uid: r.labels for r in res_p}
    same = sum(lab_k[u] == lab_p[u] for u in lab_k)
    if form == "int8" and same != len(lab_k):
      fail(f"int8: labels differ between policies ({same}/{len(lab_k)})")
    print(json.dumps(dict(
        serve=form, card=card, utterances=len(utts), frames=frames,
        decode_steps=len(steps_k), launches=launches,
        cuda_streams_per_s=len(utts) / dt_k, cuda_frames_per_s=frames / dt_k,
        plain_streams_per_s=len(utts) / dt_p,
        plain_frames_per_s=frames / dt_p,
        max_logprob_diff=max_diff, labels_equal=f"{same}/{len(lab_k)}")),
        flush=True)
  return total


def build_forms(cfg):
  from repro_torch.core.compress import FactorizationPlan
  from repro_torch.core.factored import factored, map_factored_leaves
  from repro_torch.models.deepspeech import init_model
  from repro_torch.quant import quantize_params
  gen = torch.Generator().manual_seed(0)
  dense = init_model(cfg, generator=gen, device="cuda")
  plan = FactorizationPlan()

  def to_rank_256(leaf):
    if not plan.matches(leaf):
      return leaf
    return factored(leaf.in_dim, leaf.out_dim, 256, name=leaf.name,
                    group=leaf.group, dtype=cfg.dtype, generator=gen,
                    device="cuda")
  return {"dense": dense, "factored": map_factored_leaves(to_rank_256, dense),
          "int8": quantize_params(dense)}


# ---------------------------------------------------------------------------
# Phase 4: the prefill — full-width llama3-8b through the flash kernel.
# ---------------------------------------------------------------------------

def build_lm(cfg):
  from repro_torch.models.transformer import init_lm
  gen = torch.Generator(device="cuda").manual_seed(0)
  return init_lm(cfg, generator=gen, device="cuda")


def attention_layers(cfg) -> int:
  """The attention calls of a forward: one a layer, or for zamba one a
  group (the shared block)."""
  if cfg.family == "zamba":
    from repro_torch.models.zamba import _plan
    return _plan(cfg)[1]
  return cfg.num_layers


def hold_flash_in_place(lm, cfg, toks) -> float:
  """One "cuda" prefill of `lm` in which each flash call is held against
  `ref.flash_attention` on that call's own q, k, v, row by row
  (FLASH_ROW_RTOL). Returns the largest row ratio."""
  from repro_torch.kernels import dispatch, ref
  from repro_torch.models.api import get_model
  ratios = []
  maybe = dispatch.maybe_flash_attention

  def held(q, k, v, policy, name, *, causal=True):
    out = maybe(q, k, v, policy, name, causal=causal)
    rep = q.shape[2] // k.shape[2]
    want = ref.flash_attention(q, torch.repeat_interleave(k, rep, 2),
                               torch.repeat_interleave(v, rep, 2),
                               causal=causal).float()
    err = (out.float() - want).abs()
    ratios.append(float((err.amax(-1) / want.abs().amax(-1)).max()))
    return out
  dispatch.maybe_flash_attention = held
  try:
    get_model(cfg).forward(lm, toks, cfg, last_only=True,
                           policy=dispatch.resolve_policy("cuda"))
  finally:
    dispatch.maybe_flash_attention = maybe
  if len(ratios) != attention_layers(cfg) or \
      max(ratios) > FLASH_ROW_RTOL[cfg.dtype]:
    fail(f"{cfg.name} prefill: flash calls against their plain versions, "
         f"row ratios {ratios}")
  return max(ratios)


def check_prefill(lm, cfg, card, gemms=None, flash: bool = True,
                  compare=None, tokens: int = PREFILL_LEN,
                  recurrent=None, drift=None) -> dict:
  """forward on one `tokens`-token prompt under both policies; returns
  the kernel run's launches. `gemms`: the logical names of the layer
  GEMMs (default: the dense LM's), which stay plain at `tokens` rows;
  `flash`: whether the attention launches flash_attention (one call an
  attention layer), which MLA does not. `recurrent`: (logical name,
  calls a token) of a GEMM that a recurrence runs at one row a token
  (xlstm's sLSTM heads), which routes to decode_matvec; the log-probs
  of every position are then compared (teacher forcing), the head has
  `tokens` rows and stays plain, and the warm-up runs the first 16
  tokens (each further one repeats their launches). With neither a
  kernel below the head, the log-probs are held to the head's rounding
  (HEAD_ONLY_RTOL), else to PREFILL_ATOL (F32_LOGPROB_ATOL in f32).
  `compare`: (model,
  cfg), a copy of the same weights on which the policies' log-probs are
  compared (default: `lm` itself); `lm`'s runs are then held to their
  launches, routing and finite log-probs, their log-prob difference is
  printed, and each of its flash calls is held to its plain version in
  place (`hold_flash_in_place`). `drift`: (module, function name) of a
  block of the forward whose output's last position is kept at each
  call of the timed runs; how far the two policies' residual streams
  part after each block, ||x_cuda - x_plain|| / ||x_plain||, is printed
  for each precision run (what F32_LOGPROB_ATOL's comment rests on)."""
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models.api import get_model
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(1, tokens))).to("cuda")
  last_only = recurrent is None
  if gemms is None:
    gemms = {f"layers/{g}" for g in LM_GEMMS}
  want_routes = {(n, "jnp") for n in gemms} | {
      ("lm_head", "decode_matvec" if last_only else "jnp")}
  if flash:
    want_routes.add(("layers/attn", "flash_attention"))
  if not last_only:
    want_routes.add((recurrent[0], "decode_matvec"))
  kept = []

  def run(model, c, policy):
    forward = get_model(c).forward
    pol = dispatch.resolve_policy(policy)
    forward(model, toks if last_only else toks[:, :16], c,
            last_only=last_only, policy=pol)       # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    kept.clear()
    with dispatch.record_dispatch() as log, \
        patched(drift, keeping_last(kept)):
      t0 = time.perf_counter()
      logits = forward(model, toks, c, last_only=last_only, policy=pol)
      torch.cuda.synchronize()
      dt = time.perf_counter() - t0
    lg = logits[0].float()
    launches = dict(ops.LAUNCHES)
    # the layer GEMMs (flat batch `tokens`) stay plain; the head, narrowed
    # to the last position, is a batch-1 GEMM
    want = {k: 0 for k in launches}
    if policy == "cuda":
      want.update(flash_attention=attention_layers(c) if flash else 0,
                  decode_matvec=1 if last_only else tokens * recurrent[1])
      if set(log) != want_routes:
        fail(f"{c.name} prefill: routing {sorted(set(log))}")
    if launches != want:
      fail(f"{c.name} prefill ({policy}, {c.dtype}): launches {launches} "
           f"!= {want}")
    if lg.shape != (1 if last_only else tokens, c.vocab_size) or \
        not bool(torch.isfinite(lg).all()):
      fail(f"{c.name} prefill: logits of the wrong shape or not finite")
    return dict(lp=torch.log_softmax(lg, dim=-1), s=dt, launches=launches,
                top=float(lg.abs().max()), kept=list(kept))
  k, p = own = [run(lm, cfg, pol) for pol in ("cuda", "plain")]
  cm, cc = compare or (lm, cfg)
  runs = {str(cfg.dtype): own}
  if compare is not None:
    runs[str(cc.dtype)] = [run(cm, cc, pol) for pol in ("cuda", "plain")]
  gk, gp = runs[str(cc.dtype)]
  if not (flash or recurrent):
    atol = HEAD_ONLY_RTOL * max(gk["top"], gp["top"])
  else:
    atol = F32_LOGPROB_ATOL if cc.dtype == torch.float32 else PREFILL_ATOL
  diff = float((gk["lp"] - gp["lp"]).abs().max())
  flip = gk["lp"].argmax(-1) != gp["lp"].argmax(-1)
  top2 = torch.topk(gp["lp"], 2, dim=-1).values
  gaps = top2[:, 0] - top2[:, 1]
  flip_gap = float(gaps[flip].max()) if bool(flip.any()) else 0.0
  if diff > atol:
    fail(f"{cfg.name} prefill: log-probs differ by {diff:.3g} > {atol:.3g}")
  if flip_gap >= atol:
    fail(f"{cfg.name} prefill: greedy tokens differ at a top-2 gap of "
         f"{flip_gap:.3g}")
  extra = {}
  if compare is not None:
    extra.update(compared_dtype=str(cc.dtype), own_max_logprob_diff=float(
        (k["lp"] - p["lp"]).abs().max()))
    if flash:
      extra["flash_max_row_err_ratio"] = hold_flash_in_place(lm, cfg, toks)
  if drift is not None:
    extra["drift_by_block"] = {
        d: [float((a - b).norm() / b.norm()) for a, b in zip(
            rk["kept"], rp["kept"])] for d, (rk, rp) in runs.items()}
  print(json.dumps(dict(
      prefill=cfg.name, card=card, dtype=str(cfg.dtype),
      layers=cfg.num_layers, head_dim=cfg.resolved_head_dim,
      tokens=tokens, launches=k["launches"], cuda_prefill_s=k["s"],
      cuda_prefill_tokens_per_s=tokens / k["s"], plain_prefill_s=p["s"],
      plain_prefill_tokens_per_s=tokens / p["s"], max_logprob_diff=diff,
      atol=atol, argmax_flips=int(flip.sum()), flip_max_top2_gap=flip_gap,
      plain_top2_gap=float(gaps[-1]), greedy_cuda=int(gk["lp"][-1].argmax()),
      greedy_plain=int(gp["lp"][-1].argmax()), **extra)), flush=True)
  return k["launches"]


@contextlib.contextmanager
def patched(target, wrap):
  """Within it, the function `target` names ((module, function name);
  None: none) is `wrap` of itself."""
  if target is None:
    yield
    return
  module, name = target
  fn = getattr(module, name)
  setattr(module, name, wrap(fn))
  try:
    yield
  finally:
    setattr(module, name, fn)


def keeping_last(kept: list):
  """A `patched` wrap: each call appends its output's last position
  (batch row 0, in f32) to `kept`."""
  def wrap(fn):
    def kept_fn(*args, **kwargs):
      out = fn(*args, **kwargs)
      kept.append(out[0, -1].float())
      return out
    return kept_fn
  return wrap


def in_range(label: str):
  """A `patched` wrap: each call runs in a torch.profiler
  `record_function(label)` range."""
  def wrap(fn):
    def ranged(*args, **kwargs):
      with torch.profiler.record_function(label):
        return fn(*args, **kwargs)
    return ranged
  return wrap


# ---------------------------------------------------------------------------
# Phase 5: LMEngine on the same weights.
# ---------------------------------------------------------------------------

def lm_requests(cfg) -> list:
  """8 requests: prompts of 4..16 tokens, budgets of 1..16, drawn as
  `launch.serve` draws them (mean prompt length 8, --steps 16)."""
  rng = np.random.RandomState(0)
  reqs = []
  for _ in range(2 * SERVE_BATCH):
    prompt = rng.randint(1, cfg.vocab_size, size=(rng.randint(4, 17),))
    reqs.append((prompt, int(rng.randint(1, 17))))
  return reqs


def lm_engine(lm, cfg, policy: str, mesh=None):
  """An LMEngine at SERVE_BATCH slots (on `mesh` where given), warmed up
  and reset."""
  from repro_torch.serving.engine import LMEngine
  eng = LMEngine(cfg, lm, batch_size=SERVE_BATCH, max_len=64,
                 kernel_policy=policy, mesh=mesh,
                 device=None if mesh is not None else lm.final_norm.device)
  eng.submit(np.arange(1, 5), max_new_tokens=2)
  eng.run()
  eng.reset()
  return eng


def timed_run(eng, reqs):
  """One greedy run with no hooks; returns (finished, seconds, launches).
  The launch counts are zeroed just before the run and read just after."""
  from repro_torch.kernels import ops
  for prompt, budget in reqs:
    eng.submit(prompt, max_new_tokens=budget)
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.perf_counter()
  finished = eng.run(temperature=0.0)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = dict(ops.LAUNCHES)
  eng.reset()
  return finished, dt, launches


def recorded_run(eng, reqs, forced=None) -> dict:
  """One greedy run under the route log (`moe.record_routes`) that keeps
  each `decode_step` call's (tokens, positions, log-probs), each sampled
  batch and each admission (calls made before it, slot). With `forced`
  (another run's sampled batches) the engine is fed those instead of its
  own (teacher forcing), so every call sees the other run's inputs.
  Returns calls, sampled, admits, launches, routes (the dispatch log) and
  route_log."""
  from repro_torch.kernels import dispatch, ops
  from repro_torch.layers import moe
  calls, sampled, admits = [], [], []
  step, sample, admit = eng._step, eng._sample, eng._admit

  def rec_step(state, tokens, positions):
    logits, state = step(state, tokens, positions)
    calls.append((tokens, positions,
                  torch.log_softmax(logits[:, -1].float(), dim=-1)))
    return logits, state

  def rec_sample(logits, temperature):
    sampled.append(sample(logits, temperature))
    return sampled[-1] if forced is None else forced[len(sampled) - 1]

  def rec_admit(req, slot, temperature):
    admits.append((len(calls), slot))
    return admit(req, slot, temperature)
  eng._step, eng._sample, eng._admit = rec_step, rec_sample, rec_admit
  for prompt, budget in reqs:
    eng.submit(prompt, max_new_tokens=budget)
  ops.reset_launches()
  try:
    with dispatch.record_dispatch() as log, moe.record_routes() as route_log:
      eng.run(temperature=0.0)
  finally:
    del eng._step, eng._sample, eng._admit
  launches = dict(ops.LAUNCHES)
  eng.reset()
  return dict(calls=calls, sampled=sampled, admits=admits, launches=launches,
              routes=set(log), route_log=route_log)


def engine_rows(admits: list, c: int, positions) -> list:
  """Each row of recorded call `c` as (sequence, position), a sequence
  being its admission's index in `admits`: a batch-1 call (a prefill)
  belongs to the latest admission, row r of a batched call to slot r's
  latest; an idle row (position 0 in a batched call) is None."""
  pos = positions.tolist()
  if len(pos) == 1:
    return [(max(j for j, (c0, _) in enumerate(admits) if c0 <= c), pos[0])]
  out = []
  for r, p in enumerate(pos):
    seqs = [j for j, (c0, slot) in enumerate(admits) if slot == r and c0 <= c]
    out.append((seqs[-1], p) if p > 0 and seqs else None)
  return out


def time_layer_views(lm, cfg, reps: int = 10) -> dict:
  """Host cost of the per-layer views that each stack's `layers()` keeps:
  a batch-4 decode step under the "cuda" policy with the views kept, and
  with every stack's dropped before the step (which then builds each
  layer's leaf modules again), alternated; and `layers()` alone.
  Medians, ms."""
  from repro_torch.kernels import dispatch
  from repro_torch.models.transformer import decode_step, init_decode_state
  pol = dispatch.resolve_policy("cuda", SERVE_BATCH)
  state = init_decode_state(cfg, SERVE_BATCH, 64, device="cuda")
  tok = torch.ones((SERVE_BATCH, 1), dtype=torch.int64, device="cuda")
  pos = torch.arange(4, 4 + SERVE_BATCH, device="cuda")
  stacks = [stack for _, stack in lm.stacks()]
  out = {"step_views_kept": [], "step_views_rebuilt": [], "build_views": []}
  decode_step(lm, state, tok, pos, cfg, pol)
  for _ in range(reps):
    for key in out:
      if key != "step_views_kept":
        for stack in stacks:
          stack._views = None         # as if the views were not kept
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      if key == "build_views":
        for stack in stacks:
          stack.layers()
      else:
        decode_step(lm, state, tok, pos, cfg, pol)
      torch.cuda.synchronize()
      out[key].append((time.perf_counter() - t0) * 1e3)
  return {f"{k}_ms": statistics.median(v) for k, v in out.items()}


def first_route_flips(entries_p: list, entries_k: list, tokens_of
                      ) -> tuple[dict, dict]:
  """Compare two runs' route logs (`moe.record_routes`), entry by entry.
  `tokens_of(i)` gives entry i's (MoE layer, [(sequence, position) or
  None per routed token]) (None: an idle row). A token whose top-k set
  differs is a flip. A flip at (sequence, position p, layer l) is a
  consequence of an earlier one if its sequence flipped at a layer
  below l at a position <= p (the swapped expert's output reaches every
  later layer of that position and, through the latent cache, of the
  later positions); every other flip is a first difference, and its
  logit gap in the reference ("plain") run must be below
  ROUTE_LOGIT_GAP. Returns (stats, {sequence: its first flipped
  position}): from that position on, the sequence's outputs carry a
  whole swapped expert and are not held to a log-prob tolerance."""
  if len(entries_p) != len(entries_k):
    fail(f"route logs of {len(entries_p)} and {len(entries_k)} calls")
  flips: dict = {}
  routed = 0
  for i, (ep, ek) in enumerate(zip(entries_p, entries_k)):
    layer, toks = tokens_of(i)
    sp, sk = np.sort(ep["experts"], -1), np.sort(ek["experts"], -1)
    if sp.shape != sk.shape or sp.shape[0] != len(toks):
      fail(f"route log entry {i}: shapes {sp.shape} / {sk.shape}")
    for t in np.nonzero((sp != sk).any(-1))[0]:
      if toks[t] is not None:
        seq, pos = toks[t]
        flips.setdefault(seq, []).append(
            (layer, pos, float(ep["logit_gap"][t]), float(ek["logit_gap"][t])))
    routed += sum(x is not None for x in toks)
  first, caused = [], 0
  for seq, fl in flips.items():
    for layer, pos, gap_p, gap_k in fl:
      if any(l0 < layer and p0 <= pos for l0, p0, _, _ in fl):
        caused += 1
      else:
        first.append((seq, layer, pos, gap_p, gap_k))
  bad = [f for f in first if not f[3] < ROUTE_LOGIT_GAP]
  if bad:
    fail(f"routes: {len(bad)} first route differences are not near-ties "
         f"(logit gap >= {ROUTE_LOGIT_GAP}): {bad[:5]}")
  stats = dict(routed_tokens=routed, route_flips=len(first) + caused,
               first_route_flips=len(first), caused_route_flips=caused,
               sequences_flipped=len(flips),
               first_flip_max_logit_gap=max((f[3] for f in first),
                                            default=None))
  return stats, {seq: min(pos for _, pos, _, _ in fl)
                 for seq, fl in flips.items()}


def compare_logprobs(pairs, atol: float, what: str) -> dict:
  """Log-probs of two teacher-forced runs, row by row: `pairs` yields
  (call, cuda rows, plain rows, held) with `held` marking the rows held
  to `atol` (the others follow a route flip). Held rows agree within
  `atol` and their argmax differs only where the plain run's top-2 gap
  is below it; every row is finite."""
  diff, free_diff, flips, flip_gap, held_n, free_n = 0.0, 0.0, 0, 0.0, 0, 0
  for i, a, c, held in pairs:
    if not bool(torch.isfinite(a).all()):
      fail(f"{what}: non-finite log-probs at call {i}")
    if bool((~held).any()):
      free_diff = max(free_diff, float((a[~held] - c[~held]).abs().max()))
      free_n += int((~held).sum())
    if not bool(held.any()):
      continue
    a, c = a[held], c[held]
    held_n += a.shape[0]
    diff = max(diff, float((a - c).abs().max()))
    if diff > atol:
      fail(f"{what}: call {i} log-probs differ by {diff:.3g} > {atol} "
           "with no route flip before them")
    flip = a.argmax(-1) != c.argmax(-1)
    if bool(flip.any()):
      top2 = torch.topk(c[flip], 2, dim=-1).values
      gap = float((top2[:, 0] - top2[:, 1]).max())
      if gap >= atol:
        fail(f"{what}: argmax differs at call {i} at a top-2 gap of "
             f"{gap:.3g}")
      flips += int(flip.sum())
      flip_gap = max(flip_gap, gap)
  return dict(max_logprob_diff=diff, rows_held=held_n,
              rows_after_a_route_flip=free_n,
              max_logprob_diff_after_a_route_flip=free_diff,
              argmax_flips=flips, flip_max_top2_gap=flip_gap)


def router_drift(entries_p: list, entries_k: list, tokens_of,
                 what: str) -> float:
  """How far two runs on the same routes (identical, or one replaying
  the other's: `moe.replay_routes`) move the router's logit gaps: the
  largest change, over routed tokens (`tokens_of` as in
  `first_route_flips`) and pairs of experts, of the difference of two
  experts' logits, max_e d - min_e d for d the difference of the runs'
  logits at a token. A route can part between two runs only where the
  gap between its k-th and (k+1)-th expert is below that token's change,
  so ROUTE_LOGIT_GAP, the bound `first_route_flips` holds first flips
  to, rests on this staying below it."""
  worst = 0.0
  for i, (ep, ek) in enumerate(zip(entries_p, entries_k)):
    live = np.array([t is not None for t in tokens_of(i)[1]])
    d = ek["logits"][live] - ep["logits"][live]
    if d.size:
      worst = max(worst, float((d.max(-1) - d.min(-1)).max()))
  if not worst < ROUTE_LOGIT_GAP:
    fail(f"{what}: the router's logit gaps move by {worst:.4g} between "
         f"runs on the same routes, not below ROUTE_LOGIT_GAP "
         f"({ROUTE_LOGIT_GAP})")
  return worst


def check_lm_serving(lm, cfg, card, kernel: str = "decode_matvec",
                     compare=None) -> dict:
  """Correctness: a recorded plain run, and a recorded kernel run fed the
  plain run's tokens, compared call by call. Throughput: one run of each
  policy with no hooks. Every GEMM of the kernel runs must route to
  `kernel` (`decode_matvec` for unfactored weights, `lowrank_gemm` for a
  stage-2 model), the launches `step_leaves` counts a step. Log-probs
  agree within LM_SERVE_ATOL at every live row up to its sequence's
  first route flip. A MoE model's routes may differ: every first route
  difference must be a near-tie (`first_route_flips`), and a third
  recorded run, the kernel policy replaying the plain run's routes
  (`moe.replay_routes`), is held at every live row and gives the
  router's drift (`router_drift`), which must stay below
  ROUTE_LOGIT_GAP. `compare`: (model, cfg), a copy of the same weights
  on which the recorded runs are compared (default: `lm` itself; an f32
  copy is held to F32_LOGPROB_ATOL), and `lm` then takes one recorded
  "cuda" run of its own (routing, launches, finite log-probs) before the
  hook-free runs. Returns the hook-free kernel run's launches."""
  from repro_torch.layers import moe
  from repro_torch.models.transformer import depths
  what = f"{cfg.name} serving"
  reqs = lm_requests(cfg)
  transformer = cfg.family == "transformer"
  n_moe = depths(cfg)[1] if transformer else 0
  leaves = step_leaves(lm, cfg)
  names = {n for n, _, _ in leaves}
  stay = {(n, "jnp") for n in plain_gemms(cfg)}
  per_step = sum(w for _, _, w in leaves)
  cm, cc = compare or (lm, cfg)
  atol = F32_LOGPROB_ATOL if cc.dtype == torch.float32 else LM_SERVE_ATOL
  eng_k, eng_p = lm_engine(cm, cc, "cuda"), lm_engine(cm, cc, "plain")
  p = recorded_run(eng_p, reqs)
  k = recorded_run(eng_k, reqs, forced=p["sampled"])
  runs = {"recorded": k}
  if p["route_log"]:
    with moe.replay_routes(p["route_log"]):
      runs["replayed"] = recorded_run(eng_k, reqs, forced=p["sampled"])
  if compare is not None:
    del eng_k, eng_p
    eng_k, eng_p = lm_engine(lm, cfg, "cuda"), lm_engine(lm, cfg, "plain")
    runs["own"] = recorded_run(eng_k, reqs)
  fin_k, dt_k, launches = timed_run(eng_k, reqs)
  fin_p, dt_p, plain_launches_t = timed_run(eng_p, reqs)
  for name, r in runs.items():
    if r["routes"] != {(n, kernel) for n in names} | stay:
      fail(f"{what} ({name}): routing {sorted(r['routes'])}")
    if not all(bool(torch.isfinite(c[2]).all()) for c in r["calls"]):
      fail(f"{what} ({name}): non-finite log-probs")
  if p["routes"] != {(n, "jnp") for n in names} | stay:
    fail(f"{what}: plain routing {sorted(p['routes'])}")
  n_calls = len(p["calls"])
  for name, got in [(n, r["launches"]) for n, r in runs.items()] + [
      ("timed", launches)]:
    want = {n: per_step * n_calls if n == kernel else 0 for n in got}
    if got != want:
      fail(f"{what} ({name}): launches {got} != {want} ({n_calls} steps)")
  if any(p["launches"].values()) or any(plain_launches_t.values()):
    fail(f"{what}: the plain policy launched {p['launches']} / "
         f"{plain_launches_t}")
  for name, r in runs.items():
    if r["admits"] != p["admits"] or len(r["calls"]) != n_calls:
      fail(f"{what} ({name}): the runs admitted or stepped differently")

  def tokens_of(i):     # route-log entry i: MoE layer i % n_moe of a call
    c = i // n_moe
    return i % n_moe, engine_rows(p["admits"], c, p["calls"][c][1])
  route_stats, first_pos = {}, {}
  if p["route_log"]:
    route_stats, first_pos = first_route_flips(p["route_log"],
                                               k["route_log"], tokens_of)

  def pairs(run, first):
    """(call, live rows of `run`, of the plain run, held) a call; a row
    is held up to its sequence's first route flip in `first`."""
    for i, ((tk, pk, lk), (tp, pp, lp)) in enumerate(zip(run["calls"],
                                                         p["calls"])):
      if not (torch.equal(tk, tp) and torch.equal(pk, pp)):
        fail(f"{what}: call {i} was fed other tokens or positions")
      rows = engine_rows(p["admits"], i, pp)
      live = torch.tensor([r is not None for r in rows], device=lk.device)
      held = torch.tensor([r is not None and first.get(r[0], r[1] + 1) > r[1]
                           for r in rows], device=lk.device)
      yield i, lk[live], lp[live], held[live]
  lp_stats = compare_logprobs(pairs(k, first_pos), atol, what)
  if "replayed" in runs:
    r = runs["replayed"]
    rep = compare_logprobs(pairs(r, {}), atol, f"{what} (routes replayed)")
    lp_stats["replayed"] = {key: rep[key] for key in (
        "max_logprob_diff", "rows_held", "argmax_flips", "flip_max_top2_gap")}
    route_stats["router_drift"] = router_drift(
        p["route_log"], r["route_log"], tokens_of, f"{what} (replayed)")
    if lp_stats["rows_held"] == 0:
      print(f"{what}: every sequence flipped a route before its first "
            f"logged row, so the vanilla comparison held 0 rows; the "
            f"replayed run held {rep['rows_held']}", flush=True)
  # the engines' uids differ (the kernel engine may serve one run more):
  # pair the requests by submission order
  toks_k = [f.tokens.tolist() for f in sorted(fin_k, key=lambda f: f.uid)]
  toks_p = [f.tokens.tolist() for f in sorted(fin_p, key=lambda f: f.uid)]
  if len(fin_k) != len(reqs) or len(fin_p) != len(reqs):
    fail(f"{what}: not every request finished")
  same = sum(a == c for a, c in zip(toks_k, toks_p))

  def ttft_p50(fin):
    t = sorted(f.ttft_s for f in fin)
    return t[len(t) // 2] * 1e3

  n_k = sum(len(t) for t in toks_k)
  n_p = sum(len(t) for t in toks_p)
  print(json.dumps(dict(
      serve=cfg.name, card=card, dtype=str(cfg.dtype),
      compared_dtype=str(cc.dtype), layers=cfg.num_layers,
      requests=len(reqs), slots=SERVE_BATCH, steps=n_calls,
      launches_a_step=per_step, launches=launches, atol=atol,
      cuda_tokens=n_k, cuda_tok_per_s=n_k / dt_k,
      cuda_ttft_p50_ms=ttft_p50(fin_k), plain_tokens=n_p,
      plain_tok_per_s=n_p / dt_p, plain_ttft_p50_ms=ttft_p50(fin_p),
      tokens_equal=f"{same}/{len(toks_k)}", **lp_stats, **route_stats,
      **(time_layer_views(lm, cfg) if transformer else {}))), flush=True)
  return launches


# ---------------------------------------------------------------------------
# Phase 7: speculative serving — the rank-128 draft through lowrank_gemm,
# the verify window through decode_matvec.
# ---------------------------------------------------------------------------

def build_draft(lm, cfg, card):
  """The ported `make_draft_params(rank=DRAFT_RANK)` of the full-width
  target, on the card, timed. Requires every GEMM leaf factored at the
  draft rank (the 7 stacked leaves and the head), the embedding
  and norms shared with the target (the same storage), and the target
  left unfactored."""
  from repro_torch.core.factored import count_params, iter_factored_leaves
  from repro_torch.serving.speculative import make_draft_params
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  draft = make_draft_params(lm, rank=DRAFT_RANK)
  torch.cuda.synchronize()
  build_s = time.perf_counter() - t0
  leaves = list(iter_factored_leaves(draft))
  if len(leaves) != len(LM_GEMMS) + 1 or any(
      not leaf.is_factored or leaf.rank != DRAFT_RANK for leaf in leaves):
    fail(f"draft: leaves {[(lf.name, lf.is_factored) for lf in leaves]}")
  if any(lf.is_factored for lf in iter_factored_leaves(lm)):
    fail("draft: building it factored the target")
  shared = {"embedding.table", "final_norm", "dense_layers.ln1",
            "dense_layers.ln2"}
  dsd, tsd = draft.state_dict(), lm.state_dict()
  if any(dsd[k].data_ptr() != tsd[k].data_ptr() for k in shared):
    fail("draft: the embedding or a norm is a copy, not the target's")
  out = dict(draft=cfg.name, card=card, rank=DRAFT_RANK,
             build_s=build_s, draft_params=count_params(draft),
             target_params=count_params(lm),
             build_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
  print(json.dumps(out), flush=True)
  return draft, out


def speculative_cases(lm, draft, gen):
  """`lowrank_gemm` at each distinct draft shape (layer 0's factors; the
  other layers' have the same shapes) and the head's, at the batch of a
  draft prefill (1) and of a draft step (SERVE_BATCH); `decode_matvec`
  at the target's weights of those shapes at the verify window's
  SERVE_BATCH x (SPEC_K + 1) rows. `weight`: launches of the shape in
  one draft step, or one window."""
  from repro_torch.kernels import ref
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  bf16 = torch.bfloat16
  n_layers = len(lm.dense_layers.layers())
  cfg_name = f"llama3-8b ({n_layers} layers)"

  def layer0(model):
    lp = model.dense_layers.layers()[0]
    return ([lp["attn"][k] for k in ("wq", "wk", "wv", "wo")] +
            [lp["ffn"][k] for k in ("w_gate", "w_up", "w_down")] +
            [model.embedding.head])
  names = [f"layers/{g}" for g in LM_GEMMS] + ["lm_head"]
  shapes: dict = {}       # (m, r, n) -> [name, draft leaf, target w, weight]
  for name, d, t in zip(names, layer0(draft), layer0(lm)):
    key = (d.u.shape[0], d.u.shape[1], d.v.shape[1])
    entry = shapes.setdefault(key, [name, d, t.w, 0])
    entry[3] += 1 if name == "lm_head" else n_layers
  cases = []
  rows = SERVE_BATCH * (SPEC_K + 1)
  for (m, r, n), (name, d, wt, weight) in shapes.items():
    u, v = d.u, d.v
    for b in (1, SERVE_BATCH):
      x = randn((b, m), gen, bf16)
      cases.append(case(
          "lowrank_gemm", f"{cfg_name} draft {name} {m}x{r}x{n}", b, bf16,
          lambda a=(x, u, v): lowrank_gemm(*a),
          lambda a=(x, u, v): ref.lowrank_gemm(*a),
          lambda x=x, u=u, v=v: torch.matmul(torch.matmul(x, u), v),
          2 * (b * m + m * r + r * n + b * n), 2 * b * r * (m + n),
          path="lm_draft" if b == SERVE_BATCH else "lm_draft_prefill",
          weight=weight, cold=True))
    x = randn((rows, m), gen, bf16)
    cases.append(case(
        "decode_matvec", f"{cfg_name} verify {name} {m}x{n}", rows, bf16,
        lambda x=x, w=wt: decode_matvec(x, w),
        lambda x=x, w=wt: ref.decode_matvec(x, w),
        lambda x=x, w=wt: torch.matmul(x, w),
        2 * (rows * m + m * n + rows * n), 2 * rows * m * n,
        path="lm_verify", weight=weight, cold=True))
  return cases


def check_window_vs_steps(lm, cfg, card) -> dict:
  """The verify window against the steps it stands for, on the card
  under the "cuda" policy: SERVE_BATCH prompts of 8 tokens prefilled,
  then one (SERVE_BATCH x (SPEC_K + 1))-row `decode_window` and, from a
  clone of the same state, SPEC_K + 1 `decode_step`s. The window's GEMMs
  take 16 rows where a step's take 4, so `decode_matvec` sums in another
  split-K order: log-probs within LM_SERVE_ATOL (F32_LOGPROB_ATOL in
  f32), argmax flips only at a top-2 gap below it."""
  from repro_torch.kernels import dispatch
  from repro_torch.models.api import get_model
  api, dev = get_model(cfg), lm.final_norm.device
  pol = dispatch.resolve_policy("cuda", SERVE_BATCH, window=SPEC_K + 1)
  rng = np.random.RandomState(3)
  toks = torch.from_numpy(rng.randint(
      1, cfg.vocab_size, size=(SERVE_BATCH, 8 + SPEC_K + 1))).to(dev)
  state = api.init_decode_state(cfg, SERVE_BATCH, 64, device=dev)
  pos = torch.zeros(SERVE_BATCH, dtype=torch.int64, device=dev)
  for t in range(8):
    _, state = api.decode_step(lm, state, toks[:, t:t + 1], pos + t, cfg,
                               pol)
  steps_state = clone_state(state)
  win, _ = api.decode_window(lm, state, toks[:, 8:], pos + 8, cfg, pol)
  seq, _ = api.decode_window_sequential(lm, steps_state, toks[:, 8:],
                                        pos + 8, cfg, pol)
  lw, ls = torch.log_softmax(win, -1), torch.log_softmax(seq, -1)
  if not bool(torch.isfinite(lw).all()):
    fail("window: non-finite log-probs")
  diff = float((lw - ls).abs().max())
  flip = lw.argmax(-1) != ls.argmax(-1)
  gap = 0.0
  if bool(flip.any()):
    top2 = torch.topk(ls[flip], 2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).max())
  out = dict(window_vs_steps=cfg.name, card=card,
             rows=SERVE_BATCH * (SPEC_K + 1), max_logprob_diff=diff,
             argmax_flips=int(flip.sum()), flip_max_top2_gap=gap)
  print(json.dumps(out), flush=True)
  atol = F32_LOGPROB_ATOL if cfg.dtype == torch.float32 else LM_SERVE_ATOL
  if diff > atol or gap >= atol:
    fail(f"window vs steps: log-probs differ by {diff:.3g}, a flip at a "
         f"top-2 gap of {gap:.3g} (limit {atol})")
  return out


def clone_state(state):
  """A copy of a decode state (nested dicts of tensors)."""
  if isinstance(state, dict):
    return {k: clone_state(v) for k, v in state.items()}
  return state.clone()


def spec_engine(lm, cfg, draft, policy: str):
  """A speculative LMEngine at SERVE_BATCH slots, warmed up and reset."""
  from repro_torch.serving.engine import LMEngine
  eng = LMEngine(cfg, lm, batch_size=SERVE_BATCH, max_len=64,
                 kernel_policy=policy, speculate=SPEC_K, draft_params=draft,
                 device=lm.final_norm.device)
  eng.submit(np.arange(1, 5), max_new_tokens=3)
  eng.run()
  eng.reset()
  return eng


def counted_spec_run(eng, reqs):
  """One greedy speculative run that counts the target's steps, the
  draft's steps and the verify windows and keeps each kind's routing.
  The launch counts are zeroed just before the run and read just after.
  Returns (finished, calls by kind, routes by kind, launches, seconds)."""
  from repro_torch.kernels import dispatch, ops
  calls = {"step": 0, "draft": 0, "window": 0}
  routes = {k: set() for k in calls}
  originals = {"step": eng._step, "draft": eng._draft_step,
               "window": eng._window}

  def counted(kind):
    def fn(state, tokens, positions):
      calls[kind] += 1
      with dispatch.record_dispatch() as log:
        out = originals[kind](state, tokens, positions)
      routes[kind] |= set(log)
      return out
    return fn
  eng._step, eng._draft_step, eng._window = (
      counted("step"), counted("draft"), counted("window"))
  for prompt, budget in reqs:
    eng.submit(prompt, max_new_tokens=budget)
  torch.cuda.synchronize()
  ops.reset_launches()
  try:
    t0 = time.perf_counter()
    finished = eng.run(temperature=0.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
  finally:
    del eng._step, eng._draft_step, eng._window
  launches = dict(ops.LAUNCHES)
  return finished, calls, routes, launches, dt


def vanilla_logprobs(eng, reqs):
  """One greedy vanilla run that keeps, for each request, the log-probs
  each of its tokens was picked from. Returns ({uid: tokens},
  {uid: [log-probs (v,)]})."""
  rows: dict = {}
  last = []
  sample, record = eng._sample, eng._record_token

  def rec_sample(logits, temperature):
    last[:] = [torch.log_softmax(logits[:, -1].float(), dim=-1)]
    return sample(logits, temperature)

  def rec_record(slot, tok, pos):
    lp = last[0]
    rows.setdefault(eng._slots[slot].req.uid, []).append(
        lp[0] if lp.shape[0] == 1 else lp[slot])
    return record(slot, tok, pos)
  eng._sample, eng._record_token = rec_sample, rec_record
  for prompt, budget in reqs:
    eng.submit(prompt, max_new_tokens=budget)
  try:
    finished = eng.run(temperature=0.0)
  finally:
    del eng._sample, eng._record_token
  eng.reset()
  return {f.uid: f.tokens.tolist() for f in finished}, rows


def check_lm_speculative(card) -> tuple[dict, list[dict], dict]:
  """Phase 7, on llama3-8b at full width cut to SPEC_LAYERS layers (seeded
  random weights, as phase 4's). Returns (the counted speculative run's
  launches, the kernel rows, the summary)."""
  from repro_torch import configs
  cfg = configs.get_config(LM_ARCH).with_(num_layers=SPEC_LAYERS)
  lm = build_lm(cfg)
  draft, built = build_draft(lm, cfg, card)
  rows = check_cases(speculative_cases(lm, draft,
                                       torch.Generator().manual_seed(4)))
  launches, summary = run_speculative(lm, cfg, card, draft, built)
  del lm, draft
  free()
  return launches, rows, summary


def run_speculative(lm, cfg, card, draft, built: dict) -> tuple[dict, dict]:
  """The verify window against its steps, then phase 5's requests
  through `LMEngine(speculate=SPEC_K)` with `draft`: every draft GEMM
  (`step_leaves`' logical names) through lowrank_gemm and every target
  GEMM (admission steps, verify windows and, for a carry family, the
  replay's steps) through decode_matvec, `step_leaves`' launches a call;
  tokens as vanilla greedy's up to a near-tie flip (LM_SERVE_ATOL, or
  F32_LOGPROB_ATOL in f32). A carry family must take at least one masked
  replay: an iteration whose live slots committed different lengths, so
  that each slot's carries are put back past its own (`_replay`'s
  per-slot path). Returns (the counted run's launches, the summary)."""
  window = check_window_vs_steps(lm, cfg, card)
  atol = F32_LOGPROB_ATOL if cfg.dtype == torch.float32 else LM_SERVE_ATOL
  leaves = step_leaves(lm, cfg)
  names = {n for n, _, _ in leaves}
  per_call = sum(w for _, _, w in leaves)
  # a window's GEMMs take its SPEC_K + 1 positions at once, but the
  # sLSTM's recurrent GEMM runs position by position
  per_window = per_call + SPEC_K * sum(w for n, _, w in leaves
                                       if n == XLSTM_REC)
  reqs = lm_requests(cfg)
  eng = spec_engine(lm, cfg, draft, "cuda")
  replays = []
  if eng._has_carry:
    replay = eng._replay

    def counted_replay(step, state, window, commit, pos0):
      if step == eng._step:        # the target's (the draft replays too)
        replays.append([int(c) for i, c in enumerate(commit)
                        if eng._slots[i].active])
      return replay(step, state, window, commit, pos0)
    eng._replay = counted_replay
  fin, calls, routes, launches, dt_rec = counted_spec_run(eng, reqs)
  accept = eng.accept_rate
  drafted, accepted, iters = (eng.drafted_tokens, eng.accepted_tokens,
                              eng.decode_steps)
  masked = sum(len(set(c)) > 1 for c in replays)
  if eng._has_carry:
    del eng._replay
    if not masked:
      fail(f"{cfg.name} speculative serving: no masked replay (every "
           f"replay's live slots committed alike: {replays})")
  eng.reset()
  # routing: every draft GEMM through lowrank_gemm, every target GEMM
  # (admission steps and verify windows) through decode_matvec
  stay = {(n, "jnp") for n in plain_gemms(cfg)}
  want = {"draft": {(n, "lowrank_gemm") for n in names} | stay,
          "step": {(n, "decode_matvec") for n in names} | stay,
          "window": {(n, "decode_matvec") for n in names} | stay}
  if routes != want:
    fail(f"speculative serving: routing {routes}")
  want_launches = {k: 0 for k in launches}
  want_launches.update(lowrank_gemm=per_call * calls["draft"],
                       decode_matvec=per_call * calls["step"] +
                       per_window * calls["window"])
  if launches != want_launches:
    fail(f"speculative serving: launches {launches} != {want_launches} "
         f"({calls})")
  if calls["window"] != iters or calls["draft"] < (SPEC_K + 1) * iters:
    fail(f"speculative serving: {calls} for {iters} iterations")
  # tokens: vanilla greedy's, up to the first flip at a near-tie
  van = lm_engine(lm, cfg, "cuda")
  toks_v, lps_v = vanilla_logprobs(van, reqs)
  toks_s = {f.uid: f.tokens.tolist() for f in fin}
  if sorted(toks_s) != sorted(toks_v) or len(toks_s) != len(reqs):
    fail("speculative serving: not every request finished")
  equal, first_flips = 0, []
  for uid, tv in toks_v.items():
    ts = toks_s[uid]
    if len(ts) != len(tv):
      fail(f"speculative serving: request {uid} emitted {len(ts)} tokens, "
           f"vanilla {len(tv)}")
    j = next((i for i, (a, b) in enumerate(zip(ts, tv)) if a != b), None)
    if j is None:
      equal += 1
      continue
    lp = lps_v[uid][j]
    gap = float(lp[tv[j]] - lp[ts[j]])
    first_flips.append(dict(uid=uid, token=j, vanilla_gap=gap))
    if gap >= atol:
      fail(f"speculative serving: request {uid} token {j} is {ts[j]}, "
           f"vanilla's {tv[j]}, at a log-prob gap of {gap:.3g}")
  # throughput smoke readings, hook-free: speculative and vanilla
  fin_t, dt_s, _ = timed_run(eng, reqs)
  fin_v, dt_v, _ = timed_run(van, reqs)
  n_s = sum(len(f.tokens) for f in fin_t)
  n_v = sum(len(f.tokens) for f in fin_v)
  # the plain policy launches nothing on the speculative path
  plain = spec_engine(lm, cfg, draft, "plain")
  fin_p, dt_p, plain_launches = timed_run(plain, reqs[:SERVE_BATCH])
  if any(plain_launches.values()) or len(fin_p) != SERVE_BATCH:
    fail(f"speculative serving: the plain policy launched {plain_launches}")
  summary = dict(
      serve_speculative=cfg.name, card=card, layers=cfg.num_layers,
      requests=len(reqs), slots=SERVE_BATCH, k=SPEC_K, draft_rank=DRAFT_RANK,
      draft_build_s=built["build_s"], iterations=iters, calls=calls,
      launches=launches, drafted=drafted, accepted=accepted,
      accept_rate=accept, tokens_equal=f"{equal}/{len(toks_v)}",
      first_flips=first_flips, counted_run_s=dt_rec,
      speculative_tokens=n_s, speculative_tok_per_s=n_s / dt_s,
      vanilla_tokens=n_v, vanilla_tok_per_s=n_v / dt_v,
      plain_speculative_tok_per_s=sum(len(f.tokens) for f in fin_p) / dt_p,
      window_max_logprob_diff=window["max_logprob_diff"],
      replays=len(replays), masked_replays=masked,
      iterations_not_replayed=iters - len(replays) if eng._has_carry else 0,
      live_commits_by_replay=replays)
  print(json.dumps(summary), flush=True)
  del eng, plain, van
  return launches, summary


# ---------------------------------------------------------------------------
# Phase 6: training — the two-stage recipe at full width, then served.
# ---------------------------------------------------------------------------

def make_trainer(cfg, device, ckpt_dir, lr=None, generator=None, mesh=None,
                 optimizer="adamw", exclude=("*embed*",)):
  """`launch/train.py`'s trainer: two stages (trace norm, transition at
  TRAIN_TRANSITION), its plan (leaving `exclude` unfactored), cosine LR
  (or a constant `lr`), random weights from seed 0 (a CPU generator's,
  unless `generator`); on `mesh` with `optimizer` where given (phase
  14)."""
  from repro_torch.core.compress import FactorizationPlan
  from repro_torch.core.schedule import TwoStageSchedule, cosine_schedule
  from repro_torch.core.svd import TruncationSpec
  from repro_torch.core.tracenorm import RegularizerConfig
  from repro_torch.training import TrainConfig, Trainer
  sched = TwoStageSchedule(
      total_steps=TRAIN_STEPS, transition_step=TRAIN_TRANSITION,
      regularizer=RegularizerConfig(kind="trace", lambda_rec=TRAIN_LAMBDA,
                                    lambda_nonrec=TRAIN_LAMBDA),
      truncation=TruncationSpec(variance_threshold=0.9, round_to=8))
  lr = cosine_schedule(1e-3, TRAIN_STEPS // 10, TRAIN_STEPS) if lr is None \
      else lr
  return Trainer(cfg, TrainConfig(lr=lr, checkpoint_dir=str(ckpt_dir),
                                  async_checkpoint=False,
                                  optimizer=optimizer),
                 schedule=sched,
                 plan=FactorizationPlan(min_dim=32, exclude=exclude),
                 generator=generator or torch.Generator().manual_seed(0),
                 device=device, mesh=mesh,
                 batch_size=0 if mesh is None else TRAIN_BATCH
                 if cfg.family == "deepspeech" else LM_TRAIN_BATCH)


def train_batch(cfg, step: int) -> dict:
  """Step `step`'s batch of the synthetic speech (TRAIN_BATCH
  utterances) or LM stream (LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens)."""
  if cfg.family in ("transformer", "zamba", "xlstm"):
    from repro_torch.data import lm as lm_data
    return lm_data.batch_at(lm_data.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
        global_batch=LM_TRAIN_BATCH), step)
  from repro_torch.data.speech import SpeechDataConfig, batch_at
  return batch_at(SpeechDataConfig(vocab_size=cfg.vocab_size,
                                   feat_dim=cfg.feat_dim,
                                   global_batch=TRAIN_BATCH), step)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
  return float((a.float() - b.float()).norm() / b.float().norm())


def check_training_card_vs_cpu(card, arch: str = "deepspeech2-wsj",
                               update_rtol: float = TRAIN_UPDATE_RTOL
                               ) -> dict:
  """One f32 stage-1 step at `arch`'s smoke width on the CPU and on the
  card, the card's trainer restored from the CPU trainer's step-0
  checkpoint (each device's own stage-1 SVD would pick other signs):
  loss, gradients and each leaf's update within TRAIN_LOSS_RTOL,
  TRAIN_GRAD_RTOL and `update_rtol`. Prints the share of the update
  entries whose sign differs between the devices (Adam's first step
  moves each weight by ~lr * sign(g))."""
  from repro_torch import configs
  cfg = configs.get_smoke(arch).with_(dtype=torch.float32)
  ckpt = ROOT / "build" / f"train_smoke_ckpt_{arch}"
  shutil.rmtree(ckpt, ignore_errors=True)
  batch = train_batch(cfg, 0)
  runs = []
  for dev in ("cpu", "cuda"):
    tr = make_trainer(cfg, dev, ckpt, lr=1e-3)
    if runs:
      tr.restore()
    else:
      tr.save(blocking=True)
    before = {k: p.detach().cpu().clone() for k, p in
              tr.params.named_parameters()}
    _, _, grads = tr._step_fn.grads_of(tr.params, batch)
    m = tr.train_step(batch)
    runs.append((m["loss"], {k: g.cpu() for k, g in grads.items()},
                 {k: p.detach().cpu() - before[k] for k, p in
                  tr.params.named_parameters()}))
  (l_c, g_c, d_c), (l_g, g_g, d_g) = runs
  loss_rel = abs(l_g - l_c) / abs(l_c)
  grad_rel = max(_rel(g_g[k], g_c[k]) for k in g_c)
  update_rel = max(_rel(d_g[k], d_c[k]) for k in d_c)
  out = dict(train_card_vs_cpu=cfg.name, card=card,
             batch={k: list(np.shape(v)) for k, v in batch.items()},
             loss_cpu=l_c, loss_cuda=l_g, loss_rel=loss_rel,
             max_grad_rel=grad_rel, max_update_rel=update_rel)
  flips = sum(int((torch.sign(d_g[k]) != torch.sign(d)).sum())
              for k, d in d_c.items())
  out["update_sign_flips"] = flips / sum(d.numel() for d in d_c.values())
  print(json.dumps(out), flush=True)
  if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL and
          update_rel <= update_rtol):
    fail(f"training step card vs CPU: loss {loss_rel:.3g}, gradients "
         f"{grad_rel:.3g}, updates {update_rel:.3g} (limits "
         f"{TRAIN_LOSS_RTOL}, {TRAIN_GRAD_RTOL}, {update_rtol})")
  return out


def profile_step(fn, name: str) -> dict:
  """`fn()` (one training step) under torch.profiler: the device's
  kernel time in all, its idle share of this profiled step's wall time
  (which the profiler's own host work lengthens), and the kernels that
  take the most of it, summed by name. The profiler's and the trace's
  objects are collected before it returns, so that the next timed step
  does not pay for them."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  trace = ROOT / "build" / f"{name}_trace.json"
  prof.export_chrome_trace(str(trace))
  by_name: dict = {}
  count = 0
  for e in json.loads(trace.read_text())["traceEvents"]:
    if e.get("cat") == "kernel":
      count += 1
      key = e.get("name", "?")[:60]
      by_name[key] = by_name.get(key, 0.0) + e.get("dur", 0.0) / 1e3
  busy = sum(by_name.values())
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
  del prof
  gc.collect()
  return dict(wall_ms=wall * 1e3, device_kernel_ms=busy, kernels=count,
              profiled_idle_share=1.0 - busy / (wall * 1e3),
              top_kernels_ms={k: round(v, 4) for k, v in top})


def timed_walls(fn, n: int) -> list[float]:
  """`fn()` once (a warm-up), then `n` calls timed on the host clock with
  the device synchronised around each: their ms."""
  fn()
  out = []
  for _ in range(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out.append((time.perf_counter() - t0) * 1e3)
  return out


def annotated_kernel_ms(trace: Path, label: str) -> tuple[float, int]:
  """Device time of the kernels launched inside `record_function(label)`
  ranges of a torch.profiler trace (by the launches' correlation ids),
  and the number of ranges."""
  events = json.loads(trace.read_text())["traceEvents"]
  spans = [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in events
           if e.get("cat") == "user_annotation" and e.get("name") == label]
  corr = {e["args"]["correlation"] for e in events
          if e.get("cat") in ("cuda_runtime", "cuda_driver") and
          "correlation" in
          e.get("args", {}) and any(a <= e["ts"] <= b and e.get("tid") == t
                                    for a, b, t in spans)}
  ms = sum(e.get("dur", 0.0) for e in events if e.get("cat") == "kernel"
           and e.get("args", {}).get("correlation") in corr) / 1e3
  return ms, len(spans)


def profile_paths(lm, cfg, name: str, prefill_tokens: int = PREFILL_LEN,
                  mark=None) -> dict:
  """Where a model's time goes on the card under "cuda": one
  batch-SERVE_BATCH decode step (positions 64.. of a zeroed state) timed
  unprofiled (median of 5) and once under torch.profiler, and
  forward(last_only=True) over one `prefill_tokens`-token prompt timed
  (median of 3) and once under the profiler; each profile gets the
  device's idle share of its unprofiled median. `mark`: (module, function
  name) whose calls in the profiled prefill each run in a
  `record_function` range: their device time, share of the prefill's
  and number (`marked_calls`). Traces go to build/{name}_*_trace.json."""
  from repro_torch.kernels import dispatch
  from repro_torch.models.api import get_model
  api = get_model(cfg)
  pol = dispatch.resolve_policy("cuda", SERVE_BATCH)
  state = api.init_decode_state(cfg, SERVE_BATCH, 128, device="cuda")
  tok = torch.ones((SERVE_BATCH, 1), dtype=torch.int64, device="cuda")
  pos = torch.arange(64, 64 + SERVE_BATCH, device="cuda")

  def step():
    api.decode_step(lm, state, tok, pos, cfg, pol)
  step_walls = timed_walls(step, 5)
  step_prof = profile_step(step, f"{name}_decode_step")
  step_prof["device_idle_share"] = 1.0 - step_prof["device_kernel_ms"] / \
      statistics.median(step_walls)
  del state
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(1, prefill_tokens))).to("cuda")
  prefill_pol = dispatch.resolve_policy("cuda")

  def prefill():
    api.forward(lm, toks, cfg, last_only=True, policy=prefill_pol)
  prefill_walls = timed_walls(prefill, 3)
  label = mark[1] if mark else None
  with patched(mark, in_range(label)):
    prefill_prof = profile_step(prefill, f"{name}_prefill")
  if mark is not None:
    ms, calls = annotated_kernel_ms(
        ROOT / "build" / f"{name}_prefill_trace.json", label)
    prefill_prof.update(marked=label, marked_kernel_ms=ms,
                        marked_calls=calls,
                        marked_share=ms / prefill_prof["device_kernel_ms"])
  prefill_prof.update(tokens=prefill_tokens, device_idle_share=1.0 -
                      prefill_prof["device_kernel_ms"] /
                      statistics.median(prefill_walls))
  return dict(decode_step_ms=statistics.median(step_walls),
              decode_step_walls_ms=step_walls, decode_step=step_prof,
              prefill_ms=statistics.median(prefill_walls),
              prefill_walls_ms=prefill_walls, prefill=prefill_prof)


def trained_kernel_cases(fact, quant, gen) -> list[dict]:
  """lowrank_gemm at every trained factored leaf (batch SERVE_BATCH,
  bf16) and int8_gemm at both GEMMs of every PTQ'd factored leaf: the
  shapes the trained model's serving gives the kernels."""
  from repro_torch.core.factored import iter_factored_leaves, iter_gemm_leaves
  from repro_torch.kernels import ref
  from repro_torch.kernels.int8_gemm import int8_gemm
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  b, bf16 = SERVE_BATCH, torch.bfloat16
  cases = []
  for leaf in iter_factored_leaves(fact):
    u, v = leaf.u, leaf.v
    (m, r), n = u.shape, v.shape[1]
    if min(m, r, n) < 128:      # the lane gate: served by the plain path
      continue
    x = randn((b, m), gen, bf16)
    cases.append(case("lowrank_gemm", f"trained {leaf.name} {m}x{r}x{n}", b,
                      bf16, lambda a=(x, u, v): lowrank_gemm(*a),
                      lambda a=(x, u, v): ref.lowrank_gemm(*a)))
  for leaf in iter_gemm_leaves(quant):
    for wq, ws in ((leaf.u_q, leaf.u_scale), (leaf.v_q, leaf.v_scale)):
      m, n = wq.shape
      xq, xs = ref.quantize_rowwise(randn((b, m), gen, bf16))
      cases.append(case("int8_gemm", f"trained {leaf.name} {m}x{n}", b,
                        torch.int8, lambda a=(xq, wq, xs, ws): int8_gemm(*a),
                        lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a),
                        exact=True))
  return cases


def check_training(cfg, card) -> tuple[dict, list[dict], dict]:
  """Full-width two-stage training, the checkpoint round trip, and the
  trained model through the kernels and the server. Returns (the serving
  run's launches, the kernel rows, the training summary)."""
  from repro_torch.checkpoint.manager import flatten
  from repro_torch.core.compress import compression_report
  from repro_torch.core.factored import count_params, frozen, \
      iter_factored_leaves
  from repro_torch.quant import quantize_params
  ckpt = ROOT / "build" / "train_ckpt"
  shutil.rmtree(ckpt, ignore_errors=True)
  t0 = time.perf_counter()
  tr = make_trainer(cfg, "cuda", ckpt)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  steps, profiles = [], {}
  for i in range(TRAIN_STEPS):
    batch = train_batch(cfg, i)
    if i == TRAIN_TRANSITION:
      stage1 = tr.params
      params_before = count_params(stage1)
    t0 = time.perf_counter()
    if i in (1, TRAIN_TRANSITION + 1):      # one profiled step a stage
      profiles[f"stage{tr.stage}"] = profile_step(
          lambda b=batch: steps.append(tr.train_step(b)), f"train_step{i}")
    else:
      steps.append(tr.train_step(batch))
    steps[-1]["call_s"] = time.perf_counter() - t0
  params_after = count_params(tr.params)
  losses = [m["loss"] for m in steps]
  if not all(math.isfinite(x) for x in losses):
    fail(f"training: non-finite loss {losses}")
  stages = [m["stage"] for m in steps]
  if stages != [1] * TRAIN_TRANSITION + [2] * (TRAIN_STEPS - TRAIN_TRANSITION):
    fail(f"training: stages {stages}")
  if not params_after < params_before:
    fail(f"training: {params_after} params after the transition, "
         f"{params_before} before")
  ranks = {}
  for leaf in iter_factored_leaves(tr.params):
    if not leaf.is_factored or leaf.rank % 8 or \
        leaf.rank > min(leaf.in_dim, leaf.out_dim):
      fail(f"training: leaf {leaf.name} rank "
           f"{leaf.rank if leaf.is_factored else None}")
    ranks[leaf.name] = leaf.rank
  report = compression_report(stage1, tr.params)
  nu = {k: r["nu"] for k, r in list(tr.tracenorm_report().items())[:5]}
  # each stage's median leaves out its first step (warm-up, new shapes)
  # and its profiled one
  plain = [i for i in range(TRAIN_STEPS) if i not in
           (0, 1, TRAIN_TRANSITION, TRAIN_TRANSITION + 1)]
  median_ms = {f"stage{s}": statistics.median(
      steps[i]["wall_s"] * 1e3 for i in plain if steps[i]["stage"] == s)
      for s in (1, 2)}
  for s, prof in profiles.items():     # idle share of an unprofiled step
    prof["device_idle_share"] = 1.0 - prof["device_kernel_ms"] / median_ms[s]
  transition_ms = (steps[TRAIN_TRANSITION]["call_s"]
                   - steps[TRAIN_TRANSITION]["wall_s"]) * 1e3
  # checkpoint round trip into a fresh trainer
  tr.save(blocking=True)
  fresh = make_trainer(cfg, "cuda", ckpt)
  fresh.restore()
  want = flatten({"params": tr.params, "opt": tr.opt_state})
  got = dict(flatten({"params": fresh.params, "opt": fresh.opt_state}))
  if (fresh.step, fresh.stage) != (tr.step, tr.stage) or \
      sorted(got) != sorted(k for k, _ in want):
    fail("checkpoint round trip: structure or step differs")
  for k, x in want:
    y = got[k]
    same = x == y if isinstance(x, int) else (
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y))
    if not same:
      fail(f"checkpoint round trip: {k} differs")
  del fresh
  summary = dict(
      train=cfg.name, card=card, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
      transition_step=TRAIN_TRANSITION, init_s=init_s, losses=losses,
      stages=stages, wall_ms=[m["wall_s"] * 1e3 for m in steps],
      median_step_ms=median_ms, transition_ms=transition_ms,
      params_before=params_before, params_after=params_after,
      total_params_before=report["total_params_before"],
      total_params_after=report["total_params_after"], ranks=ranks,
      nu_first5=nu, checkpoint_leaves=len(want), profiles=profiles)
  print(json.dumps(summary), flush=True)
  # serve what was trained, and its PTQ'd form
  fact = frozen(copy.deepcopy(tr.params))
  forms = {"factored": fact, "int8": quantize_params(fact)}
  rows = check_cases(trained_kernel_cases(
      fact, forms["int8"], torch.Generator().manual_seed(3)))
  by_name = {leaf.name: leaf for leaf in iter_factored_leaves(fact)}

  def trained_route(name):
    leaf = by_name[name]
    return "lowrank_gemm" if min(leaf.in_dim, leaf.rank, leaf.out_dim) >= \
        128 else "jnp"
  launches = check_serving(cfg, forms, card, routes={
      "factored": trained_route, "int8": EXPECTED_ROUTES["int8"]})
  return launches, rows, summary


# ---------------------------------------------------------------------------
# Phase 8: the rest of the dense family at full width — qwen3-4b served,
# stablelm-3b's prefill through the d = 80 flash kernel.
# ---------------------------------------------------------------------------

def check_dense_family(card) -> tuple[dict, list[dict]]:
  """qwen3-4b (qk-norm) at full width cut to QWEN_LAYERS: decode_matvec
  held and timed at its decode step's shapes, the 4096-token prefill
  under both policies (a flash route a layer) and LMEngine's 8 requests
  (7 launches a layer and the head a step);
  then stablelm-3b at full width, STABLELM_LAYERS layers, its prefill
  through the d = 80 kernel (one flash route a layer). Returns (launches
  by path, kernel rows)."""
  from repro_torch import configs
  by_path = {}
  qcfg = configs.get_config("qwen3-4b").with_(num_layers=QWEN_LAYERS)
  lm = build_lm(qcfg)
  rows = check_cases(decode_cases(step_leaves(lm, qcfg),
                                  torch.Generator().manual_seed(5),
                                  "qwen3_decode", prefix="qwen3-4b "))
  by_path["qwen3_prefill"] = check_prefill(lm, qcfg, card)
  by_path["qwen3_serving"] = check_lm_serving(lm, qcfg, card)
  del lm
  gc.collect()
  torch.cuda.empty_cache()
  scfg = configs.get_config("stablelm-3b").with_(num_layers=STABLELM_LAYERS)
  if scfg.resolved_head_dim != 80:
    fail(f"stablelm-3b: head width {scfg.resolved_head_dim}")
  lm = build_lm(scfg)
  by_path["stablelm_prefill"] = check_prefill(lm, scfg, card)
  del lm
  gc.collect()
  torch.cuda.empty_cache()
  return by_path, rows


# ---------------------------------------------------------------------------
# Phase 9: the two-stage recipe on the transformer — qwen3-4b at full
# width, depth cut, trained and then served through lowrank_gemm.
# ---------------------------------------------------------------------------

def dense_param_count(model) -> int:
  """Parameters of `model` with every factored GEMM counted unfactored."""
  from repro_torch.core.factored import count_params, iter_factored_leaves
  total = count_params(model)
  for leaf in iter_factored_leaves(model):
    if leaf.is_factored:
      total += math.prod(leaf.u.shape[:-1]) * leaf.v.shape[-1] - \
          leaf.num_params
  return total


def lowrank_cases(leaves, gen, path: str, prefix: str) -> list[dict]:
  """lowrank_gemm at each (name, 2-D factored leaf, launches a step) of
  `leaves`, batch SERVE_BATCH, timed against two `torch.matmul` calls and
  the bound; `weight` is each shape's launches a step."""
  from repro_torch.kernels import ref
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  b = SERVE_BATCH
  cases = []
  for name, leaf, weight in leaves:
    u, v = leaf.u, leaf.v
    (m, r), n = u.shape, v.shape[1]
    xd = act_dtype(name, u)
    x = randn((b, m), gen, xd)
    xs, ws = x.element_size(), u.element_size()
    cases.append(case("lowrank_gemm", f"{prefix}{name} {m}x{r}x{n}",
                      b, u.dtype, lambda a=(x, u, v): lowrank_gemm(*a),
                      lambda a=(x, u, v): ref.lowrank_gemm(*a),
                      matmul_lib(x, u, v),
                      xs * (b * m + b * n) + ws * (m * r + r * n),
                      2 * b * r * (m + n), path=path, weight=weight,
                      cold=True, act=xd))
  return cases


def check_lm_training(card) -> tuple[dict, list[dict], dict]:
  """Full-width qwen3-4b cut to LM_TRAIN_LAYERS layers, bf16, trained
  TRAIN_STEPS steps of `data/lm.py` batches through both stages
  (transition at TRAIN_TRANSITION), then frozen and served through
  LMEngine: lowrank_gemm held at its trained shapes, every GEMM of the
  "cuda" run through it. Returns (the serving run's launches, the kernel
  rows, the training summary)."""
  from repro_torch import configs
  from repro_torch.core.factored import count_params, frozen, \
      iter_factored_leaves
  cfg = configs.get_config("qwen3-4b").with_(num_layers=LM_TRAIN_LAYERS)
  ckpt = ROOT / "build" / "lm_train_ckpt"
  shutil.rmtree(ckpt, ignore_errors=True)
  t0 = time.perf_counter()
  tr = make_trainer(cfg, "cuda", ckpt,
                    generator=torch.Generator(device="cuda").manual_seed(0))
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  dense_params = dense_param_count(tr.params)
  steps, profiles = [], {}
  for i in range(TRAIN_STEPS):
    batch = train_batch(cfg, i)
    if i == TRAIN_TRANSITION:
      params_before = count_params(tr.params)
    t0 = time.perf_counter()
    if i in (1, TRAIN_TRANSITION + 1):      # one profiled step a stage
      profiles[f"stage{tr.stage}"] = profile_step(
          lambda b=batch: steps.append(tr.train_step(b)), f"lm_train_step{i}")
    else:
      steps.append(tr.train_step(batch))
    steps[-1]["call_s"] = time.perf_counter() - t0
  params_after = count_params(tr.params)
  losses = [m["loss"] for m in steps]
  if not all(math.isfinite(x) for x in losses):
    fail(f"LM training: non-finite loss {losses}")
  stages = [m["stage"] for m in steps]
  if stages != [1] * TRAIN_TRANSITION + [2] * (TRAIN_STEPS - TRAIN_TRANSITION):
    fail(f"LM training: stages {stages}")
  if not params_after < params_before:
    fail(f"LM training: {params_after} params after the transition, "
         f"{params_before} before")
  ranks = {}
  for leaf in iter_factored_leaves(tr.params):
    if not leaf.is_factored or leaf.rank % 8 or \
        leaf.rank > min(leaf.in_dim, leaf.out_dim):
      fail(f"LM training: leaf {leaf.name} rank "
           f"{leaf.rank if leaf.is_factored else None}")
    ranks[leaf.name] = leaf.rank
  # each stage's median leaves out its first step (warm-up, new shapes)
  # and its profiled one
  median_ms = {f"stage{s}": statistics.median(
      m["wall_s"] * 1e3 for i, m in enumerate(steps)
      if m["stage"] == s and i not in (0, 1, TRAIN_TRANSITION,
                                       TRAIN_TRANSITION + 1))
      for s in (1, 2)}
  for s, prof in profiles.items():     # idle share of an unprofiled step
    prof["device_idle_share"] = 1.0 - prof["device_kernel_ms"] / median_ms[s]
  transition_ms = (steps[TRAIN_TRANSITION]["call_s"]
                   - steps[TRAIN_TRANSITION]["wall_s"]) * 1e3
  summary = dict(
      train=cfg.name, card=card, layers=cfg.num_layers,
      batch=[LM_TRAIN_BATCH, LM_TRAIN_SEQ], remat=cfg.remat,
      steps=TRAIN_STEPS, transition_step=TRAIN_TRANSITION, init_s=init_s,
      losses=losses, xent=[m["xent"] for m in steps], stages=stages,
      wall_ms=[m["wall_s"] * 1e3 for m in steps],
      median_step_ms=median_ms, transition_ms=transition_ms,
      dense_params=dense_params, stage1_params=params_before,
      stage2_params=params_after,
      stage2_over_dense=params_after / dense_params, ranks=ranks,
      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
      profiles=profiles)
  print(json.dumps(summary), flush=True)
  fact = frozen(copy.deepcopy(tr.params))
  del tr
  gc.collect()
  torch.cuda.empty_cache()
  rows = check_cases(lowrank_cases(step_leaves(fact, cfg),
                                   torch.Generator().manual_seed(6),
                                   "qwen3_trained", "trained qwen3-4b "))
  launches = check_lm_serving(fact, cfg, card, kernel="lowrank_gemm")
  del fact
  gc.collect()
  torch.cuda.empty_cache()
  return launches, rows, summary


# ---------------------------------------------------------------------------
# Phase 10: whisper-small — the encoder through non-causal flash, the
# decoder through decode_matvec, LiteASR-calibrated truncation through
# lowrank_gemm, calibrated PTQ through int8_gemm.
# ---------------------------------------------------------------------------

def _leaf(stack, path: str):
  mod = stack
  for part in path.split("/"):
    mod = getattr(mod, part)
  return mod


def whisper_frames(cfg, seed: int) -> torch.Tensor:
  gen = torch.Generator(device="cuda").manual_seed(seed)
  return torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model),
                     generator=gen, device="cuda")


def counted(fn):
  """(fn(), seconds, launches, routing log): counts zeroed just before,
  read just after."""
  from repro_torch.kernels import dispatch, ops
  torch.cuda.synchronize()
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
  return out, dt, dict(ops.LAUNCHES), set(log)


def only(launches: dict, want: dict, what: str) -> None:
  full = {k: want.get(k, 0) for k in launches}
  if launches != full:
    fail(f"{what}: launches {launches} != {full}")


def check_encode(model, cfg, frames, want: dict, what: str) -> dict:
  """encode under both policies: `want` launches under "cuda", none under
  "plain", memories within WHISPER_ATOL. Returns the numbers."""
  from repro_torch.kernels import dispatch
  from repro_torch.models import whisper
  runs = {}
  for policy in ("cuda", "plain"):
    pol = dispatch.resolve_policy(policy, WHISPER_BATCH)
    whisper.encode(model, frames, cfg, pol)     # warm-up: cuBLAS, allocator
    runs[policy] = counted(lambda p=pol: whisper.encode(model, frames, cfg, p))
  (mem_k, dt_k, launches, _), (mem_p, dt_p, plain, _) = \
      runs["cuda"], runs["plain"]
  only(launches, want, f"{what} encode")
  only(plain, {}, f"{what} plain encode")
  if mem_k.shape != (WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model) or \
      not bool(torch.isfinite(mem_k).all()):
    fail(f"{what}: memory of the wrong shape or not finite")
  diff = float((mem_k.float() - mem_p.float()).abs().max())
  if diff > WHISPER_ATOL:
    fail(f"{what}: memories differ by {diff:.3g} > {WHISPER_ATOL}")
  return dict(launches=launches, cuda_encode_ms=dt_k * 1e3,
              plain_encode_ms=dt_p * 1e3, max_memory_diff=diff,
              memory=mem_p)


def whisper_decode(model, cfg, mem, policy: str, steps: int, forced=None):
  """A greedy loop of `api.decode_step` over WHISPER_BATCH slots from the
  memory, or fed `forced` (another run's tokens). Returns (log-probs a
  step, tokens fed, ms a step, launches a step, routing log)."""
  from repro_torch.kernels import dispatch
  from repro_torch.models.api import get_model
  api = get_model(cfg)
  pol = dispatch.resolve_policy(policy, WHISPER_BATCH)
  state = api.init_decode_state(cfg, WHISPER_BATCH, steps + 1,
                                enc_len=mem.shape[1], device="cuda")
  state["mem"].copy_(mem)
  tok = torch.ones((WHISPER_BATCH, 1), dtype=torch.int64, device="cuda")
  logps, fed, ms, launches, routes = [], [], [], [], set()
  for i in range(steps):
    pos = torch.full((WHISPER_BATCH,), i, dtype=torch.int64, device="cuda")
    (logits, state), dt, n, log = counted(
        lambda t=tok, p=pos, st=state: api.decode_step(model, st, t, p, cfg,
                                                       pol))
    lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    logps.append(lp)
    fed.append(tok)
    ms.append(dt * 1e3)
    launches.append(n)
    routes |= log
    if forced is None:
      tok = lp.argmax(-1, keepdim=True)
    elif i + 1 < len(forced):
      tok = forced[i + 1]
  return logps, fed, ms, launches, routes


def check_decode(model, cfg, mem, want_step: dict, what: str,
                 steps: int) -> dict:
  """Teacher-forced decode under both policies: `want_step` launches each
  step under "cuda", none under "plain", log-probs within LM_SERVE_ATOL,
  argmax flips only at near-ties."""
  lp_p, fed, ms_p, n_p, routes_p = whisper_decode(model, cfg, mem, "plain",
                                                   steps)
  lp_k, fed_k, ms_k, n_k, routes = whisper_decode(model, cfg, mem, "cuda",
                                                  steps, forced=fed)
  for i, n in enumerate(n_k):
    only(n, want_step, f"{what} decode step {i}")
  for n in n_p:
    only(n, {}, f"{what} plain decode step")
  if any(r != "jnp" for _, r in routes_p):
    fail(f"{what}: plain routing {sorted(routes_p)}")
  max_diff, flips, flip_gap = 0.0, 0, 0.0
  for i, (a, b, ta, tb) in enumerate(zip(lp_k, lp_p, fed_k, fed)):
    if not torch.equal(ta, tb):
      fail(f"{what}: step {i} was fed other tokens")
    if a.shape != (WHISPER_BATCH, cfg.vocab_size) or \
        not bool(torch.isfinite(a).all()):
      fail(f"{what}: step {i} log-probs of the wrong shape or not finite")
    max_diff = max(max_diff, float((a - b).abs().max()))
    flip = a.argmax(-1) != b.argmax(-1)
    if bool(flip.any()):
      top2 = torch.topk(b[flip], 2, dim=-1).values
      gap = float((top2[:, 0] - top2[:, 1]).max())
      if gap >= LM_SERVE_ATOL:
        fail(f"{what}: argmax differs at step {i} at a top-2 gap of "
             f"{gap:.3g}")
      flips += int(flip.sum())
      flip_gap = max(flip_gap, gap)
  if max_diff > LM_SERVE_ATOL:
    fail(f"{what}: decode log-probs differ by {max_diff:.3g}")
  total = {k: sum(n[k] for n in n_k) for k in n_k[0]}
  return dict(launches=total, steps=steps, routes=sorted(routes),
              cuda_step_ms=statistics.median(ms_k[1:]),
              plain_step_ms=statistics.median(ms_p[1:]),
              max_logprob_diff=max_diff, argmax_flips=flips,
              flip_max_top2_gap=flip_gap)


def weighted_error(model, trunc, stats) -> float:
  """sum over the encoder's 72 layer GEMMs of tr((W - UV)^T C (W - UV)),
  C the layer's calibrated E[x x^T]: the activation-weighted output
  error E||xW - xUV||^2 that the calibrated truncation minimises; f64 on
  the card."""
  total = 0.0
  for path in WHISPER_ENC:
    dense, fact = _leaf(model.enc_layers, path), _leaf(trunc.enc_layers, path)
    cov = torch.from_numpy(stats[fact.name].second_moment).to("cuda")
    for i in range(dense.w.shape[0]):
      d = dense.w[i].double() - fact.u[i].double() @ fact.v[i].double()
      total += float((d * (cov[i] @ d)).sum())
  return total


def whisper_cases(model, trunc, quant_model, gen) -> list[dict]:
  """The phase's kernels at its shapes (layer 0 of each stacked leaf; the
  other layers have the same shapes), each row's `weight` its launches
  an encode or a decode step."""
  from repro_torch.kernels import ref
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.flash_attention import flash_attention
  from repro_torch.kernels.int8_gemm import int8_gemm
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  bf16, b = torch.bfloat16, WHISPER_BATCH
  rows_n = WHISPER_BATCH * WHISPER_FRAMES
  n_enc, n_dec = model.enc_layers.ln1.scale.shape[0], \
      model.dec_layers.ln1.scale.shape[0]
  cases = []
  h, d = 12, 64
  q, k, v = (randn((b, WHISPER_FRAMES, h, d), gen, bf16) for _ in range(3))
  qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
  cases.append(case(
      "flash_attention", f"whisper encoder non-causal ({b}, "
      f"{WHISPER_FRAMES}, {h}, {d})", b, bf16,
      lambda a=(q, k, v): flash_attention(*a, causal=False),
      lambda a=(q, k, v): ref.flash_attention(*a, causal=False),
      lambda a=(qt, kt, vt): F.scaled_dot_product_attention(*a),
      4 * b * WHISPER_FRAMES * h * d * 2,
      4 * b * h * d * WHISPER_FRAMES * WHISPER_FRAMES,
      path="whisper_encode", weight=n_enc, reps=20))
  for path in WHISPER_DEC_STEP:
    w = _leaf(model.dec_layers, path).w[0]
    m, n = w.shape
    x = randn((b, m), gen, bf16)
    cases.append(case("decode_matvec", f"whisper dec/{path} {m}x{n}", b, bf16,
                      lambda x=x, w=w: decode_matvec(x, w),
                      lambda x=x, w=w: ref.decode_matvec(x, w),
                      lambda x=x, w=w: torch.matmul(x, w),
                      2 * (b * m + m * n + b * n), 2 * b * m * n,
                      path="whisper_decode", weight=n_dec, cold=True))
  for path in WHISPER_ENC:
    leaf = _leaf(trunc.enc_layers, path)
    u, v = leaf.u[0], leaf.v[0]
    (m, r), n = u.shape, v.shape[1]
    x = randn((rows_n, m), gen, bf16)
    cases.append(case("lowrank_gemm", f"whisper enc/{path} {m}x{r}x{n}",
                      rows_n, bf16, lambda a=(x, u, v): lowrank_gemm(*a),
                      lambda a=(x, u, v): ref.lowrank_gemm(*a),
                      lambda x=x, u=u, v=v: torch.matmul(torch.matmul(x, u),
                                                         v),
                      2 * (rows_n * m + m * r + r * n + rows_n * n),
                      2 * rows_n * r * (m + n), path="whisper_lowrank",
                      weight=n_enc, reps=10))
  for path in WHISPER_ENC:
    leaf = _leaf(quant_model.enc_layers, path)
    wq, ws = leaf.w_q[0], leaf.w_scale[0]
    m, n = wq.shape
    xq, xs = ref.quantize_rowwise(randn((rows_n, m), gen, bf16))
    cases.append(case("int8_gemm", f"whisper enc/{path} {m}x{n}", rows_n,
                      torch.int8, lambda a=(xq, wq, xs, ws): int8_gemm(*a),
                      lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a), None,
                      rows_n * m + m * n + 4 * (rows_n + n + rows_n * n),
                      2 * rows_n * m * n, exact=True, path="whisper_int8",
                      weight=n_enc, reps=10,
                      yardstick=("int_mm", lambda a=xq, w=wq:
                                 torch._int_mm(a, w))))
  return cases


def check_whisper(card) -> tuple[dict, list[dict], dict]:
  """Full-width whisper-small: encode, decode, LiteASR-calibrated
  truncation and calibrated PTQ, each under both policies with exact
  launch counts; then the kernel rows at the phase's shapes. Returns
  (launches by path, kernel rows, summary)."""
  from repro_torch import configs
  from repro_torch.core.compress import (FactorizationPlan,
                                         compression_report, to_stage2)
  from repro_torch.core.svd import TruncationSpec
  from repro_torch.kernels import dispatch
  from repro_torch.models import whisper
  from repro_torch.quant import (QuantizedLinear, calibrate_activation_ranges,
                                 calibrate_activation_stats, quantize_params)
  cfg = configs.get_config("whisper-small").with_(
      attn_block_kv=WHISPER_BLOCK_KV)
  n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
  model = whisper.init_model(cfg, generator=torch.Generator(
      device="cuda").manual_seed(0), device="cuda")
  frames = whisper_frames(cfg, 0)
  by_path, out = {}, dict(whisper=cfg.name, card=card, streams=WHISPER_BATCH,
                          frames=WHISPER_FRAMES,
                          attn_block_kv=WHISPER_BLOCK_KV)
  # (a) encode, (b) decode
  enc = check_encode(model, cfg, frames, {"flash_attention": n_enc},
                     "whisper")
  mem = enc.pop("memory")
  by_path["whisper_encode"] = enc["launches"]
  dec = check_decode(model, cfg, mem,
                     {"decode_matvec": len(WHISPER_DEC_STEP) * n_dec},
                     "whisper", WHISPER_STEPS)
  by_path["whisper_decode"] = dec["launches"]
  out.update(encode=enc, decode=dec)
  # (c) LiteASR: calibrated truncation of the encoder
  batches = [frames] + [whisper_frames(cfg, i + 1)
                        for i in range(WHISPER_CALIB_BATCHES - 1)]

  def calib_fwd(f):
    return whisper.encode_unrolled(model, f, cfg, policy=dispatch.JNP_ONLY)
  t0 = time.perf_counter()
  stats = calibrate_activation_stats(calib_fwd, batches)
  calib_s = time.perf_counter() - t0
  want_keys = {f"enc/{g}" for g in ("attn_q", "attn_k", "attn_v", "attn_o",
                                    "ffn_in", "ffn_out")}
  if set(stats) != want_keys or any(
      st.second_moment.shape[0] != n_enc for st in stats.values()):
    fail(f"whisper calibration: stats keys {sorted(stats)}")
  plan = FactorizationPlan(include=("enc/*",), truncation=TruncationSpec(
      fixed_rank=WHISPER_RANK))
  t0 = time.perf_counter()
  trunc = to_stage2(model, plan, calib=stats)
  trunc_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  spectral = to_stage2(model, plan)
  spectral_s = time.perf_counter() - t0
  err_cal = weighted_error(model, trunc, stats)
  err_spec = weighted_error(model, spectral, stats)
  if not err_cal <= err_spec:
    fail(f"whisper: calibrated truncation's weighted error {err_cal:.6g} > "
         f"the spectrum-only one's {err_spec:.6g}")
  del spectral
  report = compression_report(model, trunc, calib=stats)
  tenc = check_encode(trunc, cfg, frames, {"flash_attention": n_enc,
                                           "lowrank_gemm": 6 * n_enc},
                      "whisper truncated")
  tenc.pop("memory")
  by_path["whisper_truncated_encode"] = tenc["launches"]
  out["calibrated_truncation"] = dict(
      rank=WHISPER_RANK, calibration_batches=len(batches),
      calibrate_s=calib_s, to_stage2_calibrated_s=trunc_s,
      to_stage2_spectrum_s=spectral_s, weighted_error_calibrated=err_cal,
      weighted_error_spectrum=err_spec,
      error_ratio=err_cal / err_spec if err_spec else None,
      total_params_before=report["total_params_before"],
      total_params_after=report["total_params_after"],
      calibrated_gemms=report["calibrated_gemms"], encode=tenc)
  # (d) calibrated PTQ
  t0 = time.perf_counter()
  ranges = calibrate_activation_ranges(calib_fwd, batches)
  ranges_s = time.perf_counter() - t0
  qmodel = quantize_params(model, calib=ranges)
  leaves = [m for m in qmodel.modules() if isinstance(m, QuantizedLinear)]
  static = {m.name for m in leaves if m.act_scale is not None}
  if static != want_keys or len(leaves) != 16:
    fail(f"whisper PTQ: static scales on {sorted(static)} of "
         f"{len(leaves)} leaves")
  qenc = check_encode(qmodel, cfg, frames, {"flash_attention": n_enc,
                                            "int8_gemm": 6 * n_enc},
                      "whisper PTQ")
  qmem = qenc.pop("memory")
  qdec = check_decode(qmodel, cfg, qmem, {"int8_gemm": 10 * n_dec},
                      "whisper PTQ", WHISPER_PTQ_STEPS)
  by_path["whisper_ptq"] = {k: qenc["launches"][k] + qdec["launches"][k]
                            for k in qenc["launches"]}
  out["calibrated_ptq"] = dict(calibrate_s=ranges_s, encode=qenc,
                               decode=qdec)
  print(json.dumps(out), flush=True)
  del mem, qmem
  rows = check_cases(whisper_cases(model, trunc, qmodel,
                                   torch.Generator().manual_seed(7)))
  del model, trunc, qmodel
  gc.collect()
  torch.cuda.empty_cache()
  return by_path, rows, out


# ---------------------------------------------------------------------------
# Phase 11: DeepSeek — MLA and the capacity-routed MoE, served through
# decode_matvec, trained through both stages and served through
# lowrank_gemm.
# ---------------------------------------------------------------------------

def ds_prefill_gemms(cfg) -> set:
  """The logical names of a DeepSeek prefill's GEMMs below the head."""
  q = ("mla_q_a", "mla_q_b") if cfg.mla.q_lora_rank else ("mla_q",)
  names = {f"layers/{n}" for n in q + ("mla_dkv", "mla_uk", "mla_uv",
                                       "mla_o")}
  names |= {f"layers/{p}ffn_{g}" for p in ("", "shared/")
            for g in ("gate", "up", "down")}
  return names


def window_tokens(n_moe: int, batch: int, prompt_len: int, steps: int):
  """`first_route_flips`' token map of a decode_window prefill of
  `prompt_len` tokens a row followed by `steps` decode steps: entry i is
  MoE layer i % n_moe of call i // n_moe; row r is sequence r."""
  def tokens_of(i):
    call, layer = divmod(i, n_moe)
    if call == 0:
      return layer, [(r, p) for r in range(batch) for p in range(prompt_len)]
    return layer, [(r, prompt_len + call - 1) for r in range(batch)]
  return tokens_of


def ds_teacher_forced(lm, cfg, card, prompt_len: int, steps: int,
                      exact_routes: bool, atol: float, what: str) -> dict:
  """SERVE_BATCH seeded prompts of `prompt_len` tokens prefilled through
  one `decode_window` (which fills the latent cache), then `steps` decode
  steps, under "plain" and then under "cuda" fed the plain run's greedy
  tokens, both under the route log. The decode steps must launch exactly
  the decode_matvec calls `step_leaves` counts (none under "plain");
  the prefill's (b * prompt_len)-row GEMMs stay plain. Routes are
  identical (`exact_routes`; then log-probs agree within `atol` at every
  call), or differ only by first differences at near-ties
  (`first_route_flips`; then log-probs agree within `atol` up to a
  sequence's first flip, and a third run, "cuda" replaying the plain
  run's routes (`moe.replay_routes`), agrees within `atol` at every
  call)."""
  from repro_torch.kernels import dispatch, ops
  from repro_torch.layers import moe
  from repro_torch.models import transformer as tf
  b = SERVE_BATCH
  n_moe = tf.depths(cfg)[1]
  per_step = sum(w for _, _, w in step_leaves(lm, cfg))
  prompts = torch.from_numpy(np.random.RandomState(3).randint(
      1, cfg.vocab_size, size=(b, prompt_len))).to("cuda")
  runs, forced = {}, None
  for name in ("plain", "cuda") + (() if exact_routes else ("replayed",)):
    policy = "plain" if name == "plain" else "cuda"
    pol = dispatch.resolve_policy(policy, b)
    state = tf.init_decode_state(cfg, b, prompt_len + steps, device="cuda")
    lps, toks = [], []
    replay = (moe.replay_routes(runs["plain"]["routes"])
              if name == "replayed" else contextlib.nullcontext())
    with moe.record_routes() as routes, replay:
      torch.cuda.synchronize()
      ops.reset_launches()
      t0 = time.perf_counter()
      logits, state = tf.decode_window(
          lm, state, prompts, torch.zeros(b, dtype=torch.int64,
                                          device="cuda"), cfg, pol)
      torch.cuda.synchronize()
      prefill_s = time.perf_counter() - t0
      prefill_launches = dict(ops.LAUNCHES)
      lps.append(torch.log_softmax(logits[:, -1].float(), -1))
      ops.reset_launches()
      t0 = time.perf_counter()
      for t in range(steps):
        tok = (lps[-1].argmax(-1) if forced is None else forced[t])
        toks.append(tok)
        pos = torch.full((b,), prompt_len + t, dtype=torch.int64,
                         device="cuda")
        logits, state = tf.decode_step(lm, state, tok.view(b, 1), pos, cfg,
                                       pol)
        lps.append(torch.log_softmax(logits[:, -1].float(), -1))
      torch.cuda.synchronize()
      step_s = (time.perf_counter() - t0) / steps
      launches = dict(ops.LAUNCHES)
    runs[name] = dict(lps=lps, routes=routes, prefill_s=prefill_s,
                      step_ms=step_s * 1e3, launches=launches,
                      prefill_launches=prefill_launches)
    forced = forced or toks
    del state
  p, k = runs["plain"], runs["cuda"]
  for name, got in (("plain prefill", p["prefill_launches"]),
                    ("plain steps", p["launches"]),
                    ("cuda prefill", k["prefill_launches"])):
    if any(got.values()):
      fail(f"{what}: the {name} launched {got}")
  want = {n: per_step * steps if n == "decode_matvec" else 0
          for n in k["launches"]}
  if k["launches"] != want:
    fail(f"{what}: launches {k['launches']} != {want}")
  tokens_of = window_tokens(n_moe, b, prompt_len, steps)
  if exact_routes:
    for i, (ep, ek) in enumerate(zip(p["routes"], k["routes"])):
      if not np.array_equal(np.sort(ep["experts"], -1),
                            np.sort(ek["experts"], -1)):
        fail(f"{what}: routes differ in MoE call {i}")
    route_stats = dict(routed_tokens=sum(len(e["experts"])
                                         for e in p["routes"]),
                       route_flips=0,
                       router_drift=router_drift(p["routes"], k["routes"],
                                                 tokens_of, what))
    first_pos = {}
  else:
    route_stats, first_pos = first_route_flips(p["routes"], k["routes"],
                                               tokens_of)
  for i, a in enumerate(k["lps"]):
    if a.shape != (b, cfg.vocab_size):
      fail(f"{what}: call {i}: log-probs of shape {tuple(a.shape)}")
  held = [torch.tensor([not (r in first_pos and first_pos[r] <= prompt_len
                             - 1 + i) for r in range(b)], device="cuda")
          for i in range(steps + 1)]
  lp_stats = compare_logprobs(
      ((i, a, c, h) for i, (a, c, h) in enumerate(zip(k["lps"], p["lps"],
                                                      held))), atol, what)
  if not exact_routes:
    r = runs["replayed"]
    if r["launches"] != want:
      fail(f"{what}: replayed launches {r['launches']} != {want}")
    every = torch.ones(b, dtype=torch.bool, device="cuda")
    replayed = compare_logprobs(
        ((i, a, c, every) for i, (a, c) in enumerate(zip(r["lps"],
                                                         p["lps"]))),
        atol, f"{what} (routes replayed)")
    lp_stats["replayed"] = {key: replayed[key] for key in (
        "max_logprob_diff", "rows_held", "argmax_flips",
        "flip_max_top2_gap")}
    route_stats["router_drift"] = router_drift(
        p["routes"], r["routes"], tokens_of, f"{what} (replayed)")
  out = dict(
      teacher_forced=what, card=card, dtype=str(cfg.dtype),
      layers=cfg.num_layers, batch=b, prompt_len=prompt_len, steps=steps,
      launches_a_step=per_step, launches=k["launches"],
      cuda_prefill_s=k["prefill_s"], plain_prefill_s=p["prefill_s"],
      cuda_step_ms=k["step_ms"], plain_step_ms=p["step_ms"],
      min_logit_gap=float(min(e["logit_gap"].min() for e in p["routes"])),
      **lp_stats, **route_stats)
  print(json.dumps(out), flush=True)
  return out


def free() -> None:
  gc.collect()
  torch.cuda.empty_cache()


def check_ds_training(card) -> tuple[dict, list[dict], dict]:
  """Full-width deepseek-v2-lite cut to DS_TRAIN_LAYERS layers (1 dense +
  1 MoE), bf16, trained TRAIN_STEPS steps of `data/lm.py` batches through
  both stages (every GEMM of at least 32 wide factored, the expert stacks
  included; transition at TRAIN_TRANSITION), then frozen and served
  through LMEngine with every GEMM through lowrank_gemm. Returns (the
  serving run's launches, the kernel rows, the training summary)."""
  from repro_torch import configs
  from repro_torch.core.factored import count_params, frozen, \
      iter_factored_leaves
  cfg = configs.get_config(DS_ARCH).with_(num_layers=DS_TRAIN_LAYERS)
  ckpt = ROOT / "build" / "ds_train_ckpt"
  shutil.rmtree(ckpt, ignore_errors=True)
  t0 = time.perf_counter()
  tr = make_trainer(cfg, "cuda", ckpt,
                    generator=torch.Generator(device="cuda").manual_seed(0))
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  dense_params = dense_param_count(tr.params)
  steps = []
  for i in range(TRAIN_STEPS):
    if i == TRAIN_TRANSITION:
      params_before = count_params(tr.params)
    t0 = time.perf_counter()
    steps.append(tr.train_step(train_batch(cfg, i)))
    torch.cuda.synchronize()
    steps[-1]["call_s"] = time.perf_counter() - t0
  params_after = count_params(tr.params)
  losses = [m["loss"] for m in steps]
  if not all(math.isfinite(x) for x in losses + [m["moe_aux"]
                                                  for m in steps]):
    fail(f"{cfg.name} training: non-finite loss {losses}")
  stages = [m["stage"] for m in steps]
  if stages != [1] * TRAIN_TRANSITION + [2] * (TRAIN_STEPS - TRAIN_TRANSITION):
    fail(f"{cfg.name} training: stages {stages}")
  if not params_after < params_before:
    fail(f"{cfg.name} training: {params_after} params after the "
         f"transition, {params_before} before")
  ranks = {}
  for leaf in iter_factored_leaves(tr.params):
    if not leaf.is_factored or leaf.rank % 8 or \
        leaf.rank > min(leaf.in_dim, leaf.out_dim):
      fail(f"{cfg.name} training: leaf {leaf.name} rank "
           f"{leaf.rank if leaf.is_factored else None}")
    ranks[leaf.name] = leaf.rank
  if "layers/expert_gate" not in ranks:
    fail(f"{cfg.name} training: the expert stacks were not factored")
  median_ms = {f"stage{s}": statistics.median(
      m["wall_s"] * 1e3 for i, m in enumerate(steps)
      if m["stage"] == s and i not in (0, TRAIN_TRANSITION))
      for s in (1, 2)}
  transition_ms = (steps[TRAIN_TRANSITION]["call_s"]
                   - steps[TRAIN_TRANSITION]["wall_s"]) * 1e3
  summary = dict(
      train=cfg.name, card=card, layers=cfg.num_layers,
      batch=[LM_TRAIN_BATCH, LM_TRAIN_SEQ], remat=cfg.remat,
      steps=TRAIN_STEPS, transition_step=TRAIN_TRANSITION, init_s=init_s,
      losses=losses, xent=[m["xent"] for m in steps],
      moe_aux=[m["moe_aux"] for m in steps], stages=stages,
      wall_ms=[m["wall_s"] * 1e3 for m in steps],
      median_step_ms=median_ms, transition_ms=transition_ms,
      dense_params=dense_params, stage1_params=params_before,
      stage2_params=params_after,
      stage2_over_dense=params_after / dense_params, ranks=ranks,
      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
  print(json.dumps(summary), flush=True)
  fact = frozen(copy.deepcopy(tr.params))
  del tr
  free()
  for name, leaf, _ in step_leaves(fact, cfg):
    if not leaf.is_factored or min(leaf.u.shape[-2], leaf.rank,
                                   leaf.v.shape[-1]) < 128:
      fail(f"{cfg.name} trained: {name} would not reach lowrank_gemm")
  rows = check_cases(lowrank_cases(step_leaves(fact, cfg),
                                   torch.Generator().manual_seed(8),
                                   "ds_trained", f"trained {cfg.name} "))
  launches = check_lm_serving(fact, cfg, card, kernel="lowrank_gemm")
  del fact
  free()
  return launches, rows, summary


def ds_profiles(lm, cfg, card) -> dict:
  """Where a DeepSeek step's time goes (`profile_paths`), beside the
  routed experts' weight bytes a step (every expert at its 8 slots) and
  their bound."""
  from repro_torch.models.transformer import depths
  m = cfg.moe
  experts = depths(cfg)[1] * 3 * m.num_experts * cfg.d_model * \
      m.d_expert * cfg.dtype.itemsize
  out = dict(ds_profile=cfg.name, card=card, layers=cfg.num_layers,
             **profile_paths(lm, cfg, "ds"), routed_expert_bytes=experts,
             routed_expert_bound_ms=experts / HBM_BYTES_PER_S * 1e3)
  print(json.dumps(out), flush=True)
  return out


def check_deepseek(card) -> tuple[dict, list[dict]]:
  """Phase 11. Returns (launches by path, kernel rows)."""
  from repro_torch import configs
  from repro_torch.models.transformer import depths
  by_path, rows = {}, []
  v2 = configs.get_config(DS_ARCH)
  # (b) f32 at full width, depth cut: routes identical
  cfg = v2.with_(num_layers=DS_F32_LAYERS, dtype=torch.float32)
  lm = build_lm(cfg)
  f32 = ds_teacher_forced(lm, cfg, card, DS_F32_PREFILL, DS_F32_STEPS,
                          exact_routes=True, atol=DS_F32_ATOL,
                          what=f"{cfg.name} f32 {DS_F32_LAYERS} layers")
  by_path["ds_f32"] = f32["launches"]
  del lm
  free()
  # (a), (c) DS_LAYERS layers in bf16
  v2 = v2.with_(num_layers=DS_LAYERS)
  lm = build_lm(v2)
  if depths(v2) != (1, DS_LAYERS - 1):
    fail(f"{v2.name}: stacks {depths(v2)}")
  rows += check_cases(decode_cases(step_leaves(lm, v2),
                                   torch.Generator().manual_seed(9),
                                   "ds_decode", f"{v2.name} "))
  by_path["ds_prefill"] = check_prefill(lm, v2, card,
                                        ds_prefill_gemms(v2), flash=False)
  by_path["ds_serving"] = check_lm_serving(lm, v2, card)
  ds_profiles(lm, v2, card)
  del lm
  free()
  # (d) training
  check_training_card_vs_cpu(card, DS3_ARCH)
  by_path["ds_trained_serving"], trained_rows, _ = check_ds_training(card)
  rows += trained_rows
  # (e) deepseek-v3 at full width, depth cut
  v3 = configs.get_config(DS3_ARCH).with_(num_layers=DS3_LAYERS)
  lm = build_lm(v3)
  if depths(v3) != (3, 1) or lm.mtp is None:
    fail(f"{v3.name}: stacks {depths(v3)}, MTP head {lm.mtp is not None}")
  rows += check_cases(decode_cases(step_leaves(lm, v3),
                                   torch.Generator().manual_seed(10),
                                   "ds3_decode", f"{v3.name} "))
  v3_run = ds_teacher_forced(lm, v3, card, DS3_PREFILL, DS3_STEPS,
                             exact_routes=False, atol=LM_SERVE_ATOL,
                             what=f"{v3.name} bf16 {DS3_LAYERS} layers")
  by_path["ds3_teacher_forced"] = v3_run["launches"]
  del lm
  free()
  return by_path, rows


# ---------------------------------------------------------------------------
# Phase 12: zamba2-7b, the first carry LM family — the shared block's
# prefill through flash_attention at head width 112, the decode step
# through decode_matvec, the recipe and the draft through lowrank_gemm,
# the speculative engine's carry rewind.
# ---------------------------------------------------------------------------

def build_zamba(cfg):
  from repro_torch.models.zamba import init_lm
  gen = torch.Generator(device="cuda").manual_seed(0)
  return init_lm(cfg, generator=gen, device="cuda")


def zamba_step_leaves(lm, cfg) -> list[tuple]:
  """(logical name, a 2-D leaf, launches a decode step) of every GEMM a
  zamba decode step routes through `gemm`: each Mamba2 block's in_zx,
  in_bcdt and out_proj (every layer, main and tail), the shared block's
  q, k, v, o and SwiGLU (once a group), and the head."""
  from repro_torch.models.zamba import _plan
  groups = _plan(cfg)[1]
  lp, sp = lm.main.layers()[0][0], lm.shared_attn.view()
  out = [(f"mamba/ssm_{n}", lp[k], cfg.num_layers) for n, k in (
      ("in_zx", "in_zx"), ("in_bcdt", "in_bcdt"), ("out", "out_proj"))]
  out += [(f"shared/attn_{k[1:]}", sp["attn"][k], groups)
          for k in ("wq", "wk", "wv", "wo")]
  out += [(f"shared/ffn_{g}", sp["ffn"][f"w_{g}"], groups)
          for g in ("gate", "up", "down")]
  out.append(("lm_head", lm.embedding.head, 1))
  return out


def f32_copy(lm, cfg):
  """An f32 copy of a model on the card (the same weights, widened) and
  its config."""
  return copy.deepcopy(lm).float(), cfg.with_(dtype=torch.float32)


def zamba_carries(state: dict, carry: dict) -> list:
  """The carry leaves of a zamba decode state, in a fixed order."""
  return [state[k][n] for k, leaves in carry.items()
          for n, c in leaves.items() if c]


def check_replay(eng, cfg, card) -> dict:
  """The speculative engine's masked replay on the card: 4 prompts of 8
  tokens prefilled at batch 4, then the next SPEC_K + 1 tokens replayed
  with accepted lengths 1, 2, 3 and 4 (one a slot) from a copy of that
  state, against the SPEC_K + 1 steps they stand for: every slot's
  carries must be the steps' own after its accepted length, bit for bit
  (the same steps at the same shapes; the replay only keeps rows)."""
  api, dev = eng.api, eng.device
  rng = np.random.RandomState(5)
  toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, size=(
      SERVE_BATCH, 8 + SPEC_K + 1))).to(dev)
  state = api.init_decode_state(cfg, SERVE_BATCH, 64, device=dev)
  pos = torch.zeros(SERVE_BATCH, dtype=torch.int64, device=dev)
  for t in range(8):
    _, state = eng._step(state, toks[:, t:t + 1], pos + t)
  window = toks[:, 8:]
  steps, after = clone_state(state), []
  for t in range(SPEC_K + 1):
    _, steps = eng._step(steps, window[:, t:t + 1], pos + 8 + t)
    after.append([x.clone() for x in zamba_carries(steps, eng._carry)])
  commit = np.arange(1, SERVE_BATCH + 1) % (SPEC_K + 1)
  commit[commit == 0] = SPEC_K + 1
  got = eng._replay(eng._step, clone_state(state), window, commit, pos + 8)
  axes = [eng._axes[k][n] for k, leaves in eng._carry.items()
          for n, c in leaves.items() if c]
  for i, c in enumerate(commit):
    for ax, g, w in zip(axes, zamba_carries(got, eng._carry),
                        after[c - 1]):
      if not torch.equal(g.select(ax, i), w.select(ax, i)):
        diff = float((g.select(ax, i).float()
                      - w.select(ax, i).float()).abs().max())
        fail(f"{cfg.name} replay: slot {i} (accepted {c}) differs from "
             f"its steps by {diff:.3g}")
  out = dict(replay_vs_steps=cfg.name, card=card, accepted=commit.tolist(),
             carry_leaves=len(axes), equal=True)
  print(json.dumps(out), flush=True)
  return out


def shrink_residuals(lm, draft, alpha: float, leaves: int) -> None:
  """Each GEMM leaf W of `lm` becomes UV + alpha (W - UV), UV its
  truncation in `draft`. A random weight's spectrum is flat, so a
  rank-128 draft of a 3584-wide random model keeps a few percent of it
  and agrees with its target on no greedy token (every window then
  commits 1 in every slot, and the engine's per-slot replay never runs);
  a trained weight's spectrum decays. W - UV lies outside UV's singular
  subspaces, so UV is still the new weight's rank-128 truncation: the
  draft is unchanged, and `alpha` sets how far it is from its target.
  `leaves`: the draft's factored leaves (a leaf the draft shares with
  its target stays as it is)."""
  from repro_torch.core.factored import iter_factored_leaves
  pairs = [(t, d) for t, d in zip(iter_factored_leaves(lm),
                                  iter_factored_leaves(draft))
           if d.is_factored]
  if len(pairs) != leaves or any(t.name != d.name or t.is_factored
                                 for t, d in pairs):
    fail(f"shrink_residuals: leaves {[(t.name, d.name) for t, d in pairs]}")
  with torch.no_grad():
    for t, d in pairs:
      t.w.mul_(alpha).add_(torch.matmul(d.u, d.v), alpha=1.0 - alpha)


def check_cut_speculative(card, cfg, build, leaves_fn, n_factored: int,
                          shared: tuple, residual: float, seed: int
                          ) -> tuple[dict, list[dict], dict]:
  """A full-width config cut in depth (`cfg`: zamba2-7b's, xlstm-350m's),
  built by `build`: the rank-128 draft built on the card (timed; exactly
  `n_factored` GEMM leaves factored, each at DRAFT_RANK; the state-dict
  entries `shared` names (the norms, the embedding, an SSM leaf, a bias,
  a GEMM below the 128-lane gate) the target's own storage; the target
  left unfactored), `lowrank_gemm` held and timed at the draft step's
  shapes (`leaves_fn`) in bf16, then, in f32 (the target and its draft
  widened: speculative greedy is held to vanilla greedy's tokens, which
  bf16 rounding would decorrelate, see F32_LOGPROB_ATOL), the masked
  replay against its steps (`check_replay`), the target's residuals
  shrunk to `residual` (`shrink_residuals`) and `run_speculative`
  (greedy, every call's launches exact, at least one masked replay: the
  carry branch). Kernel rows take the path "{family}_draft". Returns
  (launches, rows, summary)."""
  from repro_torch.core.factored import count_params, iter_factored_leaves
  from repro_torch.serving.speculative import make_draft_params
  lm = build(cfg)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  draft = make_draft_params(lm, rank=DRAFT_RANK)
  torch.cuda.synchronize()
  build_s = time.perf_counter() - t0
  fact = [lf for lf in iter_factored_leaves(draft) if lf.is_factored]
  if len(fact) != n_factored or any(lf.rank != DRAFT_RANK for lf in fact):
    fail(f"{cfg.name} draft: leaves {[(lf.name, lf.rank) for lf in fact]}")
  if any(lf.is_factored for lf in iter_factored_leaves(lm)):
    fail(f"{cfg.name} draft: building it factored the target")
  dsd, tsd = draft.state_dict(), lm.state_dict()
  if any(dsd[k].data_ptr() != tsd[k].data_ptr() for k in shared):
    fail(f"{cfg.name} draft: one of {shared} is a copy, not the target's")
  built = dict(draft=cfg.name, card=card, layers=cfg.num_layers,
               rank=DRAFT_RANK, build_s=build_s,
               draft_params=count_params(draft),
               target_params=count_params(lm))
  print(json.dumps(built), flush=True)
  rows = check_cases(lowrank_cases(leaves_fn(draft, cfg),
                                   torch.Generator().manual_seed(seed),
                                   f"{cfg.family}_draft", f"{cfg.name} draft "))
  lm, cfg = f32_copy(lm, cfg)
  draft = copy.deepcopy(draft).float()
  check_replay(spec_engine(lm, cfg, draft, "cuda"), cfg, card)
  shrink_residuals(lm, draft, residual, n_factored)
  launches, summary = run_speculative(lm, cfg, card, draft, built)
  summary["residual_scale"] = residual
  del lm, draft
  free()
  return launches, rows, summary


def check_cut_training(cfg, card, path: str, seed: int
                       ) -> tuple[dict, list[dict], dict]:
  """A full-width config cut in depth (`cfg`: zamba2-7b's, xlstm-350m's),
  bf16, trained TRAIN_STEPS steps of `data/lm.py` batches through both
  stages as phase 9 (one step a stage under torch.profiler), then frozen
  and served through LMEngine with every step GEMM through lowrank_gemm,
  the policies compared on an f32 copy. Kernel rows take `path`.
  Returns (the serving run's launches, the kernel rows, the training
  summary)."""
  from repro_torch.core.factored import count_params, frozen, \
      iter_factored_leaves
  ckpt = ROOT / "build" / f"{path}_train_ckpt"
  shutil.rmtree(ckpt, ignore_errors=True)
  t0 = time.perf_counter()
  tr = make_trainer(cfg, "cuda", ckpt,
                    generator=torch.Generator(device="cuda").manual_seed(0))
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  dense_params = dense_param_count(tr.params)
  steps, profiles = [], {}
  for i in range(TRAIN_STEPS):
    batch = train_batch(cfg, i)
    if i == TRAIN_TRANSITION:
      params_before = count_params(tr.params)
    t0 = time.perf_counter()
    if i in (1, TRAIN_TRANSITION + 1):      # one profiled step a stage
      profiles[f"stage{tr.stage}"] = profile_step(
          lambda b=batch: steps.append(tr.train_step(b)),
          f"{path}_train_step{i}")
    else:
      steps.append(tr.train_step(batch))
    torch.cuda.synchronize()
    steps[-1]["call_s"] = time.perf_counter() - t0
  params_after = count_params(tr.params)
  losses = [m["loss"] for m in steps]
  if not all(math.isfinite(x) for x in losses):
    fail(f"{cfg.name} training: non-finite loss {losses}")
  stages = [m["stage"] for m in steps]
  if stages != [1] * TRAIN_TRANSITION + [2] * (TRAIN_STEPS - TRAIN_TRANSITION):
    fail(f"{cfg.name} training: stages {stages}")
  if not params_after < params_before:
    fail(f"{cfg.name} training: {params_after} params after the "
         f"transition, {params_before} before")
  ranks = {}
  for leaf in iter_factored_leaves(tr.params):
    if not tr.plan.matches(leaf) and not leaf.is_factored:
      continue                  # below the plan's min_dim: kept dense
    if not leaf.is_factored or leaf.rank % 8 or \
        leaf.rank > min(leaf.in_dim, leaf.out_dim):
      fail(f"{cfg.name} training: leaf {leaf.name} rank "
           f"{leaf.rank if leaf.is_factored else None}")
    ranks[leaf.name] = max(leaf.rank, ranks.get(leaf.name, 0))
  median_ms = {f"stage{s}": statistics.median(
      m["wall_s"] * 1e3 for i, m in enumerate(steps)
      if m["stage"] == s and i not in (0, 1, TRAIN_TRANSITION,
                                       TRAIN_TRANSITION + 1))
      for s in (1, 2)}
  for s, prof in profiles.items():     # idle share of an unprofiled step
    prof["device_idle_share"] = 1.0 - prof["device_kernel_ms"] / median_ms[s]
  transition_ms = (steps[TRAIN_TRANSITION]["call_s"]
                   - steps[TRAIN_TRANSITION]["wall_s"]) * 1e3
  summary = dict(
      train=cfg.name, card=card, layers=cfg.num_layers,
      batch=[LM_TRAIN_BATCH, LM_TRAIN_SEQ], steps=TRAIN_STEPS,
      transition_step=TRAIN_TRANSITION, init_s=init_s, losses=losses,
      stages=stages, wall_ms=[m["wall_s"] * 1e3 for m in steps],
      median_step_ms=median_ms, transition_ms=transition_ms,
      dense_params=dense_params, stage1_params=params_before,
      stage2_params=params_after,
      stage2_over_dense=params_after / dense_params, ranks=ranks,
      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
      profiles=profiles)
  print(json.dumps(summary), flush=True)
  fact = frozen(copy.deepcopy(tr.params))
  del tr
  free()
  leaves = step_leaves(fact, cfg)
  for name, leaf, _ in leaves:
    if not leaf.is_factored or min(leaf.u.shape[-2], leaf.rank,
                                   leaf.v.shape[-1]) < 128:
      fail(f"{cfg.name} trained: {name} would not reach lowrank_gemm")
  rows = check_cases(lowrank_cases(leaves, torch.Generator().manual_seed(seed),
                                   f"{path}_trained", f"trained {cfg.name} "))
  launches = check_lm_serving(fact, cfg, card, "lowrank_gemm",
                              compare=f32_copy(fact, cfg))
  del fact
  free()
  return launches, rows, summary


def check_zamba(card) -> tuple[dict, list[dict]]:
  """Phase 12. Returns (launches by path, kernel rows)."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch
  from repro_torch.layers import mamba2 as m2
  from repro_torch.models import zamba
  by_path, rows = {}, []
  cfg = configs.get_config(ZAMBA_ARCH).with_(num_layers=ZAMBA_LAYERS)
  k, groups, tail = zamba._plan(cfg)
  if cfg.resolved_head_dim != 112 or (k, groups, tail) != (6, 4, 3):
    fail(f"{cfg.name}: head width {cfg.resolved_head_dim}, plan "
         f"{(k, groups, tail)}")
  # (a) ZAMBA_LAYERS layers in bf16: decode_matvec at the decode step's
  # shapes, its launches a step counted from `classify`
  lm = build_zamba(cfg)
  leaves = zamba_step_leaves(lm, cfg)
  pol = dispatch.resolve_policy("cuda", SERVE_BATCH)
  per_step = 0
  for name, leaf, weight in leaves:
    x = torch.zeros((SERVE_BATCH, leaf.in_dim), dtype=cfg.dtype,
                    device="cuda")
    if dispatch.classify(leaf, x, pol, name) != "decode_matvec":
      fail(f"{cfg.name}: {name} does not classify to decode_matvec")
    per_step += weight
  if per_step != 3 * ZAMBA_LAYERS + 7 * groups + 1:
    fail(f"{cfg.name}: {per_step} decode_matvec launches a step")
  rows += check_cases(decode_cases(leaves, torch.Generator().manual_seed(11),
                                   "zamba_decode", f"{cfg.name} "))
  # (b) the 4096-token prefill: one flash launch a group and the head,
  # each flash call held in place, the policies' log-probs compared on an
  # f32 copy, the residual stream's drift after each group and the tail;
  # (c) LMEngine, compared likewise
  lm32 = f32_copy(lm, cfg)
  by_path["zamba_prefill"] = check_prefill(
      lm, cfg, card, set(ZAMBA_GEMMS), compare=lm32,
      drift=(zamba, "_mamba_scan"))
  by_path["zamba_serving"] = check_lm_serving(lm, cfg, card, compare=lm32)
  del lm32
  free()
  gen = torch.Generator().manual_seed(12)
  heads = 2 * cfg.d_model // m2.HEAD_DIM
  x = randn((1, PREFILL_LEN, heads, m2.HEAD_DIM), gen, torch.bfloat16)
  dt = F.softplus(randn((1, PREFILL_LEN, heads), gen, torch.float32))
  A = -torch.ones(heads, device="cuda")
  B, C = (randn((1, PREFILL_LEN, cfg.ssm_state), gen, torch.bfloat16)
          for _ in range(2))
  one = time_ms(lambda: m2.ssd_chunked(x, dt, A, B, C), reps=5)
  prof = profile_paths(lm, cfg, "zamba", mark=(m2, "ssd_chunked"))
  if prof["prefill"]["marked_calls"] != cfg.num_layers:
    fail(f"{cfg.name} prefill profile: {prof['prefill']['marked_calls']} "
         f"ssd_chunked ranges, not {cfg.num_layers}")
  print(json.dumps(dict(zamba_profile=cfg.name, card=card,
                        layers=cfg.num_layers, **prof, ssd_one_layer_ms=one,
                        ssd_all_layers_ms=one * cfg.num_layers)), flush=True)
  del lm
  free()
  # (e) the self-speculative engine on the depth-cut model: one group and
  # one tail layer
  cut = configs.get_config(ZAMBA_ARCH).with_(num_layers=ZAMBA_CUT_LAYERS)
  if zamba._plan(cut) != (6, 1, 1):
    fail(f"{cut.name} cut to {cut.num_layers} layers: plan "
         f"{zamba._plan(cut)}")
  by_path["zamba_speculative"], spec_rows, _ = check_cut_speculative(
      card, cut, build_zamba, zamba_step_leaves, 14,
      ("embedding.table", "final_norm", "main.A_log", "tail.conv_w",
       "shared_attn.ln1"), ZAMBA_SPEC_RESIDUAL, 13)
  rows += spec_rows
  # (d) the two-stage recipe at the depth cut
  check_training_card_vs_cpu(card, ZAMBA_ARCH, ZAMBA_UPDATE_RTOL)
  by_path["zamba_trained_serving"], trained_rows, _ = check_cut_training(
      cut, card, "zamba", 14)
  rows += trained_rows
  return by_path, rows


# ---------------------------------------------------------------------------
# Phase 13: xlstm-350m — mLSTM's chunked matrix memory and sLSTM's per-head
# recurrence, the recurrent GEMM through decode_matvec (and lowrank_gemm)
# on f32 activations over bf16 weights; then the prefix cache.
# ---------------------------------------------------------------------------

def build_xlstm(cfg):
  from repro_torch.models.xlstm_model import init_lm
  gen = torch.Generator(device="cuda").manual_seed(0)
  return init_lm(cfg, generator=gen, device="cuda")


def xlstm_step_leaves(lm, cfg) -> list[tuple]:
  """(logical name, a 2-D leaf, launches a decode step) of every GEMM an
  xlstm decode step routes to a kernel: each pair's mLSTM up, qkv and
  down, the sLSTM's wx and out, its recurrent kernel head by head (f32
  activations, `act_dtype`), and the head. The mLSTM's gate projection
  (2 di, 2 heads) stays plain (`plain_gemms`)."""
  n = cfg.num_layers // 2
  lp = lm.pairs.layers()[0]
  m, s = lp["mlstm"], lp["slstm"]
  out = [(f"pairs/mlstm_{k}", m[k], n) for k in ("up", "qkv", "down")]
  out += [("pairs/slstm_nonrec", s["wx"], n), ("pairs/slstm_out", s["out"], n),
          (XLSTM_REC, s["rh"].layer(0), n * cfg.num_heads),
          ("lm_head", lm.embedding.head, 1)]
  return out


def prefix_requests(cfg) -> list:
  """2 x SERVE_BATCH requests, six of them opening with one shared
  template of PREFIX_TEMPLATE tokens (fleet traffic), each with a suffix
  of 4..8 tokens and a budget of 2..8."""
  rng = np.random.RandomState(7)
  template = rng.randint(1, cfg.vocab_size, size=(PREFIX_TEMPLATE,))
  reqs = []
  for i in range(2 * SERVE_BATCH):
    tail = rng.randint(1, cfg.vocab_size, size=(rng.randint(4, 9),))
    prompt = tail if i % 4 == 3 else np.concatenate([template, tail])
    reqs.append((prompt, int(rng.randint(2, 9))))
  return reqs


def check_prefix_cache(lm, cfg, card, evictions: bool) -> dict:
  """(e) LMEngine under "cuda" with a PrefixCache(PREFIX_CACHE_MB) and
  publish_on_retire, against the same engine without one, on
  `prefix_requests` and then a second turn of the first PREFIX_TURNS_2
  conversations (each request's prompt, its tokens but the last, and 4
  new ones): every request's greedy tokens equal, token for token; hits
  (where the cache evicts nothing, `evictions` False, every second-turn
  hit reaches the first turn's fed length, published at retirement);
  evictions where `evictions`. Then a state
  spliced from a snapshot at PREFIX_TEMPLATE tokens and stepped through
  the rest of a prompt equals the cold prefill's, every leaf and the
  logits bit for bit. TTFT p50 with and without hits is a reading.
  Returns the cached runs' launches."""
  from repro_torch.kernels import ops
  from repro_torch.models.api import get_model
  from repro_torch.serving.engine import LMEngine
  from repro_torch.serving.prefix_cache import PrefixCache
  api = get_model(cfg)
  cache = PrefixCache(PREFIX_CACHE_MB)
  cold = lm_engine(lm, cfg, "cuda")
  hot = LMEngine(cfg, lm, batch_size=SERVE_BATCH, max_len=cold.max_len,
                 kernel_policy="cuda", prefix_cache=cache,
                 publish_on_retire=True, device="cuda")
  hits = []
  lookup = cache.lookup

  def counted(tokens):
    m, payload = lookup(tokens)
    hits.append(m)
    return m, payload
  cache.lookup = counted

  def serve(eng, reqs):
    uids = [eng.submit(p, max_new_tokens=b, eos_id=None) for p, b in reqs]
    fin = {f.uid: f for f in eng.run(temperature=0.0)}
    return [fin[u] for u in uids]
  rounds, launches = [], {k: 0 for k in ops.LAUNCHES}
  reqs = prefix_requests(cfg)
  for turn in range(2):
    got_c = serve(cold, reqs)
    torch.cuda.synchronize()
    ops.reset_launches()
    n0 = len(hits)
    got_h = serve(hot, reqs)
    torch.cuda.synchronize()
    for k, n in ops.LAUNCHES.items():
      launches[k] += n
    for i, (a, b) in enumerate(zip(got_c, got_h)):
      if a.tokens.tolist() != b.tokens.tolist():
        fail(f"{cfg.name} prefix cache: turn {turn} request {i} emitted "
             f"{b.tokens.tolist()} with the cache, {a.tokens.tolist()} "
             "without")
    rounds.append(dict(cold=got_c, hot=got_h, hits=hits[n0:],
                       fed=[len(p) for p, _ in reqs]))
    rng = np.random.RandomState(8)
    reqs = [(np.concatenate([p, f.tokens[:-1],
                             rng.randint(1, cfg.vocab_size, size=(4,))]), b)
            for (p, b), f in zip(reqs[:PREFIX_TURNS_2], got_c)]
  del cache.lookup
  stats = hot.cache_stats()
  first_turn = [len(p) + len(f.tokens) - 1 for (p, _), f in
                zip(prefix_requests(cfg)[:PREFIX_TURNS_2],
                    rounds[0]["cold"])]
  if not any(rounds[0]["hits"]) or (not evictions and not all(
      m >= n for m, n in zip(rounds[1]["hits"], first_turn))):
    fail(f"{cfg.name} prefix cache: hits {[r['hits'] for r in rounds]} "
         f"(second turn's fed lengths {first_turn})")
  if stats["hits"] == 0 or (evictions and stats["evictions"] == 0):
    fail(f"{cfg.name} prefix cache: stats {stats}")
  # a splice at the template, stepped on, against the cold prefill
  prompt = prefix_requests(cfg)[0][0]
  m = PREFIX_TEMPLATE
  lg_c, st_c = hot._prefill_slot(prompt)
  _, part = hot._prefill_slot(prompt[:m])
  start = api.splice_prefix(cfg, hot._init_state(1),
                            api.prefix_view(cfg, part, m))
  lg_s, st_s = hot._prefill_slot(prompt[m:], state=start, start=m)
  leaves = []

  def walk(a, b, path=""):
    if isinstance(a, dict):
      for k in a:
        walk(a[k], b[k], f"{path}/{k}")
    else:
      leaves.append((path, torch.equal(a, b)))
  walk(st_c, st_s)
  if not all(ok for _, ok in leaves) or not torch.equal(lg_c, lg_s):
    fail(f"{cfg.name} prefix cache: a spliced state differs from the cold "
         f"one: {[p for p, ok in leaves if not ok]}, logits equal "
         f"{torch.equal(lg_c, lg_s)}")

  def p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] * 1e3 if xs else None
  ttft_hit = [f.ttft_s for r in rounds for f, m in zip(r["hot"], r["hits"])
              if m]
  ttft_miss = [f.ttft_s for r in rounds for f, m in zip(r["hot"], r["hits"])
               if not m]
  out = dict(prefix_cache=cfg.name, card=card, layers=cfg.num_layers,
             capacity_mb=PREFIX_CACHE_MB, requests=[len(r["hot"]) for r in
                                                    rounds],
             hits_by_turn=[r["hits"] for r in rounds],
             prompt_lens_by_turn=[r["fed"] for r in rounds], stats=stats,
             tokens_equal=True, spliced_leaves_equal=len(leaves),
             ttft_p50_ms_without_cache=p50(
                 [f.ttft_s for r in rounds for f in r["cold"]]),
             ttft_p50_ms_with_cache=p50(
                 [f.ttft_s for r in rounds for f in r["hot"]]),
             ttft_p50_ms_hits=p50(ttft_hit), ttft_p50_ms_misses=p50(ttft_miss),
             launches=launches)
  print(json.dumps(out), flush=True)
  del cold, hot
  return launches


def check_xlstm(card) -> tuple[dict, list[dict]]:
  """Phase 13. Returns (launches by path, kernel rows)."""
  from repro_torch import configs
  from repro_torch.kernels import dispatch
  from repro_torch.models import xlstm_model as xm
  by_path, rows = {}, []
  cfg = configs.get_config(XLSTM_ARCH)
  if (cfg.num_layers, cfg.d_model, cfg.num_heads) != (24, 1024, 4):
    fail(f"{cfg.name}: {cfg}")
  pairs = cfg.num_layers // 2
  # (b, first) all 24 layers in bf16: decode_matvec at the decode step's
  # shapes, its launches a step counted from `classify`
  lm = build_xlstm(cfg)
  leaves = xlstm_step_leaves(lm, cfg)
  pol = dispatch.resolve_policy("cuda", SERVE_BATCH)
  per_step = 0
  for name, leaf, weight in leaves:
    x = torch.zeros((SERVE_BATCH, leaf.in_dim), device="cuda",
                    dtype=act_dtype(name, leaf.w))
    if dispatch.classify(leaf, x, pol, name) != "decode_matvec":
      fail(f"{cfg.name}: {name} does not classify to decode_matvec")
    per_step += weight
  if per_step != pairs * (5 + cfg.num_heads) + 1:
    fail(f"{cfg.name}: {per_step} decode_matvec launches a step, not 109")
  rows += check_cases(decode_cases(leaves, torch.Generator().manual_seed(16),
                                   "xlstm_decode", f"{cfg.name} "))
  # (a) the XLSTM_PREFILL_LEN-token prefill, teacher-forced: the
  # recurrent heads launch a token at a time; (b) LMEngine, 109 launches
  # a step; both compared
  # on an f32 copy
  lm32 = f32_copy(lm, cfg)
  by_path["xlstm_prefill"] = check_prefill(
      lm, cfg, card, set(XLSTM_GEMMS), flash=False, compare=lm32,
      tokens=XLSTM_PREFILL_LEN, recurrent=(XLSTM_REC, pairs * cfg.num_heads),
      drift=(xm, "_pair_block"))
  by_path["xlstm_serving"] = check_lm_serving(lm, cfg, card, compare=lm32)
  del lm32
  free()
  print(json.dumps(dict(
      xlstm_profile=cfg.name, card=card, layers=cfg.num_layers,
      **profile_paths(lm, cfg, "xlstm", XLSTM_PROFILE_LEN))), flush=True)
  # (e) the prefix cache on the full model: carries copied whole
  by_path["xlstm_prefix_cache"] = check_prefix_cache(lm, cfg, card, True)
  del lm
  free()
  # (c) the self-speculative engine on the depth-cut model
  cut = configs.get_config(XLSTM_ARCH).with_(num_layers=XLSTM_CUT_LAYERS)
  by_path["xlstm_speculative"], spec_rows, _ = check_cut_speculative(
      card, cut, build_xlstm, xlstm_step_leaves, 7,
      ("embedding.table", "final_norm", "pairs.m_norm", "pairs.slstm.bias",
       "pairs.mlstm.norm", "pairs.mlstm.ifg.w"), XLSTM_SPEC_RESIDUAL, 15)
  rows += spec_rows
  # (d) the two-stage recipe at the depth cut
  check_training_card_vs_cpu(card, XLSTM_ARCH)
  by_path["xlstm_trained_serving"], trained_rows, _ = check_cut_training(
      cut, card, "xlstm", 17)
  rows += trained_rows
  # (e) the prefix cache on a transformer: KV rows sliced
  qcfg = configs.get_config("qwen3-4b").with_(num_layers=PREFIX_QWEN_LAYERS)
  lm = build_lm(qcfg)
  by_path["qwen3_prefix_cache"] = check_prefix_cache(lm, qcfg, card, False)
  del lm
  free()
  return by_path, rows


# ---------------------------------------------------------------------------
# Phase 14: distribution — DeviceMesh / DTensor on an NCCL world of one.
# Two ranks sharing the card through gloo are not run: DTensor's
# all-gather fails there (`chip_gloo_probe.py`; PERF.md, Findings).
# ---------------------------------------------------------------------------

#: the reference's bound on int8 moment bytes against AdamW's f32 ones
Q_ADAM_BYTES_RATIO = 0.3
#: the compressed mean's bound against the exact one (tests/test_dist.py)
COMPRESS_REL = 0.02
#: (c)'s plan leaves the expert stacks dense: factoring them is most of
#: phase 11's ~20 s init and ~40 s transition, which (c) would pay twice
MESH_DS_EXCLUDE = ("*embed*", "*expert*")
#: (d)'s depth cuts; whisper-small runs at full depth
MESH_LAYERS = {"deepseek-v2-lite": 4, "zamba2-7b": 7, "xlstm-350m": 4}
#: (d)'s xlstm prompts, cut: the sLSTM runs a token at a time
MESH_XLSTM_PROMPT = 4
#: (g)'s zamba prefill: one row of this many tokens through the 7-layer cut
MESH_FLASH_TOKENS = 1024


def _median_ms(steps: list, stage: int) -> float:
  """A stage's median step, its first step (new shapes) left out."""
  walls = [m["wall_s"] for m in steps if m["stage"] == stage]
  return statistics.median(walls[1:]) * 1e3


def _moment_bytes(init, params) -> int:
  """Device bytes an optimizer's init allocates for `params`."""
  torch.cuda.synchronize()
  before = torch.cuda.memory_allocated()
  state = init(params)
  torch.cuda.synchronize()
  used = torch.cuda.memory_allocated() - before
  del state
  return used


def check_mesh_of_one(cfg, card, mesh) -> tuple[dict, dict]:
  """(a) Full-width deepspeech2-wsj trained as phase 6 with q_adam, on
  `mesh` (a size-one NCCL mesh) and with none: losses and every
  parameter equal bit for bit; q_adam's moment bytes against AdamW's;
  the mesh-trained stage-2 model served as phase 6 serves its own, with
  the launches of the mesh=None model's. Returns (launches, summary)."""
  from repro_torch.core.factored import frozen, param_tree
  from repro_torch.dist.sharding import gather_params, is_dtensor
  from repro_torch.optim import adamw, q_adam
  ckpt = ROOT / "build" / "mesh_ckpt"
  runs = {}
  for name, m in (("mesh", mesh), ("none", None)):
    tr = make_trainer(cfg, "cuda", ckpt, mesh=m, optimizer="q_adam")
    if m is not None and not all(is_dtensor(p) for p in tr.params.parameters()):
      fail("mesh trainer: a parameter is not a DTensor")
    steps = [tr.train_step(train_batch(cfg, i)) for i in range(TRAIN_STEPS)]
    runs[name] = (tr, steps)
  (tr_m, steps_m), (tr_n, steps_n) = runs["mesh"], runs["none"]
  losses_m = [s["loss"] for s in steps_m]
  losses_n = [s["loss"] for s in steps_n]
  if losses_m != losses_n or [s["stage"] for s in steps_m] != \
      [s["stage"] for s in steps_n]:
    fail(f"mesh of one: losses {losses_m} != {losses_n}")
  pm, pn = param_tree(gather_params(tr_m.params)), param_tree(tr_n.params)
  if sorted(pm) != sorted(pn):
    fail("mesh of one: parameter trees differ")
  differ = [k for k in pn if not torch.equal(pm[k], pn[k])]
  if differ:
    fail(f"mesh of one: {len(differ)} leaves differ, first {differ[:3]}")
  q_bytes = _moment_bytes(q_adam.init, tr_m.params)
  a_bytes = _moment_bytes(adamw.init, tr_m.params)
  if not q_bytes < Q_ADAM_BYTES_RATIO * a_bytes:
    fail(f"q_adam moments {q_bytes} B, AdamW's {a_bytes} B")
  utts = utterances(cfg)
  served = {}
  for name, tr in (("mesh", tr_m), ("none", tr_n)):
    params = frozen(gather_params(tr.params) if name == "mesh"
                    else copy.deepcopy(tr.params))
    res, _, _, launches, _ = serve(cfg, params, utts, "cuda")
    served[name] = ({r.uid: r.labels for r in res}, launches)
  if served["mesh"] != served["none"] or \
      served["mesh"][1]["lowrank_gemm"] == 0:
    fail(f"mesh of one: serving differs: {served['mesh'][1]} vs "
         f"{served['none'][1]}")
  summary = dict(
      mesh_of_one=cfg.name, card=card, optimizer="q_adam",
      steps=TRAIN_STEPS, transition_step=TRAIN_TRANSITION,
      losses=losses_m, bit_for_bit=True,
      median_step_ms={f"stage{s}": {"mesh": _median_ms(steps_m, s),
                                    "none": _median_ms(steps_n, s)}
                      for s in (1, 2)},
      q_adam_moment_bytes=q_bytes, adamw_moment_bytes=a_bytes,
      q_adam_ratio=q_bytes / a_bytes, serving_launches=served["mesh"][1])
  print(json.dumps(summary), flush=True)
  return served["mesh"][1], summary


def check_lm_on_mesh_of_one(card, mesh) -> tuple[dict, dict]:
  """(b) qwen3-4b at full width cut to PREFIX_QWEN_LAYERS: LMEngine on
  `mesh` against mesh=None under "cuda", phase 5's 8 requests, greedy:
  tokens and decode_matvec launches equal."""
  from repro_torch import configs
  qcfg = configs.get_config("qwen3-4b").with_(num_layers=PREFIX_QWEN_LAYERS)
  lm = build_lm(qcfg)
  reqs = lm_requests(qcfg)
  out = {}
  for name, m in (("none", None), ("mesh", mesh)):
    eng = lm_engine(lm, qcfg, "cuda", mesh=m)
    fin, dt, launches = timed_run(eng, reqs)
    out[name] = ({f.uid: f.tokens.tolist() for f in fin}, launches, dt,
                 sum(len(f.tokens) for f in fin))
    del eng
    free()
  del lm
  free()
  if out["mesh"][:2] != out["none"][:2] or \
      out["mesh"][1]["decode_matvec"] == 0:
    fail(f"LMEngine on a mesh of one: tokens or launches differ "
         f"({out['mesh'][1]} vs {out['none'][1]})")
  summary = dict(lm_on_mesh=qcfg.name, layers=PREFIX_QWEN_LAYERS, card=card,
                 launches=out["mesh"][1], tokens=out["mesh"][3],
                 tok_per_s={k: v[3] / v[2] for k, v in out.items()})
  print(json.dumps(summary), flush=True)
  return out["mesh"][1], summary


def check_compressed_mean(card) -> dict:
  """`compressed_grad_mean` over the NCCL world of one: the int8 payload's
  all-reduce SUM and the scale's MAX on the card, the mean within
  COMPRESS_REL of the exact one and the residual what the int8 rounding
  dropped."""
  import torch.distributed as dist
  from repro_torch.optim.compress import compressed_grad_mean
  g = torch.randn((1024, 1024), device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(5))
  mean, err = compressed_grad_mean({"g": g}, {"g": torch.zeros_like(g)},
                                   dist.group.WORLD)
  rel = float((mean["g"] - g).norm() / g.norm())
  half_step = float(g.abs().max()) / 254.0     # half of one int8 step
  if rel > COMPRESS_REL or float(err["g"].abs().max()) > half_step * 1.001:
    fail(f"compressed mean: {rel:.3g} from the exact one")
  out = dict(compressed_mean=list(g.shape), card=card, rel=rel)
  print(json.dumps(out), flush=True)
  return out


def check_ds_training_on_mesh(card, mesh) -> dict:
  """(c) deepseek-v2-lite at full width cut to DS_TRAIN_LAYERS (phase
  11's trainer and CUDA-seeded weights; the plan leaves the expert
  stacks dense, MESH_DS_EXCLUDE) trained TRAIN_STEPS steps through the
  transition under `Trainer(mesh=)` and with none: every loss, every
  parameter and every MoE call's routes (`moe.record_routes`) equal, bit
  for bit. Returns the summary."""
  from repro_torch import configs
  from repro_torch.core.factored import param_tree
  from repro_torch.dist.sharding import gather_params
  from repro_torch.layers import moe
  cfg = configs.get_config(DS_ARCH).with_(num_layers=DS_TRAIN_LAYERS)
  runs = {}
  for name, m in (("none", None), ("mesh", mesh)):
    tr = make_trainer(cfg, "cuda", ROOT / "build" / "ds_mesh_ckpt",
                      generator=torch.Generator(device="cuda").manual_seed(0),
                      mesh=m, exclude=MESH_DS_EXCLUDE)
    with moe.record_routes() as log:
      steps = [tr.train_step(train_batch(cfg, i)) for i in range(TRAIN_STEPS)]
    params = param_tree(gather_params(tr.params) if m is not None
                        else tr.params)
    runs[name] = (steps, {k: v.detach().clone() for k, v in params.items()},
                  [e["experts"] for e in log])
    del tr, params
    free()
  (steps_n, pn, routes_n), (steps_m, pm, routes_m) = runs["none"], runs["mesh"]
  if [s["loss"] for s in steps_m] != [s["loss"] for s in steps_n] or \
      [s["stage"] for s in steps_m] != [s["stage"] for s in steps_n]:
    fail(f"{cfg.name} on a mesh of one: losses {[s['loss'] for s in steps_m]}"
         f" != {[s['loss'] for s in steps_n]}")
  differ = [k for k in pn if k not in pm or not torch.equal(pm[k], pn[k])]
  if sorted(pm) != sorted(pn) or differ:
    fail(f"{cfg.name} on a mesh of one: {len(differ)} leaves differ, first "
         f"{differ[:3]}")
  if len(routes_m) != len(routes_n) or not routes_n or not all(
      np.array_equal(a, b) for a, b in zip(routes_m, routes_n)):
    fail(f"{cfg.name} on a mesh of one: routes differ")
  summary = dict(
      mesh_trained=cfg.name, card=card, layers=cfg.num_layers,
      exclude=list(MESH_DS_EXCLUDE), steps=TRAIN_STEPS,
      transition_step=TRAIN_TRANSITION,
      losses=[s["loss"] for s in steps_m], bit_for_bit=True,
      moe_calls=len(routes_m),
      median_step_ms={f"stage{s}": {"mesh": _median_ms(steps_m, s),
                                    "none": _median_ms(steps_n, s)}
                      for s in (1, 2)})
  print(json.dumps(summary), flush=True)
  return summary


def mesh_vs_none(card, mesh, name, cfg, lm, reqs, cache: bool = False,
                 **kw) -> tuple[dict, dict]:
  """`LMEngine` on `mesh` against mesh=None under "cuda" (`kw`: the
  speculative engine's; `cache`: each engine with a new
  PrefixCache(PREFIX_CACHE_MB)), greedy on `reqs`: tokens, every
  kernel's launches, the target's replays and the cache's statistics
  equal. Returns (the mesh run's launches, the summary, which has each
  engine's tok/s)."""
  from repro_torch.kernels import ops
  from repro_torch.serving.engine import LMEngine
  from repro_torch.serving.prefix_cache import PrefixCache
  out = {}
  for tag, m in (("none", None), ("mesh", mesh)):
    if cache:
      kw["prefix_cache"] = PrefixCache(PREFIX_CACHE_MB)
    eng = LMEngine(cfg, lm, batch_size=SERVE_BATCH, max_len=64,
                   kernel_policy="cuda", mesh=m,
                   device=None if m is not None else "cuda", **kw)
    eng.submit(np.arange(1, 5), max_new_tokens=2)      # warm-up, as
    eng.run()                                          # `lm_engine`'s
    eng.reset()
    replays = []
    if eng._has_carry and eng.speculate:
      replay = eng._replay

      def counted(step, state, window, commit, pos0):
        if step == eng._step:
          replays.append([int(c) for i, c in enumerate(commit)
                          if eng._slots[i].active])
        return replay(step, state, window, commit, pos0)
      eng._replay = counted
    for prompt, budget in reqs:
      eng.submit(prompt, max_new_tokens=budget)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    fin = eng.run(temperature=0.0)
    torch.cuda.synchronize()
    out[tag] = dict(tokens={f.uid: f.tokens.tolist() for f in fin},
                    launches=dict(ops.LAUNCHES), s=time.perf_counter() - t0,
                    replays=replays, n=sum(len(f.tokens) for f in fin),
                    stats=eng.cache_stats(), accept=eng.accept_rate)
    del eng
    free()
  m_, n_ = out["mesh"], out["none"]
  for key in ("tokens", "launches", "replays"):
    if m_[key] != n_[key]:
      fail(f"{name} on a mesh of one: {key} differ ({m_[key]} vs "
           f"{n_[key]})")
  if not any(m_["launches"].values()):
    fail(f"{name} on a mesh of one: no kernel launched")
  summary = dict(mesh_serving=name, layers=cfg.num_layers, card=card,
                 requests=len(reqs), tokens=m_["n"], launches=m_["launches"],
                 tok_per_s={k: v["n"] / v["s"] for k, v in out.items()},
                 mesh_over_none_s=m_["s"] / n_["s"])
  if m_["replays"]:
    summary.update(replays=len(m_["replays"]), masked_replays=sum(
        len(set(c)) > 1 for c in m_["replays"]), accept_rate=m_["accept"])
  if cache:
    keys = ("hits", "misses", "evictions", "inserts", "entries", "bytes")
    if any(m_["stats"][k] != n_["stats"][k] for k in keys) or \
        not m_["stats"]["hits"]:
      fail(f"{name} on a mesh of one: cache stats {m_['stats']} vs "
           f"{n_['stats']}")
    summary["cache"] = {k: m_["stats"][k] for k in keys}
  print(json.dumps(summary), flush=True)
  return m_["launches"], summary


def check_families_on_mesh(card, mesh) -> tuple[dict, dict]:
  """(d) `LMEngine(mesh=)` against mesh=None on phase 5's 8 requests:
  deepseek-v2-lite, zamba2-7b and xlstm-350m cut in depth (MESH_LAYERS;
  xlstm's prompts cut to MESH_XLSTM_PROMPT tokens), whisper-small at
  full depth (its zero memory, as the reference's engine serves it);
  (e) the speculative engine on the zamba2-7b cut with a rank-128 draft,
  its residuals shrunk (tokens and replays equal, a masked replay); (f) the prefix cache on qwen3-4b cut to
  PREFIX_QWEN_LAYERS (tokens, hits, evictions and bytes equal). Returns
  (launches by path, summaries)."""
  from repro_torch import configs
  from repro_torch.models import whisper
  from repro_torch.serving.speculative import make_draft_params
  by_path, out = {}, {}
  builds = {DS_ARCH: build_lm, ZAMBA_ARCH: build_zamba,
            XLSTM_ARCH: build_xlstm,
            "whisper-small": lambda c: whisper.init_model(
                c, generator=torch.Generator(device="cuda").manual_seed(0),
                device="cuda")}
  for arch, build in builds.items():
    cfg = configs.get_config(arch)
    if arch in MESH_LAYERS:
      cfg = cfg.with_(num_layers=MESH_LAYERS[arch])
    reqs = lm_requests(cfg)
    if arch == XLSTM_ARCH:
      reqs = [(p[:MESH_XLSTM_PROMPT], b) for p, b in reqs]
    lm = build(cfg)
    by_path[f"{cfg.family}_mesh_serving"], out[arch] = mesh_vs_none(
        card, mesh, arch, cfg, lm, reqs)
    if arch == ZAMBA_ARCH:
      # the target's residuals shrunk as phase 12's (e), so that windows
      # commit different lengths and the per-slot replay runs
      draft = make_draft_params(lm, rank=DRAFT_RANK)
      shrink_residuals(lm, draft, ZAMBA_SPEC_RESIDUAL, 14)
      by_path["zamba_mesh_speculative"], out["speculative"] = mesh_vs_none(
          card, mesh, f"{arch} speculative", cfg, lm, reqs,
          speculate=SPEC_K, draft_params=draft)
      if not out["speculative"].get("masked_replays"):
        fail(f"{arch} speculative on a mesh of one: no masked replay")
      del draft
    del lm
    free()
  qcfg = configs.get_config("qwen3-4b").with_(num_layers=PREFIX_QWEN_LAYERS)
  lm = build_lm(qcfg)
  by_path["qwen3_mesh_prefix_cache"], out["prefix"] = mesh_vs_none(
      card, mesh, "qwen3-4b prefix cache", qcfg, lm, prefix_requests(qcfg),
      cache=True)
  del lm
  free()
  return by_path, out


def check_flash_on_mesh(card, mesh) -> tuple[dict, dict]:
  """(g) flash_attention under `heads_local`: whisper-small's `encode`
  as phase 8 runs it and the zamba2-7b cut's `forward` over one
  MESH_FLASH_TOKENS-token row (its shared block), on `mesh` and with
  none under "cuda": the memory and the logits equal bit for bit, and
  every kernel's launches equal, flash's at least one a layer or a
  group.
  Returns (launches by path, summary)."""
  from repro_torch import configs
  from repro_torch.dist import sharding as shd
  from repro_torch.kernels import dispatch
  from repro_torch.models import whisper, zamba
  wcfg = configs.get_config("whisper-small").with_(
      attn_block_kv=WHISPER_BLOCK_KV)
  zcfg = configs.get_config(ZAMBA_ARCH).with_(num_layers=ZAMBA_CUT_LAYERS)
  frames = whisper_frames(wcfg, 0)
  tokens = torch.randint(1, zcfg.vocab_size, (1, MESH_FLASH_TOKENS),
                         generator=torch.Generator(device="cuda").manual_seed(
                             4), device="cuda")
  cases = (
      ("whisper_mesh_encode", wcfg, frames, wcfg.encoder_layers,
       lambda c: whisper.init_model(c, generator=torch.Generator(
           device="cuda").manual_seed(0), device="cuda"),
       lambda p, x, c, pol, cs: whisper.encode(p, x, c, pol, cs=cs)),
      ("zamba_mesh_prefill", zcfg, tokens, zamba._plan(zcfg)[1], build_zamba,
       lambda p, x, c, pol, cs: zamba.forward(p, x, c, policy=pol, cs=cs)))
  by_path, summary = {}, dict(flash_on_mesh=True, card=card)
  for path, cfg, x, flashes, build, run in cases:
    model = build(cfg)
    pol = dispatch.resolve_policy("cuda", x.shape[0])
    out = {}
    for tag, m in (("none", None), ("mesh", mesh)):
      p, xi = model, x
      if m is not None:
        p = shd.distribute_params(copy.deepcopy(model),
                                  shd.param_shardings(model, m))
        xi = shd.distribute_tensor_local(
            x, m, shd.rows_placements(m, x.shape[0]))
      cs = shd.make_constraint(m, cfg, x.shape[0])
      with torch.no_grad(), shd.replicated_plain(m is not None):
        run(p, xi, cfg, pol, cs)                    # warm-up
        y, dt, launches, _ = counted(lambda: run(p, xi, cfg, pol, cs))
      out[tag] = (shd.gather_tree(y), dt, launches)
      del p
    (yn, dtn, ln), (ym, dtm, lm_) = out["none"], out["mesh"]
    if not torch.equal(ym, yn) or lm_ != ln or \
        ln.get("flash_attention", 0) < flashes:
      fail(f"{path} on a mesh of one: outputs equal {torch.equal(ym, yn)}, "
           f"launches {lm_} vs {ln} (at least {flashes} flash)")
    summary[path] = dict(layers=cfg.num_layers, shape=list(x.shape),
                         launches=lm_, ms={"mesh": dtm * 1e3,
                                           "none": dtn * 1e3})
    by_path[path] = lm_
    del model, out, ym, yn
    free()
  print(json.dumps(summary), flush=True)
  return by_path, summary


def check_distribution(card) -> tuple[dict, dict]:
  """Phase 14. Returns (launches by path, summaries)."""
  import torch.distributed as dist
  from repro_torch import configs
  from repro_torch.dist import make_mesh
  by_path, out = {}, {}
  mesh = make_mesh((1, 1), ("data", "model"))      # an NCCL world of one
  if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
    fail(f"mesh of one: {dist.get_backend()}, {dist.get_world_size()}")
  cfg = configs.get_config("deepspeech2-wsj")
  by_path["ds2_mesh_trained"], out["a"] = check_mesh_of_one(cfg, card, mesh)
  free()
  by_path["qwen3_mesh_serving"], out["b"] = check_lm_on_mesh_of_one(card,
                                                                    mesh)
  out["compress"] = check_compressed_mean(card)
  out["c"] = check_ds_training_on_mesh(card, mesh)
  paths, out["d-f"] = check_families_on_mesh(card, mesh)
  by_path.update(paths)
  paths, out["g"] = check_flash_on_mesh(card, mesh)
  by_path.update(paths)
  dist.destroy_process_group()
  return by_path, out


def _sums(rows: list[dict]) -> dict:
  """Per-step sums of timed rows, each row counted `weight` times (and
  the cold times' sums where every row has them)."""
  libs = [r["library_ms"] for r in rows]
  out = dict(
      ms=sum(r["kernel_ms"] * r["weight"] for r in rows),
      plain_ms=sum(r["plain_ms"] * r["weight"] for r in rows),
      bound_ms=sum(r["bound_ms"] * r["weight"] for r in rows),
      bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
      else "operations",
      library_ms=(sum(x * r["weight"] for x, r in zip(libs, rows))
                  if libs and None not in libs else None))
  if rows and all("kernel_cold_ms" in r for r in rows):
    out["cold_ms"] = sum(r["kernel_cold_ms"] * r["weight"] for r in rows)
    out["library_cold_ms"] = (
        sum(r["library_cold_ms"] * r["weight"] for r in rows)
        if all("library_cold_ms" in r for r in rows) else None)
  names = {r.get("yardstick") for r in rows}
  if len(names) == 1 and None not in names:   # one yardstick for every row
    name = names.pop()
    for key in (f"{name}_ms", f"{name}_cold_ms"):
      if all(key in r for r in rows):
        out[key] = sum(r[key] * r["weight"] for r in rows)
  return out


def ds2_step_ms_by_batch(rows: list[dict], kernel: str,
                         key: str = "kernel_ms") -> dict:
  """`kernel`'s time a deepspeech2-wsj frame step at each timed batch
  (BATCHES): the sum of its timed rows' `key` (or "library_ms") at the
  serving path's shapes. Also takes the rows of an earlier version's
  run, one JSON object a line."""
  out: dict = {}
  for r in rows:
    if r.get("kernel") == kernel and r.get(key) is not None and \
        r.get("path") in (None, "ds2"):
      out[r["batch"]] = out.get(r["batch"], 0.0) + r[key]
  return out


# ---------------------------------------------------------------------------
# Phase 15: the examples and the static auditor.
# ---------------------------------------------------------------------------

#: the full-width decode step the auditor walks: qwen3-4b at phase 8's
#: depth, SERVE_BATCH slots, a cache of AUDIT_MAX_LEN positions
AUDIT_MAX_LEN = 64
#: warmed steps timed (wall) beside the walked step's cost ledger
AUDIT_TIMED_STEPS = 5
#: the keys of findings only the card can show: a sync under
#: set_sync_debug_mode("error"), a kernel scope's launches
CARD_ONLY_KEYS = ("cuda-sync", "launches:")


def run_example(name: str, argv: list):
  """`main(argv)` of `examples/{name}.py`."""
  import importlib.util
  spec = importlib.util.spec_from_file_location(
      name, ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.main(argv)


def check_examples() -> dict:
  """(a) The three examples of A5b on the card: quickstart's two stages
  (8 steps), compress_model's threshold table (4 pretraining steps),
  serve_lm's four runs (the smoke model dense and factored, then
  qwen3-4b at full width, 1 layer, dense through decode_matvec and at
  rank 256 through lowrank_gemm). Returns serve_lm's launches (each of
  its runs zeroes the counts before it serves and reads them after)."""
  from repro_torch.kernels import ops
  q = run_example("quickstart_torch", ["--steps", "8", "--transition", "4"])
  if q["stage"] != 2 or not q["params_after"] < q["params_before"] or \
      not all(math.isfinite(x) for x in q["losses"]):
    fail(f"quickstart_torch: stage {q['stage']}, params "
         f"{q['params_before']} -> {q['params_after']}, {q['losses']}")
  rows = run_example("compress_model_torch", ["--pretrain-steps", "4"])
  if not rows[-1][1] < rows[0][1] or \
      not all(math.isfinite(r[3]) for r in rows):
    fail(f"compress_model_torch: {rows}")
  runs = run_example("serve_lm_torch", [])
  if runs["wide_dense"]["launches"].get("decode_matvec", 0) < 1 or \
      runs["wide_factored"]["launches"].get("lowrank_gemm", 0) < 1 or \
      any(r["tokens"] < 1 for r in runs.values()):
    fail(f"serve_lm_torch: {runs}")
  launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
              for k in ops.LAUNCHES}
  print(json.dumps({"phase15_examples": {
      "quickstart": {"params": [q["params_before"], q["params_after"]],
                     "last_loss": q["losses"][-1]},
      "compress_model": [list(r) for r in rows],
      "serve_lm": runs}}), flush=True)
  return launches


def check_audit_grid() -> dict:
  """(b) `run_audit` on the default grid at smoke scale, both policies,
  on the card, held against the port's committed baseline, which is the
  CPU's findings (`tests/test_torch_analysis.py` holds the CPU's audit
  to it): no new finding and none stale, so the card finds what the CPU
  finds. A finding only the card can show (CARD_ONLY_KEYS: a sync, a
  kernel scope's launches) is new, and fails. The budgets run too, held
  to the CPU's committed budgets.json: a cost, memory or compression
  budget finding is new and fails, and so does a ledger cheaper than
  its band (ratchet stale); the largest deviation of each gated metric
  is printed."""
  from repro_torch import analysis
  from repro_torch.analysis import budgets
  t0 = time.perf_counter()
  gpu = analysis.run_audit(device="cuda", run_budgets=True)
  card_s = time.perf_counter() - t0
  gi = {f.ident for f in gpu.findings}
  card_only = sorted(i for i in gi
                     if i.split("|")[5].startswith(CARD_ONLY_KEYS))
  budget_found = sorted(f.ident for f in gpu.findings if f.check in (
      "cost_budget", "memory_budget", "compression_ledger"))
  ratchet = gpu.meta.get("budget_ratchet_stale", [])
  committed = budgets.load_budgets()["programs"]
  worst = {}
  for key, led in gpu.meta["budgets"]["programs"].items():
    for m in budgets.TOLERANCES:
      old = committed.get(key, {}).get(m)
      if old:
        rel = (led[m] - old) / old
        if abs(rel) >= abs(worst.get(m, 0.0)):
          worst[m] = rel
  gpu.apply_baseline(analysis.load_baseline())
  launches = {}
  for t in gpu.targets:
    for k, n in t.get("launches", {}).items():
      launches[k] = launches.get(k, 0) + n
  out = dict(card_s=card_s, targets=len(gpu.targets), findings=len(gi),
             card_only=card_only, new=[f.ident for f in gpu.new],
             stale=gpu.stale, scope_launches=launches,
             budget_programs=len(gpu.meta["budgets"]["programs"]),
             budget_findings=budget_found, ratchet_stale=ratchet,
             budget_worst_rel=worst)
  print(json.dumps({"phase15_audit_grid": out}), flush=True)
  if gpu.new or gpu.stale:
    fail("audit: the card's findings differ from the baseline's:\n" +
         gpu.summary())
  if budget_found or ratchet:
    fail(f"audit: the card's ledgers leave the CPU's committed bands: "
         f"{budget_found} {ratchet}")
  if not launches:
    fail("audit: no kernel scope launched on the card")
  return out


def check_audit_step(card) -> tuple[dict, dict]:
  """(c) One warmed decode step of qwen3-4b at full width (QWEN_LAYERS
  layers, bf16) under KernelPolicy(mode="decode"), walked: no bypass,
  every kernel scope launched exactly its kernel (LAUNCHES deltas), no
  sync under set_sync_debug_mode("error"), every state storage kept,
  nothing the cost ledger cannot account (`hlo-unknown`);
  the liveness estimate beside torch.cuda.max_memory_allocated's rise
  over the same warmed step. Returns (the walked step's launches, the
  summary)."""
  from repro_torch import configs
  from repro_torch.analysis import checks, liveness, targets
  from repro_torch.analysis.op_walk import OpWalk, param_seeds
  from repro_torch.dist import hlo_cost
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models.api import get_model
  cfg = configs.get_config("qwen3-4b").with_(num_layers=QWEN_LAYERS)
  lm = build_lm(cfg)
  api = get_model(cfg)
  b, dev = SERVE_BATCH, torch.device("cuda")
  gen = torch.Generator(device="cuda").manual_seed(3)
  tok = torch.randint(1, cfg.vocab_size, (b, 1), device=dev, generator=gen)
  pos = torch.full((b,), 5, dtype=torch.int64, device=dev)
  state = api.init_decode_state(cfg, b, AUDIT_MAX_LEN, device=dev)
  policy = dispatch.decode_policy(b)

  def step():
    return api.decode_step(lm, state, tok, pos, cfg, policy)
  with torch.no_grad():
    for _ in range(3):
      step()
    sync = targets.sync_error(step, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    for _ in range(AUDIT_TIMED_STEPS):
      step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / AUDIT_TIMED_STEPS
  before = targets.state_signature(state)
  ops.reset_launches()
  walk = OpWalk(param_seeds(lm), keep_trace=True)
  with torch.no_grad(), walk:
    logits, new = step()
  torch.cuda.synchronize()
  launches = dict(ops.LAUNCHES)
  after = targets.state_signature(new)
  cost = hlo_cost.analyze_walk(walk.result.trace)
  target = targets.RunTarget(
      "qwen3-4b", cfg.family, "pallas", "float", "decode", walk.result,
      list(walk.log), {k: (before[k], after.get(k)) for k in before}, sync,
      "cuda", cost=cost)
  findings, info = checks.run_target_checks(target)
  live = liveness.estimate(walk.result, walk, outputs=[logits],
                          inputs=(lm, state, tok, pos), donated=state)
  roof = hlo_cost.roofline_from_report(cost)
  scopes = {}
  for sc in walk.result.scopes:
    key = f"{sc.regime}:{sorted(sc.launches)}"
    scopes[key] = scopes.get(key, 0) + 1
  out = dict(layers=QWEN_LAYERS, batch=b, ops=walk.result.n_ops,
             products=info["n_dots"], scoped=info["n_dots_scoped"],
             scopes=scopes, launches={k: v for k, v in launches.items() if v},
             findings=[f.ident for f in findings], sync=sync,
             liveness_transient_bytes=live.transient_bytes,
             liveness_input_bytes=live.input_bytes,
             measured_rise_bytes=rise,
             estimate_over_measured=live.transient_bytes / max(rise, 1),
             ledger=dict(flops=cost.flops, dot_flops=cost.dot_flops,
                         hbm_bytes=cost.hbm_bytes,
                         unknown_ops=cost.unknown_ops,
                         compute_ms=roof.compute_s * 1e3,
                         memory_ms=roof.memory_s * 1e3,
                         collective_ms=roof.collective_s * 1e3,
                         dominant=roof.dominant,
                         peak_live_bytes=live.peak_bytes,
                         credited_bytes=live.credited_bytes),
             step_ms=step_ms,
             step_over_roofline=step_ms / max(
                 1e3 * max(roof.compute_s, roof.memory_s), 1e-9),
             card=card)
  print(json.dumps({"phase15_audit_step": out}), flush=True)
  if findings:
    fail(f"audit of the qwen3-4b decode step: {[f.ident for f in findings]}")
  bad = [sc for sc in walk.result.scopes
         if sc.regime != "jnp" and dict(sc.launches) != {sc.regime: 1}]
  if bad or launches["decode_matvec"] != 7 * QWEN_LAYERS + 1:
    fail(f"audit of the qwen3-4b decode step: scopes {bad[:4]}, launches "
         f"{launches}")
  del lm, state
  gc.collect()
  torch.cuda.empty_cache()
  return launches, out


def check_analysis(card) -> dict:
  """Phase 15: (a) the examples, (b) the audit grid, (c) the walked
  full-width step. Returns launches by path."""
  from repro_torch.kernels import ops
  t0 = time.perf_counter()
  by_path = {"examples": check_examples()}
  t1 = time.perf_counter()
  check_audit_grid()
  t2 = time.perf_counter()
  ops.reset_launches()
  by_path["audit_qwen3_step"], _ = check_audit_step(card)
  print(json.dumps({"phase15_seconds": {
      "examples": t1 - t0, "audit_grid": t2 - t1,
      "audit_step": time.perf_counter() - t2}}), flush=True)
  return by_path


def summarize(rows: list[dict], launches: dict, by_path: dict) -> list[dict]:
  """One entry per kernel, its largest error over every compared shape
  and its launches on the main paths. Times: the DS2 kernels' per frame
  step at the server's batch (summed over the step's launches);
  flash_attention's per call at the prefill's (1, 4096, 32/8, 128), with
  the repeated-heads (1, 4096, 32, 128) beside it; the DS2 kernels add
  their frame step at every timed batch (`ms_by_batch`), decode_matvec
  the llama3-8b decode step at batch 4 and the speculative verify window
  at 16 rows, lowrank_gemm the rank-128 draft's step at batch 4 and its
  prefill's token at batch 1, warm and cold."""
  out = []
  for name, (source, replaces) in KERNELS.items():
    mine = [r for r in rows if r["kernel"] == name]
    if name == "flash_attention":
      main = [dict(r, weight=1) for r in mine if r["path"] == "lm_prefill"]
      per = ("one call, causal bf16 (1, 4096, 32 q / 8 kv heads, 128); 32 "
             "a prefill")
    else:
      main = [r for r in mine if r["path"] == "ds2"]
      per = "one deepspeech2-wsj frame step at batch 4"
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[name],
                 max_abs_err=max(r["max_abs_err"] for r in mine),
                 **_sums(main), per=per, shapes=len(main),
                 launches_by_path={p: n[name] for p, n in by_path.items()})
    if name == "flash_attention":
      mha = [r for r in mine if r["shape"] == f"causal (1, {PREFILL_LEN}, "
             "32, 128)"]
      entry["repeated_heads_ms"] = mha[0]["kernel_ms"]
      entry["stablelm_3b_prefill_call"] = _sums(
          [dict(r, weight=1) for r in mine if r["path"] == "stablelm_prefill"])
      entry["zamba2_7b_prefill_call"] = _sums(
          [dict(r, weight=1) for r in mine if r["path"] == "zamba_prefill"])
    else:
      entry["ms_by_batch"] = ds2_step_ms_by_batch(rows, name)
      for y in sorted({r["yardstick"] for r in mine if "yardstick" in r
                       and r["path"] in (None, "ds2")}):
        entry[f"{y}_ms_by_batch"] = ds2_step_ms_by_batch(rows, name,
                                                         f"{y}_ms")
    for path, key in (("lm_decode", "llama3_8b_decode_step"),
                      ("lm_draft", "llama3_8b_4_layer_draft_step"),
                      ("lm_draft_prefill",
                       "llama3_8b_4_layer_draft_prefill_token"),
                      ("lm_verify", "llama3_8b_4_layer_verify_window"),
                      ("qwen3_decode", "qwen3_4b_12_layer_decode_step"),
                      ("qwen3_trained", "qwen3_4b_trained_step"),
                      ("whisper_encode", "whisper_small_encode"),
                      ("whisper_decode", "whisper_small_decode_step"),
                      ("whisper_lowrank", "whisper_small_truncated_encode"),
                      ("whisper_int8", "whisper_small_ptq_encode"),
                      ("ds_decode", "deepseek_v2_lite_9_layer_decode_step"),
                      ("ds3_decode", "deepseek_v3_671b_4_layer_decode_step"),
                      ("ds_trained", "deepseek_v2_lite_trained_step"),
                      ("zamba_decode", "zamba2_7b_27_layer_decode_step"),
                      ("zamba_draft", "zamba2_7b_7_layer_draft_step"),
                      ("zamba_trained", "zamba2_7b_trained_step"),
                      ("xlstm_decode", "xlstm_350m_decode_step"),
                      ("xlstm_rec", "xlstm_350m_rec_head_f32_over_bf16"),
                      ("xlstm_draft", "xlstm_350m_4_layer_draft_step"),
                      ("xlstm_trained", "xlstm_350m_trained_step")):
      on_path = [r for r in mine if r["path"] == path]
      if on_path:
        entry[key] = _sums(on_path)
    out.append(entry)
  return out


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  from repro_torch import configs
  from repro_torch.kernels import _build

  t_start = time.perf_counter()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  print(f"card: {card}", flush=True)
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}", flush=True)
  _build.library()
  print(f"kernel build: {_build.BUILD_INFO['seconds']:.1f}s -> "
        f"{_build.BUILD_INFO['library']}", flush=True)
  log = _build.BUILD_INFO["log"].splitlines()
  regs = [int(ln.split("Used ")[1].split()[0]) for ln in log
          if "Used " in ln and "registers" in ln]
  spills = [ln.strip() for ln in log
            if "spill stores" in ln and not ln.strip().startswith("0 bytes")]
  print(f"ptxas: {len(regs)} kernel variants, at most {max(regs, default=0)}"
        f" registers a thread, {len(spills)} with spills", flush=True)
  for ln in log:
    if "flash" in ln and ("registers" in ln or "spill" in ln or
                          "Compiling" in ln):
      print(f"ptxas (flash_attention): {ln.strip()}", flush=True)

  cfg = configs.get_config("deepspeech2-wsj")
  lm_cfg = configs.get_config(LM_ARCH)
  forms = build_forms(cfg)
  lm = build_lm(lm_cfg)
  phases = {}
  t0 = time.perf_counter()
  rows = check_kernels(forms["dense"], forms["factored"], forms["int8"], lm)
  phases["2_kernels"] = time.perf_counter() - t0
  print(json.dumps({"kernels_checked": sorted(KERNELS)}), flush=True)
  check_one_lowrank_launch(forms["factored"])
  by_path = {}
  t0 = time.perf_counter()
  by_path["ds2_serving"] = check_serving(cfg, forms, card)
  phases["3_ds2_serving"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  by_path["lm_prefill"] = check_prefill(lm, lm_cfg, card)
  phases["4_prefill"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  by_path["lm_serving"] = check_lm_serving(lm, lm_cfg, card)
  phases["5_lm_serving"] = time.perf_counter() - t0
  del lm
  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  by_path["lm_speculative"], spec_rows, _ = check_lm_speculative(card)
  rows += spec_rows
  phases["7_lm_speculative"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  check_training_card_vs_cpu(card)
  by_path["ds2_trained"], trained_rows, _ = check_training(cfg, card)
  rows += trained_rows
  phases["6_training"] = time.perf_counter() - t0
  del forms
  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  dense_paths, dense_rows = check_dense_family(card)
  by_path.update(dense_paths)
  rows += dense_rows
  phases["8_dense_family"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  check_training_card_vs_cpu(card, "qwen3-4b")
  by_path["qwen3_trained_serving"], lm_trained_rows, _ = check_lm_training(
      card)
  rows += lm_trained_rows
  phases["9_lm_training"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  whisper_paths, whisper_rows, _ = check_whisper(card)
  by_path.update(whisper_paths)
  rows += whisper_rows
  phases["10_whisper"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  ds_paths, ds_rows = check_deepseek(card)
  by_path.update(ds_paths)
  rows += ds_rows
  phases["11_deepseek"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  zamba_paths, zamba_rows = check_zamba(card)
  by_path.update(zamba_paths)
  rows += zamba_rows
  phases["12_zamba"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  xlstm_paths, xlstm_rows = check_xlstm(card)
  by_path.update(xlstm_paths)
  rows += xlstm_rows
  phases["13_xlstm"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  dist_paths, _ = check_distribution(card)
  by_path.update(dist_paths)
  phases["14_distribution"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  by_path.update(check_analysis(card))
  phases["15_analysis"] = time.perf_counter() - t0
  launches = {k: sum(n.get(k, 0) for n in by_path.values())
              for k in KERNELS}
  if not all(n > 0 for n in launches.values()):
    fail(f"a kernel never launched on the main paths: {launches}")
  if not all(math.isfinite(r["max_abs_err"]) for r in rows):
    fail("non-finite kernel error")
  phases["total"] = time.perf_counter() - t_start
  print(json.dumps({"phase_seconds": phases}), flush=True)
  print(card, flush=True)
  print(json.dumps({"kernels": summarize(rows, launches, by_path)}),
        flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
