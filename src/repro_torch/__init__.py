"""repro_torch — the PyTorch/CUDA port of `repro`, slice by slice.

Mirrors `src/repro/`'s layout module for module, so each ported module
has one reference counterpart to be tested against. Plain tensor code is
PyTorch; every Pallas kernel of the reference becomes a hand-written
CUDA kernel for Hopper (`kernels/csrc/`), built with `nvcc` at first use.

Ported so far: the DS2 streaming-serving path — `deepspeech2-wsj`
config, factored/quantized GEMM leaves, the kernel dispatcher, the GRU
layer, the DS2 model, the synthetic speech data, `StreamingSpeechServer`
— and the dense-transformer LM — `llama3-8b` config, RMSNorm, RoPE,
SwiGLU, GQA attention, `models.transformer`, `models.api`, a vanilla
`LMEngine` — with both branches of `launch.serve`. All five kernels of
the reference have a CUDA counterpart (gru_cell, decode_matvec,
lowrank_gemm, int8_gemm, flash_attention). `bridge` carries weights over
from the reference's checkpoint path strings.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU and no explicit CPU request they raise.
"""
