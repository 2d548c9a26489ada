"""Layers of the ported families: the GEMM helper, GRU, RMSNorm, RoPE,
embedding, SwiGLU and GQA attention."""
