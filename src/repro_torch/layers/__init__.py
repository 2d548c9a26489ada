"""Layers of the ported families (the DS2 slice: GEMM helper and GRU)."""
