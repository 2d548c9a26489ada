"""The five CUDA kernels (`csrc/`), their launchers, their plain
versions (`ref`), the wrappers (`ops`) and the dispatcher that routes
GEMMs and attention to them (`dispatch`)."""
