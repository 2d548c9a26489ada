"""The four CUDA kernels of the DS2 serving path (`csrc/`), their
launchers, their plain versions (`ref`), the wrappers (`ops`) and the
dispatcher that routes GEMMs to them (`dispatch`)."""
