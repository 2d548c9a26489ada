"""Build the CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for `sm_90a`; the objects are linked into one shared library
with a plain C interface, loaded with `ctypes`. The library links
`libcuda` (`-lcuda`, the CUDA driver API): `flash_attention` encodes its TMA
tensor maps on the host with `cuTensorMapEncodeTiled`. The library lands in
`build/kernels/` at the repository root (listed in `.gitignore`), named
by a digest of the sources and flags, so an unchanged tree reuses it and
an edited one rebuilds. Nothing here runs at import time: the CPU tests
import every module and have no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_LIBS = ("-lcuda",)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "rk_decode_matvec": (_P, _P, _P, _P, _P, *(_I,) * 7, _P),
    "rk_lowrank_gemm": (_P, _P, _P, _P, _P, _P, _P, *(_I,) * 11, _P),
    "rk_gru_cell": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "rk_int8_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "rk_flash_attention": (_P, _P, _P, _P, *(_I,) * 7, _P),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None
#: what the last build in this process did: seconds, library, compiler log
BUILD_INFO: dict = {}


def _nvcc() -> str:
  path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  if not os.path.exists(path):
    raise RuntimeError("nvcc not found: the CUDA kernels are built where "
                       "the CUDA toolkit is installed")
  return path


def _link_dirs(nvcc: str) -> tuple[str, ...]:
  """-L for the toolkit's libcuda stub (the NVIDIA driver's own libcuda.so.1 is
  what loads at run time), where the toolkit has one."""
  root = Path(nvcc).resolve().parents[1]
  return tuple(f"-L{d}" for d in (root / "lib64" / "stubs",
                                  root / "targets" / "x86_64-linux" / "lib"
                                  / "stubs") if d.is_dir())


def _digest() -> str:
  h = hashlib.sha256(" ".join(ARCH + NVCC_FLAGS + LINK_LIBS).encode())
  for p in sorted(CSRC.iterdir()):
    h.update(p.name.encode())
    h.update(p.read_bytes())
  return h.hexdigest()[:16]


def build() -> Path:
  """Compile and link the kernels unless this tree's library exists;
  returns its path. Raises with the compiler's output on failure."""
  lib = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
  if lib.exists():
    BUILD_INFO.update(seconds=0.0, library=str(lib), log="(reused)")
    return lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
      obj = Path(tmp) / f"{src.stem}.o"
      cmd = [nvcc, *ARCH, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
      jobs.append((src, obj, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
      out, _ = proc.communicate()
      log.append(f"== {src.name}\n{out}")
      if proc.returncode:
        failed.append(src.name)
    if failed:
      raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    part = Path(tmp) / lib.name
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(part), *(str(o) for _, o, _ in jobs),
         *_link_dirs(nvcc), *LINK_LIBS],
        capture_output=True, text=True)
    if link.returncode:
      raise RuntimeError(f"linking the kernels failed:\n{link.stdout}"
                         f"{link.stderr}")
    os.replace(part, lib)           # atomic: concurrent builds agree
  BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(lib),
                    log="\n".join(log))
  return lib


def library() -> ctypes.CDLL:
  """The loaded kernel library, built on the first call."""
  global _LIB
  if _LIB is None:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
      fn = getattr(lib, name)
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
    lib.rk_error_string.argtypes = (_I,)
    lib.rk_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def check(err: int, kernel: str) -> None:
  """Raise if a launcher returned a CUDA error (a refused launch never
  runs, and a later synchronize would not report it)."""
  if err:
    msg = library().rk_error_string(err).decode()
    raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")


def require(kernel: str, *tensors: torch.Tensor) -> None:
  """The launchers take CUDA tensors of one device with no empty axis."""
  dev = tensors[0].device
  for t in tensors:
    if t.device != dev or dev.type != "cuda":
      raise ValueError(f"{kernel}: every operand must be on one CUDA "
                       f"device, got {[str(t.device) for t in tensors]}")
    if t.numel() == 0:
      raise ValueError(f"{kernel}: empty operand of shape {tuple(t.shape)}")


def dtype_code(kernel: str, *tensors: torch.Tensor) -> int:
  """One float type (f32 or bf16) for all of `tensors`, as the C code."""
  types = {t.dtype for t in tensors}
  if len(types) != 1 or next(iter(types)) not in DTYPE_CODES:
    raise TypeError(f"{kernel}: takes f32 or bf16 operands of one type, "
                    f"got {sorted(map(str, types))}")
  return DTYPE_CODES[next(iter(types))]


def stream(t: torch.Tensor) -> int:
  """The handle of PyTorch's current stream on t's device."""
  return torch.cuda.current_stream(t.device).cuda_stream
