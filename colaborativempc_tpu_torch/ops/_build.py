"""Build and load the hand-written CUDA kernels (``csrc/lqr_kernels.cu``).

``nvcc`` compiles the source into a shared library with a plain C interface,
loaded with ``ctypes`` — no PyTorch headers, so the build takes seconds.
The library goes under ``colaborativempc_tpu_torch/_build/``, named by a hash
of the source and the flags, so a changed source is rebuilt and an unchanged
one is reused. Nothing is built at import: the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lqr_kernels.cu"
BUILD_DIR = _PKG / "_build"
# Full FP32 on CUDA cores: no --use_fast_math (the ADMM prox relies on inf
# comparisons, the Riccati chain is rounding-sensitive).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lqr_kernels_{digest}.so"


def build() -> dict:
    """Compile the kernels unless the library for this source exists.
    Returns ``{"path", "seconds", "built", "log"}``; ``log`` holds nvcc's
    output (register and shared-memory use from ``-Xptxas -v``)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "built": False, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(out), "seconds": seconds, "built": True, "log": log}


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    lib = ctypes.CDLL(build()["path"])
    lib.cmpc_admm_epoch.argtypes = ([_P] * 25 + [_I] * 6 + [ctypes.c_float]
                                    + [_I] * 3 + [_P])
    lib.cmpc_admm_epoch.restype = _I
    lib.cmpc_lqr_affine.argtypes = [_P] * 12 + [_I] * 7 + [_P]
    lib.cmpc_lqr_affine.restype = _I
    return lib
