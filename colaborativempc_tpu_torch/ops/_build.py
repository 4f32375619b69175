"""Build and load the hand-written CUDA kernels (every ``csrc/*.cu``:
``lqr_kernels.cu``, the ADMM epoch and the affine solve; ``epoch_data.cu``,
the epoch's fixed data; ``sqp_qp.cu``, the NL and MPCC SQP stage QPs).

``nvcc`` compiles each source into an object, all sources at once (one
process each), and links the objects into one shared library with a plain
C interface, loaded with ``ctypes`` — no PyTorch headers, so the build
takes seconds. Every source is compiled with the same flags. The library
goes under ``colaborativempc_tpu_torch/_build/``, named by a hash of the
sources and the flags, so a changed source is rebuilt and an unchanged one
is reused. Nothing is built at import: the first CUDA launch builds.

On request, :func:`load_epoch_data_clocks` builds ``epoch_data.cu`` alone
with ``-DCMPC_EPOCH_DATA_CLOCKS``, :func:`load_sqp_qp_clocks` builds
``sqp_qp.cu`` alone with ``-DCMPC_SQP_QP_CLOCKS`` and
:func:`load_admm_epoch_clocks` builds ``lqr_kernels.cu`` alone with
``-DCMPC_ADMM_EPOCH_CLOCKS``, each into a library of its own hashed name:
the kernels then stamp ``clock64()`` at fixed points of each block or QP
(``scripts/epoch_data_split.py``, ``scripts/sqp_qp_split.py`` and
``scripts/admm_epoch_split.py`` read the stamps). The default library is
compiled without these macros and does not depend on them.
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
from typing import Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
# Full FP32 on CUDA cores: no --use_fast_math (the ADMM prox relies on inf
# comparisons, the Riccati chain is rounding-sensitive).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CLOCKS_FLAG = "-DCMPC_EPOCH_DATA_CLOCKS"
SQP_CLOCKS_FLAG = "-DCMPC_SQP_QP_CLOCKS"
ADMM_CLOCKS_FLAG = "-DCMPC_ADMM_EPOCH_CLOCKS"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# cmpc_epoch_data: 23 pointers (the last the spill's scratch), P, N, nz, nc,
# mr, rho, reg, threads, chunk, smem_bytes, stream
_EPOCH_DATA_ARGS = [_P] * 23 + [_I] * 5 + [_F] * 2 + [_I] * 3 + [_P]
# cmpc_admm_epoch: 27 pointers (the last two the spills' scratch), P, N, nz,
# nc, mr, epoch_len, alpha, qps_per_block, ring, spill, smem_bytes, stream
_ADMM_EPOCH_ARGS = [_P] * 27 + [_I] * 6 + [_F] + [_I] * 4 + [_P]
# cmpc_nl_qp / cmpc_mpcc_qp: the address of the pointer array (inputs,
# track tables, outputs, slots), the constants, the slots' numbers, the
# ints, the stream
_PD = ctypes.POINTER(ctypes.c_double)
_SQP_QP_ARGS = [_P, _PD, _PD, ctypes.POINTER(_I), _P]


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


def library_path(sources: Sequence[Path] = SOURCES,
                 flags: Sequence[str] = NVCC_FLAGS,
                 stem: str = "cmpc_kernels") -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path] = SOURCES,
          flags: Sequence[str] = NVCC_FLAGS,
          stem: str = "cmpc_kernels") -> dict:
    """Compile ``sources`` with ``flags`` into one library unless it exists
    (by default every ``csrc/*.cu``, the port's library). Returns
    ``{"path", "seconds", "built", "log"}``; ``log`` holds nvcc's output
    (register and shared-memory use from ``-Xptxas -v``)."""
    sources = tuple(Path(s) for s in sources)
    out = library_path(sources, flags, stem)
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "built": False, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [f"== {src.name}\n" + proc.communicate()[0]
                for src, proc in zip(sources, procs)]
        failed = [src.name for src, proc in zip(sources, procs)
                  if proc.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                   *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append("== link\n" + link.stdout + link.stderr)
            if link.returncode != 0:
                failed = ["link"]
        log = "".join(logs)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(out), "seconds": seconds, "built": True, "log": log}


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    lib = ctypes.CDLL(build()["path"])
    lib.cmpc_admm_epoch.argtypes = _ADMM_EPOCH_ARGS
    lib.cmpc_admm_epoch.restype = _I
    lib.cmpc_lqr_affine.argtypes = [_P] * 14 + [_I] * 8 + [_P]
    lib.cmpc_lqr_affine.restype = _I
    lib.cmpc_epoch_data.argtypes = _EPOCH_DATA_ARGS
    lib.cmpc_epoch_data.restype = _I
    for name in ("cmpc_nl_qp", "cmpc_mpcc_qp"):
        getattr(lib, name).argtypes = _SQP_QP_ARGS
        getattr(lib, name).restype = _I
    return lib


@functools.cache
def load_epoch_data_clocks(source: Optional[str] = None) -> ctypes.CDLL:
    """The clock-stamped epoch-data kernel: ``source`` (default
    ``csrc/epoch_data.cu``) alone, built with :data:`CLOCKS_FLAG` into a
    library of its own. It exports ``cmpc_epoch_data_clocked`` (the
    arguments of ``cmpc_epoch_data``, then the stamp buffer and its stamps
    per block), ``cmpc_epoch_data_clock_stamps(N, chunk)`` (stamps per
    block) and ``cmpc_epoch_data_clock_names()`` (the labels' names,
    separated by ``;``)."""
    src = Path(source) if source else _PKG / "csrc" / "epoch_data.cu"
    lib = ctypes.CDLL(build((src,), (*NVCC_FLAGS, CLOCKS_FLAG),
                            "cmpc_epoch_data_clocks")["path"])
    lib.cmpc_epoch_data_clocked.argtypes = _EPOCH_DATA_ARGS + [_P, _I]
    lib.cmpc_epoch_data_clocked.restype = _I
    lib.cmpc_epoch_data_clock_stamps.argtypes = [_I, _I]
    lib.cmpc_epoch_data_clock_stamps.restype = _I
    lib.cmpc_epoch_data_clock_names.argtypes = []
    lib.cmpc_epoch_data_clock_names.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_admm_epoch_clocks(source: Optional[str] = None) -> ctypes.CDLL:
    """The clock-stamped ADMM epoch kernel: ``source`` (default
    ``csrc/lqr_kernels.cu``) alone, built with :data:`ADMM_CLOCKS_FLAG`
    into a library of its own. It exports ``cmpc_admm_epoch_clocked`` (the
    arguments of ``cmpc_admm_epoch``, then the stamp buffer and its stamps
    per QP), ``cmpc_admm_epoch_clock_stamps(N, ring, epoch_len)`` (stamps
    per QP, at most) and ``cmpc_admm_epoch_clock_names()`` (the labels'
    names, separated by ``;``)."""
    src = Path(source) if source else _PKG / "csrc" / "lqr_kernels.cu"
    lib = ctypes.CDLL(build((src,), (*NVCC_FLAGS, ADMM_CLOCKS_FLAG),
                            "cmpc_admm_epoch_clocks")["path"])
    lib.cmpc_admm_epoch_clocked.argtypes = _ADMM_EPOCH_ARGS + [_P, _I]
    lib.cmpc_admm_epoch_clocked.restype = _I
    lib.cmpc_admm_epoch_clock_stamps.argtypes = [_I, _I, _I]
    lib.cmpc_admm_epoch_clock_stamps.restype = _I
    lib.cmpc_admm_epoch_clock_names.argtypes = []
    lib.cmpc_admm_epoch_clock_names.restype = ctypes.c_char_p
    return lib


def build_sqp_qp_clocks(source: Optional[str] = None) -> dict:
    """:func:`build` of the clock-stamped SQP build kernels alone
    (``source``, default ``csrc/sqp_qp.cu``)."""
    src = Path(source) if source else _PKG / "csrc" / "sqp_qp.cu"
    return build((src,), (*NVCC_FLAGS, SQP_CLOCKS_FLAG),
                 "cmpc_sqp_qp_clocks")


@functools.cache
def load_sqp_qp_clocks(source: Optional[str] = None) -> ctypes.CDLL:
    """The clock-stamped SQP build kernels: ``source`` (default
    ``csrc/sqp_qp.cu``) alone, built with :data:`SQP_CLOCKS_FLAG` into a
    library of its own. It exports ``cmpc_nl_qp_clocked`` and
    ``cmpc_mpcc_qp_clocked`` (the arguments of ``cmpc_nl_qp`` /
    ``cmpc_mpcc_qp``, then the stamp buffer and its stamps per block),
    ``cmpc_sqp_qp_clock_stamps()`` (stamps per block) and
    ``cmpc_sqp_qp_clock_names()`` (the labels' names, separated by
    ``;``)."""
    lib = ctypes.CDLL(build_sqp_qp_clocks(source)["path"])
    for name in ("cmpc_nl_qp_clocked", "cmpc_mpcc_qp_clocked"):
        getattr(lib, name).argtypes = _SQP_QP_ARGS + [_P, _I]
        getattr(lib, name).restype = _I
    lib.cmpc_sqp_qp_clock_stamps.argtypes = []
    lib.cmpc_sqp_qp_clock_stamps.restype = _I
    lib.cmpc_sqp_qp_clock_names.argtypes = []
    lib.cmpc_sqp_qp_clock_names.restype = ctypes.c_char_p
    return lib
