"""Build and load the port's CUDA kernels (plain C interface + ctypes).

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library at the first CUDA use — never at
import, so the package imports on hosts without a GPU toolchain. The
library lands in ``build/kernels/`` at the repository root, named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "pruning_mask.cu",)
# No --use_fast_math and no -ftz: the kernels pin their own rounding with
# __fmul_rn/__fadd_rn/__fsub_rn and flush denormals explicitly where the
# reference does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    # w, v, prunable, thr, n_clients, n, q, masks, stream
    "importance_masks": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                         _P, _P, _P),
    # w, grads, cw, n_clients, inv, eta, n, w_out, g_out, step_out, stream
    "fedsgd_aggregate_weighted": (_P, _P, _P, ctypes.c_int, _P, _P,
                                  ctypes.c_longlong, _P, _P, _P, _P),
    # q, prunable, n, hist, stream
    "exponent_histogram": (_P, _P, ctypes.c_longlong, _P, _P),
    # w, grads, n_clients, inv, eta, n, w_out, g_out, step_out, stream
    "fedsgd_aggregate": (_P, _P, ctypes.c_int, ctypes.c_float,
                         ctypes.c_float, ctypes.c_longlong, _P, _P, _P, _P),
    # w, g, mask, eta, n, out, stream
    "masked_update": (_P, _P, _P, ctypes.c_float, ctypes.c_longlong, _P, _P),
    # grads, cw, n_clients, n, out, keys (scratch for C > 32), stream
    "client_rank_sort": (_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _P,
                         _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


# src/repro_torch/kernels/_build.py -> <repository root>/build/kernels
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libpruning_mask_{_source_key()}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)                     # atomic: never a half-written .so
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
