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
SOURCES = tuple(_CSRC / name for name in (
    "pruning_mask.cu", "flash_attention.cu", "flash_attention_bwd.cu",
    "decode_attention.cu", "ssd_chunk.cu"))
HEADERS = (_CSRC / "common.cuh", _CSRC / "tma.cuh", _CSRC / "wgmma.cuh")
# No --use_fast_math and no -ftz: the kernels pin their own rounding with
# __fmul_rn/__fadd_rn/__fsub_rn and flush denormals explicitly where the
# reference does. -Xptxas -v reports each kernel's registers and spills,
# kept beside the library (ptxas_report).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64S = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # w, v, prunable, thr, n_clients, n, q, masks, stream
    "importance_masks": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                         _P, _P, _P),
    # w, grads, cw, n_clients, inv, eta, n, w_out, g_out, step_out, stream
    "fedsgd_aggregate_weighted": (_P, _P, _P, ctypes.c_int, _P, _P,
                                  ctypes.c_longlong, _P, _P, _P, _P),
    # q, prunable, n, state (bins + ticket), hist, stream
    "exponent_histogram": (_P, _P, ctypes.c_longlong, _P, _P, _P),
    # w, v, prunable, thr, n, q, mask, stream
    "importance_mask_2d": (_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P),
    # w, grads, n_clients, inv, eta, n, w_out, g_out, step_out, stream
    "fedsgd_aggregate": (_P, _P, ctypes.c_int, ctypes.c_float,
                         ctypes.c_float, ctypes.c_longlong, _P, _P, _P, _P),
    # w, g, mask, eta, n, out, stream
    "masked_update": (_P, _P, _P, ctypes.c_float, ctypes.c_longlong, _P, _P),
    # grads, cw, n_clients, n, out, keys (scratch for C > 32), stream
    "client_rank_sort": (_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _P,
                         _P),
    # q, k, v, o, lse (or null), dims[6], strides[12], maps[33] (or
    # null), is_bf16, causal, window, cap, scale, stream
    "flash_attention": (_P, _P, _P, _P, _P, _I64S, _I64S, _I64S,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, ctypes.c_float, _P),
    # q, k, v, o, dO, lse, delta, dq, dk, dv, dims[6], strides[24],
    # is_bf16, causal, window, cap, scale, stream
    "flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64S,
                            _I64S, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_float, ctypes.c_float, _P),
    # q, k, v, pos, o, part, tickets, dims[6], strides[10], is_bf16,
    # scale, stream
    "decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I64S, _I64S,
                         ctypes.c_int, ctypes.c_float, _P),
    # x, b, c, dt, a_log, y, state, decay, dims[5], strides[13], is_bf16,
    # stream
    "ssd_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _I64S, _I64S,
                  ctypes.c_int, _P),
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
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_source_key()}.so"


def ptxas_report_path() -> pathlib.Path:
    """ptxas's report (registers, spills per kernel) of the built library."""
    return library_path().with_suffix(".ptxas.txt")


def _check_nvcc(cmd, returncode, stdout, stderr) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{stdout}{stderr}")


def build() -> pathlib.Path:
    """Compile the sources unless the hashed library already exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outputs = [p.communicate() for p in procs]   # wait for all of them
        for cmd, p, (so, se) in zip(cmds, procs, outputs):
            _check_nvcc(cmd, p.returncode, so, se)
        ptxas_report_path().write_text("".join(so + se for so, se in outputs))
        lib = pathlib.Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, proc.returncode, proc.stdout, proc.stderr)
        os.replace(lib, out)                 # atomic: never a half-written .so
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


def launch(name: str, *args) -> None:
    """Call the library's C entry point `name` (it launches on the stream
    passed last and returns cudaGetLastError()); raise if it failed."""
    err = getattr(load(), name)(*args)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def int64s(values) -> ctypes.Array:
    """A host int64 array for a `const long long*` argument."""
    values = [int(v) for v in values]
    return (ctypes.c_longlong * len(values))(*values)


def stream_of(t) -> int:
    """The current CUDA stream of t's device, as a pointer-sized int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
