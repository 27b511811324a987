"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

The sources in `rqvae_tpu_torch/csrc/*.cu` expose a plain C interface. At
first use they are compiled for Hopper (`sm_90a`) into one shared library
under `build/torch_kernels/<hash>/` at the repository root, keyed by a hash
of the sources and the flags, so a changed source rebuilds and an unchanged
one loads at once. Nothing here runs at import time. A missing `nvcc` or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "librqvae_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every function returns cudaGetLastError()
_SIGNATURES = {
    "rq_decode_attention_update": (_P,) * 6 + (_I,) * 6 + (_P,),
    "rq_fused_ln_qkv": (_P,) * 7 + (_I,) * 4 + (_F, _P),
    "rq_fused_proj_mlp": (_P,) * 14 + (_I,) * 7 + (_F, _P),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME or /usr/local/cuda): "
        "the CUDA kernels of rqvae_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, float]:
    """Compile the sources if their library is missing. Returns the library
    path and the seconds spent compiling (0.0 when it was already built)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    # -Xptxas -v reports registers, shared memory and spills per kernel
    (lib.parent / "ptxas.log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library with argtypes/restype set (built on first use)."""
    with _lock:
        if "lib" not in _loaded:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _loaded["lib"] = lib
        return _loaded["lib"]


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
