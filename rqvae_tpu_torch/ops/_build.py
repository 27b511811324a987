"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

The sources in `rqvae_tpu_torch/csrc/*.cu` expose a plain C interface. At
first use each is compiled for Hopper (`sm_90a`) into a shared library of
its own, all nvcc processes started together, under
`build/torch_kernels/<hash>/` at the repository root, keyed by a hash of the
sources and the flags, so a changed source rebuilds and an unchanged one
loads at once. Nothing here runs at import time. A missing `nvcc` or a
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# csrc/fused_layer.cuh: kMaxSplits (the partial-sum workspace holds this
# many splits) and kMaxWindow (the most cache rows whose scores each warp
# of a fused kernel keeps in shared memory)
MAX_SPLITS = 8
MAX_WINDOW = 4223

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every function returns cudaGetLastError()
_SIGNATURES = {
    "rq_decode_attention_update": (_P,) * 6 + (_I,) * 6 + (_P,),
    "rq_decode_attention": (_P,) * 6 + (_I,) * 6 + (_P,),
    "rq_decode_attention_q8_update": (_P,) * 8 + (_I,) * 6 + (_P,),
    "rq_decode_attention_q8": (_P,) * 8 + (_I,) * 6 + (_P,),
    "rq_attention_tma_update": (_P,) * 6 + (_I,) * 11 + (_P,),
    "rq_attention_tma_q8_update": (_P,) * 8 + (_I,) * 11 + (_P,),
    "rq_attention_tma_read": (_P,) * 6 + (_I,) * 11 + (_P,),
    "rq_attention_tma_q8_read": (_P,) * 8 + (_I,) * 11 + (_P,),
    "rq_attention_tma_smem": (_I,) * 7,
    "rq_attention_tma_phase_ns": (_P,),
    "rq_fused_ln_qkv": (_P,) * 8 + (_I,) * 9 + (_F, _P),
    "rq_fused_ln_qkv_splitk": (_P,) * 7 + (_I,) * 4 + (_F, _P),
    "rq_fused_ln_qkv_q8_splitk": (_P,) * 8 + (_I,) * 4 + (_F, _P),
    "rq_fused_proj_mlp": (_P,) * 19 + (_I,) * 11 + (_F, _P),
    "rq_fused_proj_mlp_splitk": (_P,) * 14 + (_I,) * 7 + (_F, _P),
    "rq_dense_tensor_map": (_P,) + (_I,) * 4 + (_P,),
    "rq_dense_max_clusters": (_I,) * 5 + (_P,),
    "rq_dense_phase_ns": (_P,),
    "rq_fused_layer_step": (_P,) * 24 + (_I,) * 14 + (_F, _P),
    "rq_fused_attn_wo": (_P,) * 18 + (_I,) * 12 + (_F, _P),
    "rq_fused_max_clusters": (_I,) * 5 + (_P,),
    "rq_fused_phase_ns": (_P,),
    "rq_fused_proj_mlp_q8_splitk": (_P,) * 17 + (_I,) * 7 + (_F, _P),
    "rq_nearest_code": (_P,) * 10 + (_I,) * 5 + (_P,),
    "rq_decode_layer_step": (_P,) * 17 + (_I,) * 8 + (_F, _P),
    "rq_decode_attention_q8_update_wo": (_P,) * 16 + (_I,) * 7 + (_F, _P),
    "rq_decode_layer_step_phase_ns": (_P,),
    "rq_decode_attention_q8_update_wo_phase_ns": (_P,),
    "rq_q8_ring_mlp": (_P,) * 18 + (_I,) * 11 + (_F, _P),
    "rq_stream_probe": (_P,) * 3 + (_I,) * 9 + (_P,),
    "rq_stream_probe_phase_ns": (_P,),
    "rq_w8a8_mlp": (_P,) * 20 + (_I,) * 7 + (_F, _P),
    "rq_mlp": (_P,) * 10 + (_I,) * 7 + (_F, _P),
    "rq_dense_mlp": (_I,) + (_P,) * 11 + (_I,) * 14 + (_F, _P),
    "rq_dense_mlp_max_clusters": (_I,) * 5 + (_P,),
    "rq_dense_mlp_phase_ns": (_P,),
    "rq_dense_w8a8": (_P,) * 24 + (_I,) * 11 + (_F, _P),
    "rq_dense_w8a8_max_clusters": (_I,) * 3 + (_P,),
    "rq_dense_w8a8_phase_ns": (_P,),
}

_lock = threading.Lock()
_loaded: dict[str, SimpleNamespace] = {}


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


def build_dir() -> Path:
    """Where the libraries for the current sources live (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(src: Path) -> Path:
    return build_dir() / f"lib{src.stem}.so"


def _compile(src: Path) -> tuple[str, str, float]:
    """nvcc one source into its library: (source name, compiler output, seconds)."""
    tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, _lib_path(src))  # atomic: a concurrent process never loads a partial file
    return src.name, res.stdout + res.stderr, seconds


def build() -> tuple[Path, float, dict[str, float]]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns the build directory, the wall
    seconds of the build and each source's own nvcc seconds (0.0 and {}
    when everything was already built); the -Xptxas -v reports go to
    <build dir>/ptxas.log."""
    out = build_dir()
    todo = [src for src in sorted(CSRC.glob("*.cu")) if not _lib_path(src).exists()]
    if not todo:
        return out, 0.0, {}
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(todo)) as pool:
        done = list(pool.map(_compile, todo))
    seconds = time.perf_counter() - t0
    # -Xptxas -v reports registers, shared memory and spills per kernel
    (out / "ptxas.log").write_text("\n".join(f"== {name}\n{text}" for name, text, _ in done))
    return out, seconds, {name: s for name, _, s in done}


def library() -> SimpleNamespace:
    """The C entry points of every kernel library, argtypes/restype set,
    as attributes (built on first use)."""
    with _lock:
        if "lib" not in _loaded:
            build()
            fns = {}
            for src in sorted(CSRC.glob("*.cu")):
                lib = ctypes.CDLL(str(_lib_path(src)))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name, None)
                    if fn is not None:
                        fn.argtypes = list(argtypes)
                        fn.restype = ctypes.c_int
                        fns[name] = fn
            _loaded["lib"] = SimpleNamespace(**fns)
        return _loaded["lib"]


MAX_STAMPS = 16  # at least the globaltimer stamps any kernel's phase entry point copies out


def stamps_ns(name: str) -> list[int]:
    """The globaltimer stamps (ns) that a fused kernel's last launch left,
    read through its C entry point `name` (rq_decode_layer_step_phase_ns,
    ..._q8_update_wo_phase_ns, rq_dense_phase_ns, rq_fused_phase_ns,
    rq_dense_mlp_phase_ns, rq_stream_probe_phase_ns), which
    copies at most MAX_STAMPS of them. Synchronous: call it after the
    launch has finished."""
    buf = (ctypes.c_ulonglong * MAX_STAMPS)()
    check(getattr(library(), name)(ctypes.cast(buf, ctypes.c_void_p)), name)
    return list(buf)


def phase_us(name: str, n: int) -> list[float]:
    """The microseconds between the first n stamps of stamps_ns(name): a
    fused kernel's phases, in order."""
    buf = stamps_ns(name)
    return [(buf[i + 1] - buf[i]) / 1e3 for i in range(n - 1)]


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
