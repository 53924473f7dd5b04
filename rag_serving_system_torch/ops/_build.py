"""Build the CUDA kernels in `csrc/` with nvcc and bind them with ctypes.

The sources compile at first use, one nvcc process per source, all started
together, and link into one shared library with a plain C interface, under
`build/torch_kernels/` at the repository root (listed in .gitignore). The
library's name carries a hash of the sources, headers and flags, so an
edited kernel rebuilds and an unchanged one loads from disk. Nothing here
runs at import time: the CPU tests import every module without nvcc.
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
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("topk.cu", "topk_int8.cu", "select.cu", "probes.cu", "flash_attention.cu")
HEADERS = ("topk_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# every pointer and the stream are c_void_p: a default int would cut them
_SIGNATURES = {
    "rag_cosine_topk": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                        _P],
    "rag_cosine_topk_int8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P, _P],
    "rag_score_rows": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "rag_score_rows_int8": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "rag_int8_tile_info": [_I, _I, _P],
    "rag_select_topk": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P],
    "rag_stream_probe": [_P, _I, _I, _I, _I, _P, _P, _P],
    "rag_dot_probe": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "rag_dot_probe_int8_info": [_I, _P],
    "rag_flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, ctypes.c_float, _P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # nvcc wall time of this process's build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of rag_serving_system_torch cannot be built")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{err}")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librag_kernels_{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
            nvcc = _nvcc()
            t0 = time.perf_counter()
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                      for s, o in zip(SOURCES, objs)])
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
            build_seconds = time.perf_counter() - t0
            for o in objs:
                o.unlink()
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's launch count, under a lock: the model
    positions of a mesh launch from threads of their own."""
    with _count_lock:
        wrapper.launches += 1
