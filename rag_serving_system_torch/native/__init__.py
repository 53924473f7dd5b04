"""The native host path: the tokenizer's C fast path (`hashtok.c`), the C++
epoll HTTP front (`httpfront.cc`, driven by `api/native_front.py`) and the
RESP server (`miniredis.cc`) that a Redis-free deployment and the tests run
against. The sources are copies of the JAX package's.

Each is built with the host compiler (CC, default `cc`; CXX, default `c++`)
at first use, into `build/torch_native/` at the repository root (listed in
.gitignore), never beside the sources. An output is named after a hash of
its source and its command, so an edited source rebuilds and an unchanged
one loads from disk. Builds run under a lock (a thread lock and an exclusive
`flock`, since several processes may ask at once), write to a temporary name
and rename it into place. A build that fails raises `NativeBuildError` with
the compiler's message. The libraries have plain C interfaces, loaded with
ctypes (their own handles: the JAX package's copies share no state with
them). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent
BUILD_DIR = _SRC.parents[1] / "build" / "torch_native"

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """The host compiler is missing or refused a source."""


def _command(source: str, out: str, shared: bool) -> list[str]:
    """The JAX package's `native/build.sh` line for `source`."""
    if source.endswith(".c"):
        return [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC", "-o", out,
                str(_SRC / source)]
    lib = ["-shared", "-fPIC", "-pthread"] if shared else []
    return [os.environ.get("CXX", "c++"), "-O2", "-std=c++17", *lib, "-o", out,
            str(_SRC / source)]


def build(source: str, stem: str, suffix: str = "") -> Path:
    """`source` built into BUILD_DIR as `<stem>_<hash><suffix>`, a shared
    library when `suffix` is ".so", else a program (once; later calls, in
    this process or another, find it on disk)."""
    shared = suffix == ".so"
    h = hashlib.sha256(" ".join(_command(source, "", shared)).encode())
    h.update((_SRC / source).read_bytes())
    path = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"
    with _lock:
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
            if path.exists():                  # another process built it meanwhile
                return path
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = _command(source, str(tmp), shared)
            try:
                out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(f"{' '.join(cmd)} failed ({out.returncode}):\n"
                                       f"{out.stderr}")
            os.replace(tmp, path)   # atomic: a loader sees all of it or nothing
    return path


def _load(name: str, source: str, declare) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(source, f"lib{name}", ".so")))
            declare(lib)
            _libs[name] = lib
        return _libs[name]


def _declare_hashtok(lib: ctypes.CDLL) -> None:
    lib.hashtok_encode.restype = ctypes.c_int
    lib.hashtok_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]


def _declare_httpfront(lib: ctypes.CDLL) -> None:
    lib.httpfront_start.restype = ctypes.c_int
    lib.httpfront_start.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.httpfront_stop.restype = None
    lib.httpfront_stop.argtypes = []
    lib.httpfront_drain.restype = ctypes.c_int
    lib.httpfront_drain.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.httpfront_complete.restype = None
    lib.httpfront_complete.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int]
    lib.httpfront_stats.restype = None
    lib.httpfront_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.httpfront_id_prefix.restype = ctypes.c_int
    lib.httpfront_id_prefix.argtypes = [ctypes.c_char_p, ctypes.c_int]


def get_hashtok_lib() -> ctypes.CDLL:
    """The tokenizer's C library (`hashtok_encode`), built on first call."""
    return _load("hashtok", "hashtok.c", _declare_hashtok)


def get_httpfront_lib() -> ctypes.CDLL:
    """The native HTTP front's library, built on first call. One front runs
    in a process at a time: the library's state is a singleton."""
    return _load("httpfront", "httpfront.cc", _declare_httpfront)


def get_miniredis_path() -> str:
    """The miniredis server binary (`<path> PORT` serves RESP on PORT), built
    on first call. Callers spawn it as a process of their own."""
    return str(build("miniredis.cc", "miniredis"))
