"""Native (C++) components, built from this directory's sources and loaded
with ctypes.

Counterpart of ``bluefog_tpu/native``.  The five sources beside this file
(``shm_mailbox.cc``, ``timeline.cc``, ``plan_compiler.cc``,
``layout_optimizer.cc``, ``data_loader.cc``) are the reference's; four are
unchanged, and ``timeline.cc`` adds one repair, a write lock in
``WriteFile`` (the flusher thread and ``Flush()`` shared the tmp path and
could leave an empty trace).  They use only the C++ standard library and
POSIX.  :func:`get_lib` compiles
them at first use with the reference's recipe (``g++ -O3 -std=c++17 -fPIC
-shared ... -lpthread -lrt``) into
``bluefog_tpu_torch/_build/native/libbluefog_native_<hash>.so``, named by a
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads at once.

A failed build raises with the compiler's output: nothing here falls back
quietly.  The shared-memory transport uses the pure-Python ``lockf`` classes
only when ``BLUEFOG_SHM_FALLBACK=1`` asks for them (see
:func:`bluefog_tpu_torch.native.shm_native.transport_kind`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_DIR)
BUILD_DIR = os.path.join(_PKG, "_build", "native")
SOURCES = ("timeline.cc", "plan_compiler.cc", "layout_optimizer.cc",
           "data_loader.cc", "shm_mailbox.cc")
# -O3: the chunked shm transport's scaled-copy / weighted-combine loops
# must auto-vectorize to keep pace with memcpy.  -lrt: glibc < 2.34 keeps
# shm_open/shm_unlink in librt.
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LDFLAGS = ("-lpthread", "-lrt")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: ``{"path", "seconds", "cxx", "cxx_version", "log"}`` of this process's
#: build (``seconds`` is about 0 when the cached library was reused)
build_info: dict = {}


def cxx_path() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(
            "no C++ compiler (g++) found: the native island mailbox is built "
            "from bluefog_tpu_torch/native/*.cc at first use")
    return cxx


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            digest.update(name.encode())
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libbluefog_native_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if its cached copy is missing; return its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    cxx = cxx_path()
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [cxx, *CXXFLAGS, "-o", tmp,
               *(os.path.join(_DIR, s) for s in SOURCES), *LDFLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise RuntimeError(
                f"building the native library failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, out)
    ver = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    build_info.update(path=out, seconds=time.perf_counter() - t0, cxx=cxx,
                      cxx_version=(ver.stdout.splitlines() or [""])[0], log=log)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use.  Raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare_abi(lib)
            _lib = lib
        return _lib


def loaded_lib() -> Optional[ctypes.CDLL]:
    """The library if this process has loaded it already, else None (for
    best-effort paths such as segment cleanup, which never start a build)."""
    return _lib


def _declare_abi(lib: ctypes.CDLL) -> None:
    i64, f64, i32, vp = ctypes.c_int64, ctypes.c_double, ctypes.c_int32, ctypes.c_void_p
    p64, pf64 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
    sigs = {
        # timeline
        "bf_timeline_create": (vp, [ctypes.c_char_p]),
        "bf_timeline_record": (None, [vp, ctypes.c_char_p, f64, f64, i64]),
        "bf_timeline_counter": (None, [vp, ctypes.c_char_p, f64, f64]),
        "bf_timeline_flush": (None, [vp]),
        "bf_timeline_destroy": (None, [vp]),
        # plan compiler
        "bf_plan_compile": (i64, [i64, i64, p64, p64, p64, p64]),
        # data loader
        "bf_loader_create": (vp, [i64, i64, i64, i64, ctypes.c_uint64,
                                  ctypes.c_char_p]),
        "bf_loader_next": (vp, [vp]),
        "bf_loader_release": (None, [vp, vp]),
        "bf_loader_stats": (None, [vp, ctypes.POINTER(ctypes.c_uint64)]),
        "bf_loader_destroy": (None, [vp]),
        # shm mailbox (protocol v2: chunk-ring seqlocks, drained markers,
        # fused scale/combine)
        "bf_shm_abi_version": (i32, []),
        "bf_shm_job_create": (vp, [ctypes.c_char_p, i64, i64]),
        "bf_shm_job_barrier": (None, [vp]),
        "bf_shm_job_barrier_timeout": (i32, [vp, i64]),
        "bf_shm_job_heartbeat": (None, [vp, i64]),
        "bf_shm_job_liveness": (i64, [vp, i64]),
        "bf_shm_monotonic_ms": (i64, []),
        "bf_shm_job_mutex_acquire": (None, [vp, i64]),
        "bf_shm_job_mutex_acquire_timeout": (i32, [vp, i64, i64]),
        "bf_shm_job_mutex_break": (None, [vp, i64]),
        "bf_shm_job_mutex_release": (None, [vp, i64]),
        "bf_shm_job_destroy": (None, [vp, i32]),
        "bf_shm_win_create": (vp, [ctypes.c_char_p, i64, i64, i64, i64, i32,
                                   i64]),
        "bf_shm_win_write": (None, [vp, i64, i64, vp, f64, i32, f64]),
        "bf_shm_win_read": (i64, [vp, i64, vp, pf64, i32]),
        "bf_shm_win_combine": (i64, [vp, i64, vp, f64, i32, pf64]),
        "bf_shm_win_probe": (i32, [vp, i64, vp, vp, i64]),
        "bf_shm_win_put_dual": (None, [vp, i64, i64, vp, f64, i32, f64, f64]),
        "bf_shm_win_update_fused": (f64, [vp, i64, p64, pf64, vp, f64, f64,
                                          vp, i32, i32]),
        "bf_shm_win_exposed_offset": (i64, [vp]),
        "bf_shm_win_reset": (None, [vp, i64]),
        "bf_shm_win_force_drain": (None, [vp, i64]),
        "bf_shm_win_expose": (None, [vp, vp, f64]),
        "bf_shm_win_read_exposed": (i64, [vp, i64, vp, pf64]),
        "bf_shm_win_destroy": (None, [vp, i32]),
        "bf_shm_unlink": (None, [ctypes.c_char_p]),
        # layout optimizer
        "bf_layout_anneal": (f64, [i64, i64, p64, p64, i64, p64, p64, pf64,
                                   i64, ctypes.c_uint64, p64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
