"""The JAX package's native library, made loadable for the port's parity
tests.

``drawingspinup_tpu.native`` builds ``native/build/libdsu_native.so`` with
``make`` on first use and latches the outcome per process. Under pytest-xdist
several workers start that build in the same directory at once, at
collection: a worker whose build or load loses the race keeps ``_lib =
None`` for the rest of the session, and may even hold a mapping of a
half-written library that the dynamic loader hands back for that path from
then on. ``ensure_jax_native()`` takes a file lock under the git-ignored
``build/``, checks in a fresh process that the library loads with every
symbol the JAX loader binds, rebuilds it with ``native/Makefile``'s flags
under a temporary name moved into place when it does not (a reader never
sees a half-written file), then resets the calling process's latch and
loads it again; where this process still holds a stale mapping, it points
the loader at a private copy of the library.
"""
from __future__ import annotations

import fcntl
import glob
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")
LIB = os.path.join(NATIVE_DIR, "build", "libdsu_native.so")
LOCK = os.path.join(REPO, "build", "jax_native.lock")
PRIVATE_DIR = os.path.join(REPO, "build", "jax_native")
# native/Makefile's CXXFLAGS, compile and link in one call
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-Wextra", "-shared")
# every symbol drawingspinup_tpu/native/__init__.py binds
SYMBOLS = ("dsu_telea_inpaint", "dsu_decimate", "dsu_rasterize",
           "dsu_raycast_z", "dsu_gaussian3d", "dsu_march_tets_run",
           "dsu_march_tets_fetch", "dsu_march_tets_run_u8",
           "dsu_decimate_fast")


def _whole(path: str) -> bool:
    """Whether ``path`` loads with every symbol, checked in a fresh process
    (this one may hold a stale mapping of the same path)."""
    if not os.path.exists(path):
        return False
    code = (f"import ctypes; lib = ctypes.CDLL({path!r}); "
            f"[getattr(lib, s) for s in {SYMBOLS!r}]")
    return subprocess.run([sys.executable, "-c", code],
                          capture_output=True, timeout=120).returncode == 0


def _build() -> None:
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    srcs = sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cc")))
    out = subprocess.run(["g++", *CXXFLAGS, *srcs, "-o", tmp],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"building {LIB} failed:\n{out.stderr}")
    os.replace(tmp, LIB)


def _reload(native) -> bool:
    with native._lock:
        native._tried, native._lib = False, None
    return native.available()


def ensure_jax_native(attempts: int = 3) -> None:
    """Make ``drawingspinup_tpu.native`` usable in this process, or raise
    with the compiler's output."""
    from drawingspinup_tpu import native

    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    err = None
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for i in range(attempts):
            if not _whole(LIB):
                try:
                    _build()
                except RuntimeError as e:
                    err = e
                    time.sleep(0.5 * (i + 1))
                    continue
            if _reload(native):
                return
            # this process maps a stale library at LIB: load a private copy
            os.makedirs(PRIVATE_DIR, exist_ok=True)
            private = os.path.join(PRIVATE_DIR,
                                   f"libdsu_native-{os.getpid()}-{i}.so")
            shutil.copyfile(LIB, private)
            native._LIB_PATH = private
            if _reload(native):
                return
            time.sleep(0.5 * (i + 1))
    raise RuntimeError(f"drawingspinup_tpu's native library does not load "
                       f"after {attempts} attempts") from err
