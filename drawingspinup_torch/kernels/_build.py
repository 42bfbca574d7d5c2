"""Lazy build of the port's CUDA kernels.

``extension()`` compiles ``csrc/`` with ``torch.utils.cpp_extension.load``
at its first call, for ``sm_90a`` (Hopper), into ``build/torch_kernels/``
at the root of the checkout, and returns the loaded module. Importing this
module builds nothing: the CPU tests import every module of the port on a
host without ``nvcc``.
"""
from __future__ import annotations

import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "bindings.cpp", _CSRC / "ric_conv_fwd_gemm.cu",
           _CSRC / "ric_conv_bwd.cu", _CSRC / "ric_conv_bwd_gemm.cu",
           _CSRC / "hashgrid_fwd.cu",
           _CSRC / "hashgrid_bwd.cu", _CSRC / "row_gather.cu",
           _CSRC / "pixel_rays.cu", _CSRC / "mv_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_lock = threading.Lock()
_ext = None


def extension():
    """The compiled kernel module, built on first use."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            # load() takes a lock file inside the directory; it must exist
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _ext = load(
                name="dsu_torch_kernels",
                sources=[str(s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O2"],
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                verbose=False)
        return _ext
