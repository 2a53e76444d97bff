"""Build and load the native libraries under csrc/.

csrc/Makefile is the one recipe: `build(target)` runs `make -C csrc
<target>`, which rebuilds the library only when one of its tracked
sources is newer, so calling it on every first use is cheap. The
libraries land in csrc/ next to their sources (ignored by git).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

CPU_LIB = "libminiro.so"       # OBJ parser + binned-SAH builder
CUDA_LIB = "libbvh_trace.so"   # GPU BVH traversal (XLA FFI handler)


def _make_vars(target: str) -> list[str]:
    if target != CUDA_LIB:
        return []
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    import jax.ffi
    return [f"NVCC={nvcc}", f"PYTHON={sys.executable}",
            f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"]


def build(target: str) -> str:
    """Bring csrc/<target> up to date and return its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    res = subprocess.run(["make", "-C", CSRC, target] + _make_vars(target),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building csrc/{target} failed:\n"
                           f"{res.stdout}{res.stderr}")
    return os.path.join(CSRC, target)


def load(target: str) -> ctypes.CDLL:
    """Build (if stale) and dlopen csrc/<target>."""
    return ctypes.CDLL(build(target))
