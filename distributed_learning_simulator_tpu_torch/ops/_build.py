"""Build the package's CUDA sources at first use and load them with ctypes.

``nvcc`` compiles ``csrc/<name>.cu`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, inside a build directory that
``.gitignore`` lists (``build/torch_kernels`` at the repository root, or
``$DLS_TORCH_BUILD_DIR``). The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. The build writes to a temporary name and renames it into place, so
two processes building at once never load a half-written file.

Nothing here runs at import: the CPU tests import every module of the port,
and ``nvcc`` runs only when a kernel is first launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, kept in the build log.
    "-Xptxas", "-v",
)


def build_dir() -> str:
    return os.environ.get(
        "DLS_TORCH_BUILD_DIR", os.path.join(_REPO_ROOT, "build", "torch_kernels")
    )


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", name))
    found = shutil.which(name)
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError(
        f"{name} not found (set CUDA_HOME or put it on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


#: Build logs (nvcc's stdout+stderr, including ``-Xptxas -v``) by source
#: name, for callers that want to print register and shared-memory use.
BUILD_LOGS: dict[str, str] = {}
#: Paths of the loaded libraries by source name (for cuobjdump).
LIB_PATHS: dict[str, str] = {}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{name}_{digest}.so")
    if not os.path.exists(lib_path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {src} (exit {proc.returncode}):\n"
                + proc.stdout + proc.stderr
            )
        os.replace(tmp, lib_path)
    else:
        BUILD_LOGS.setdefault(name, f"(reused {lib_path})")
    LIB_PATHS[name] = lib_path
    return ctypes.CDLL(lib_path)
