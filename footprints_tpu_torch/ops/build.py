"""Build and bind the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is built at first use into ``footprints_tpu_torch/_build/`` and
rebuilt when the sources or flags change (the file name carries their
hash).  The sources include no PyTorch header, so a build takes seconds.
Pointers and the stream cross as ``c_void_p``; each launch function returns
``cudaGetLastError()``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCES = (PKG_DIR / "csrc" / "fused_conv3x3.cu",)
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built at first use")


def library_path():
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"footprints_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose=False):
    """Compile the sources unless the library for their hash exists.
    Returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load_library():
    """Build if needed, load, and declare every exported function's types."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtype, x, w, w_stride, b, residual, y, N, Hi, Wi, Ci, Ho, Wo, Co,
    # pad_mode, act, stream
    lib.fused_conv3x3_launch.argtypes = (i, p, p, i, p, p, p, i, i, i, i, i,
                                         i, i, i, i, p)
    lib.fused_conv3x3_launch.restype = i
    return lib
