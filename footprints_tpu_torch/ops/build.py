"""Build and bind the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is built at first use into ``footprints_tpu_torch/_build/`` and
rebuilt when the sources or flags change (the file name carries their
hash).  The sources include no PyTorch header, so a build takes seconds.
Pointers and the stream cross as ``c_void_p``; each launch function returns
``cudaGetLastError()``.  ``hashed_path`` and ``compile_shared`` also build
the host-side resampler of ``native/`` (``footprints_tpu_torch/native``).
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


def hashed_path(build_dir, stem, flags, sources):
    """``<build_dir>/<stem>_<hash>.so``: the name carries the hash of the
    sources and the flags, so a changed source or flag builds anew."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(flags).encode())
    return Path(build_dir) / f"{stem}_{digest.hexdigest()[:16]}.so"


def compile_shared(compiler, flags, sources, out, verbose=False):
    """Compile ``sources`` with ``flags`` into the shared library ``out``
    unless it exists; returns ``out``.  ``compiler()`` gives the compiler's
    path and is called only when a build is needed.  Raises with the
    compiler's output if it fails."""
    out = Path(out)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [compiler(), *flags, "-o", tmp, *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library_path():
    return hashed_path(BUILD_DIR, "footprints_kernels", NVCC_FLAGS, SOURCES)


def build(verbose=False):
    """Compile the sources unless the library for their hash exists.
    Returns the library's path.  ``verbose`` adds ``-Xptxas -v`` (registers
    and spills per instantiation) and prints the compiler's output."""
    return compile_shared(nvcc_path, NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ()),
                          SOURCES, library_path(), verbose)


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
