"""Build and bind the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is built at first use into ``footprints_tpu_torch/_build/`` and
rebuilt when the sources, the shared header or the flags change (the file
name carries their hash).  Each source compiles in its own ``nvcc``, all at
once, then one link; they include no PyTorch header, so a build takes
seconds.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
SOURCES = tuple(CSRC / f for f in ("fused_conv3x3.cu", "fused_conv3x3_dgrad.cu",
                                   "fused_conv3x3_wgrad.cu"))
HEADERS = (CSRC / "fused_conv3x3_common.cuh",)
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


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
    return hashed_path(BUILD_DIR, "footprints_kernels", NVCC_FLAGS, SOURCES + HEADERS)


def build(verbose=False):
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source, all started together, then one link.  Returns
    the library's path.  ``verbose`` adds ``-Xptxas -v`` (registers and
    spills per instantiation) and prints the compilers' output."""
    out = library_path()
    if out.exists():
        return out
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        def compile_one(src):
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc_path(), *flags, "-c", "-o", str(obj), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            return obj, proc.stdout + proc.stderr

        with ThreadPoolExecutor(len(SOURCES)) as pool:
            built = list(pool.map(compile_one, SOURCES))
        if verbose:
            print("".join(text for _, text in built))
        return compile_shared(nvcc_path, NVCC_FLAGS + ("-shared",),
                              [obj for obj, _ in built], out, verbose)


@functools.cache
def load_library():
    """Build if needed, load, and declare every exported function's types."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # dtype, x, w, w_stride, b, residual, y, N, Hi, Wi, Ci, Ho, Wo, Co,
    # pad_mode, act, stream
    lib.fused_conv3x3_launch.argtypes = (i, p, p, i, p, p, p, i, i, i, i, i,
                                         i, i, i, i, p)
    lib.fused_conv3x3_launch.restype = i
    # dtype, gz, w, w_stride, gx, N, H, W, Ci, Ho, Wo, Co, pad_mode, stream
    lib.fused_conv3x3_dgrad_launch.argtypes = (i, p, p, i, p, i, i, i, i, i, i, i, i, p)
    lib.fused_conv3x3_dgrad_launch.restype = i
    # N, H, W, Ci, Co, pad_mode -> f32 scratch elements
    lib.fused_conv3x3_wgrad_scratch.argtypes = (i, i, i, i, i, i)
    lib.fused_conv3x3_wgrad_scratch.restype = ll
    # dtype, gz, x, scratch, scratch elements, gw, N, H, W, Ci, Ho, Wo, Co,
    # pad_mode, stream
    lib.fused_conv3x3_wgrad_launch.argtypes = (i, p, p, p, ll, p, i, i, i, i, i, i, i, i, p)
    lib.fused_conv3x3_wgrad_launch.restype = i
    return lib
