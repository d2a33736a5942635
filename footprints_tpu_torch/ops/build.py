"""Build and bind the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is built at first use into ``footprints_tpu_torch/_build/`` and
rebuilt when the sources, the shared header or the flags change (the file
name carries their hash).  Each source compiles in its own ``nvcc``, all at
once, then one link; they include no PyTorch header, so a build takes
seconds.
Pointers and the stream cross as ``c_void_p``; each launch function returns
``cudaGetLastError()``.  ``build_probe`` builds the three sources again
under ``-DFOOTPRINTS_PROBE`` into a library of their own for the clock64()
probe (``ops/probe.py``); nothing else loads it.  ``hashed_path``
and ``compile_shared`` also build the host-side resampler of ``native/``
(``footprints_tpu_torch/native``).
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


PROBE_SOURCES = SOURCES  # the forward and the backward's two kernels
PROBE_FLAGS = NVCC_FLAGS + ("-DFOOTPRINTS_PROBE",)


def library_path():
    return hashed_path(BUILD_DIR, "footprints_kernels", NVCC_FLAGS, SOURCES + HEADERS)


def probe_library_path():
    return hashed_path(BUILD_DIR, "footprints_probe", PROBE_FLAGS, PROBE_SOURCES + HEADERS)


def _build(out, sources, flags, verbose):
    """Compile ``sources`` with ``flags`` into ``out`` unless it exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    if out.exists():
        return out
    flags = flags + (("-Xptxas", "-v") if verbose else ())
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

        with ThreadPoolExecutor(len(sources)) as pool:
            built = list(pool.map(compile_one, sources))
        if verbose:
            print("".join(text for _, text in built))
        return compile_shared(nvcc_path, NVCC_FLAGS + ("-shared",),
                              [obj for obj, _ in built], out, verbose)


def build(verbose=False):
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source, all started together, then one link.  Returns
    the library's path.  ``verbose`` adds ``-Xptxas -v`` (registers and
    spills per instantiation) and prints the compilers' output."""
    return _build(library_path(), SOURCES, NVCC_FLAGS, verbose)


def build_probe(verbose=False):
    """The clock64() probe's library (ops/probe.py): the three sources
    built again under ``-DFOOTPRINTS_PROBE`` (under which the backward's two
    instantiate only the kernels of the probe's sites, 64 input channels;
    the forward all of its own) into a library of their own, which no path
    but the probe loads."""
    return _build(probe_library_path(), PROBE_SOURCES, PROBE_FLAGS, verbose)


def declare_forward(lib):
    """Declare the types of the forward's exported functions in ``lib``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # dtype, Ci, Co, pad_mode -> bytes of packed weights
    lib.fused_conv3x3_scratch.argtypes = (i, i, i, i)
    lib.fused_conv3x3_scratch.restype = ll
    # dtype, w, w_stride, Ci, Co, pad_mode, packed, stream
    lib.fused_conv3x3_pack.argtypes = (i, p, i, i, i, i, p, p)
    lib.fused_conv3x3_pack.restype = i
    # dtype, x, w, w_stride, b, residual, packed, packed bytes, y, N, Hi, Wi,
    # Ci, Ho, Wo, Co, pad_mode, act, stream
    lib.fused_conv3x3_launch.argtypes = (i, p, p, i, p, p, p, ll, p, i, i, i, i, i, i, i, i, i,
                                         p)
    lib.fused_conv3x3_launch.restype = i


def _declare(lib):
    """Declare the types of every exported launch function of ``lib``."""
    declare_forward(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # dtype, Ci, Co, pad_mode -> bytes of packed weights
    lib.fused_conv3x3_dgrad_scratch.argtypes = (i, i, i, i)
    lib.fused_conv3x3_dgrad_scratch.restype = ll
    # dtype, w, w_stride, Ci, Co, pad_mode, packed, stream
    lib.fused_conv3x3_dgrad_pack.argtypes = (i, p, i, i, i, i, p, p)
    lib.fused_conv3x3_dgrad_pack.restype = i
    # dtype, gz, w, w_stride, packed, packed bytes, gx, N, H, W, Ci, Ho, Wo,
    # Co, pad_mode, stream
    lib.fused_conv3x3_dgrad_launch.argtypes = (i, p, p, i, p, ll, p, i, i, i, i, i, i, i, i, p)
    lib.fused_conv3x3_dgrad_launch.restype = i
    # dtype, N, H, W, Ci, Co, pad_mode -> f32 scratch elements
    lib.fused_conv3x3_wgrad_scratch.argtypes = (i, i, i, i, i, i, i)
    lib.fused_conv3x3_wgrad_scratch.restype = ll
    # dtype, gz, x, scratch, scratch elements, gw, N, H, W, Ci, Ho, Wo, Co,
    # pad_mode, stream
    lib.fused_conv3x3_wgrad_launch.argtypes = (i, p, p, p, ll, p, i, i, i, i, i, i, i, i, p)
    lib.fused_conv3x3_wgrad_launch.restype = i


@functools.cache
def load_library():
    """Build if needed, load, and declare every exported function's types."""
    lib = ctypes.CDLL(str(build()))
    _declare(lib)
    return lib


@functools.cache
def load_probe_library():
    """Build the probe's library if needed and load it (its own symbols:
    ctypes loads it RTLD_LOCAL beside the main library)."""
    lib = ctypes.CDLL(str(build_probe()))
    _declare(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # stamp buffer, its room in blocks
    for name in ("fused_conv3x3_probe_set", "fused_conv3x3_dgrad_probe_set",
                 "fused_conv3x3_wgrad_probe_set"):
        getattr(lib, name).argtypes = (p, ll)
        getattr(lib, name).restype = i
    # dtype, N, H, W, Ci, Co, pad_mode -> the forward's main kernel's blocks
    lib.fused_conv3x3_probe_blocks.argtypes = (i, i, i, i, i, i, i)
    lib.fused_conv3x3_probe_blocks.restype = ll
    # dtype, N, H, W, Ci, pad_mode -> the main kernel's blocks
    lib.fused_conv3x3_dgrad_probe_blocks.argtypes = (i, i, i, i, i, i)
    lib.fused_conv3x3_dgrad_probe_blocks.restype = ll
    # dtype, N, H, W, Ci, Co, pad_mode -> the partial kernel's blocks
    lib.fused_conv3x3_wgrad_probe_blocks.argtypes = (i, i, i, i, i, i, i)
    lib.fused_conv3x3_wgrad_probe_blocks.restype = ll
    return lib
