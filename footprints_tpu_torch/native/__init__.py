"""ctypes binding of the repository's host-side image resampler,
``native/fp_image.cpp`` (counterpart of footprints_tpu/native/__init__.py).

The source belongs to neither package.  This binding builds it with ``g++``
at first use into ``footprints_tpu_torch/_build/`` (never into ``native/``),
through ``ops/build.py``'s cache: the file name carries the hash of the
source and the flags, so a changed source builds anew.  The flags are
``native/Makefile``'s without ``-march=native``: the library then runs on
any x86-64 host that a checkout's ``_build/`` may move to, and its bytes do
not depend on the CPU that built it.

The LANCZOS resampler is Pillow's fixed-point scheme and equals
``PIL.Image.resize(..., LANCZOS)`` byte for byte.  Unlike the JAX binding,
a failed build raises with its cause instead of returning None: the data
path that asks for the native resize (``FOOTPRINTS_NATIVE_RESIZE=1``, see
data/base.py) gets it or an error, never a quiet PIL fallback.
"""

import ctypes
import functools
import shutil
from pathlib import Path

import numpy as np

from ..ops.build import compile_shared, hashed_path

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "fp_image.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")


def compiler():
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the native resampler is "
                           "built at first use")
    return found


def library_path():
    return hashed_path(BUILD_DIR, "fp_image", CXX_FLAGS, (SOURCE,))


def build():
    """Compile the source unless the library for its hash exists.  Returns
    the library's path; raises with the compiler's output if it fails."""
    return compile_shared(compiler, CXX_FLAGS, (SOURCE,), library_path())


@functools.cache
def load_library():
    """Build if needed, load, and declare every exported function's types."""
    lib = ctypes.CDLL(str(build()))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    lib.fp_resize_lanczos_u8.argtypes = (u8, i, i, i, u8, i, i)
    lib.fp_resize_lanczos_u8.restype = None
    lib.fp_resize_lanczos_u8_to_f32.argtypes = (u8, i, i, i, f32, i, i)
    lib.fp_resize_lanczos_u8_to_f32.restype = None
    lib.fp_resize_nearest_f32.argtypes = (f32, i, i, f32, i, i)
    lib.fp_resize_nearest_f32.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here (the cause of a failure
    is raised by ``load_library``)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _image(image):
    """uint8 [H,W,C] (or [H,W], as one channel), C-contiguous."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3:
        raise ValueError(f"expected an [H,W] or [H,W,C] image, got {image.shape}")
    return image


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resize_lanczos(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 [H,W,C] -> uint8 [height,width,C], equal to PIL's LANCZOS."""
    image = _image(image)
    sh, sw, ch = image.shape
    out = np.empty((height, width, ch), np.uint8)
    load_library().fp_resize_lanczos_u8(_ptr(image, ctypes.c_uint8), sh, sw, ch,
                                        _ptr(out, ctypes.c_uint8), height, width)
    return out


def resize_lanczos_f32(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 [H,W,C] -> float32 [height,width,C] in [0,1] (the resize and
    the conversion in one pass)."""
    image = _image(image)
    sh, sw, ch = image.shape
    out = np.empty((height, width, ch), np.float32)
    load_library().fp_resize_lanczos_u8_to_f32(
        _ptr(image, ctypes.c_uint8), sh, sw, ch, _ptr(out, ctypes.c_float),
        height, width)
    return out


def resize_nearest_f32(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """float32 [H,W] -> float32 [height,width], nearest neighbour (equal to
    cv2.INTER_NEAREST)."""
    arr = np.ascontiguousarray(arr, np.float32)
    if arr.ndim != 2:
        raise ValueError(f"expected an [H,W] array, got {arr.shape}")
    out = np.empty((height, width), np.float32)
    load_library().fp_resize_nearest_f32(_ptr(arr, ctypes.c_float), arr.shape[0],
                                         arr.shape[1], _ptr(out, ctypes.c_float),
                                         height, width)
    return out
