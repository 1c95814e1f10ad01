"""The native augmentation engine (port of ``xpoint_tpu/native``): the
homographic warp of an image, its valid mask and the mask's border erosion
in one C call (``augment.cpp``, this package's own copy of the JAX
package's source), bound through ctypes.

The library is built with g++ at first use, with the JAX package's flags

    g++ -O3 -march=native -ffast-math -funroll-loops -fPIC -shared -std=c++17

into ``build/xpoint_tpu_torch/libxpoint_native-<hash>.so``. The hash covers
the flags, the source and what ``-march=native`` resolves to on this host
(g++'s target options), so an edited source is rebuilt and a checkout
copied to a host with another CPU never loads a library built for the old
one. The compiler writes a file of its own name and the finished library is
moved into place, so processes building at once never load half a file.

Where this differs from the JAX package on purpose: there a failed build
or load returns None and the caller quietly takes the cv2 path. Here a
failed build raises with the compiler's message, and nothing falls back:
``data.augmentation`` takes the cv2 path only when ``XPOINT_NO_NATIVE`` is
set, the JAX package's own switch.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..kernels.build import BUILD_DIR

CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-ffast-math", "-funroll-loops",
             "-fPIC", "-shared", "-std=c++17"]
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "augment.cpp")

_lib = None
_lock = threading.Lock()


def _run(cmd, what):
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"{what}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def library_path():
    """The library's path for this source, these flags and this host's
    CPU (its ``-march=native``)."""
    digest = hashlib.sha256(" ".join([CXX] + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(_run([CXX, "-march=native", "-Q", "--help=target"],
                       "the native engine's target probe").encode())
    return os.path.join(BUILD_DIR,
                        f"libxpoint_native-{digest.hexdigest()[:12]}.so")


def build():
    """Compile ``augment.cpp`` unless its library exists; returns the
    library's path. Raises with the compiler's output if it fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    try:
        _run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE],
             "building the native engine (native/augment.cpp)")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load():
    """The engine's ctypes handle, built and typed at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.homographic_augment.restype = ctypes.c_int
            lib.homographic_augment.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.warp_keypoints.restype = None
            lib.warp_keypoints.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        return _lib


def available():
    """Whether the engine builds and loads on this host (the JAX package's
    check). The data path does not ask: it loads the engine and raises if
    that fails."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def homographic_augment(image, homography, border_reflect=True,
                        erosion_radius=0, mask_border=True):
    """Fused warp + valid mask (+ erosion) of one (H, W) image by a
    source-to-destination homography (cv2's x/y order). Returns (warped
    float32 (H, W), mask float64 (H, W)), as the JAX package's."""
    lib = load()
    src = np.ascontiguousarray(image, np.float32)
    H, W = src.shape
    dst = np.empty((H, W), np.float32)
    mask = np.empty((H, W), np.uint8)
    scratch = np.empty(2 * (H + 2) * (W + 2), np.uint8)
    h = np.ascontiguousarray(homography, np.float64)
    lib.homographic_augment(
        _ptr(src, ctypes.c_float), _ptr(dst, ctypes.c_float),
        _ptr(mask, ctypes.c_uint8), _ptr(scratch, ctypes.c_uint8), H, W,
        _ptr(h, ctypes.c_double), 1 if border_reflect else 0,
        int(erosion_radius), 1 if mask_border else 0)
    return dst, mask.astype(np.float64)


def warp_keypoints(keypoints, homography):
    """(n, 2) float (row, col) keypoints through the homography, as
    float64; an empty set gives None, as the JAX package's."""
    if len(keypoints) == 0:
        return None
    lib = load()
    kps = np.ascontiguousarray(keypoints, np.float64)
    out = np.empty_like(kps)
    h = np.ascontiguousarray(homography, np.float64)
    lib.warp_keypoints(_ptr(kps, ctypes.c_double), _ptr(out, ctypes.c_double),
                       len(kps), _ptr(h, ctypes.c_double))
    return out
