"""The warps of homographic adaptation's warp -> forward -> unwarp loop (the
counterpart of ``xpoint_tpu/ops/warp_tiled.py``'s two entry points).

On a CUDA tensor each call is one launch of the Hopper kernel
``csrc/warp_projective.cu`` (replacing the TPU kernel
``_warp_pallas_kernel``): a direct single-pass sample at exact projective
coordinates, at any image size (the TPU kernel's tile and its constraint on
H and W are gone). On a CPU tensor it runs the plain versions
``ops.warp.warp_image_multi`` / ``warp_image_batch``, which compute the same
function by explicit gather. The device of the images alone decides.
"""
import ctypes

import torch

from ..kernels import build, cost
from .warp import (MODES, PADDING_MODES, check_modes, inverse_homographies,
                   warp_image_batch, warp_image_multi)


def _check(images, homographies, n_axis_is_batch, mode, padding_mode):
    check_modes(mode, padding_mode)
    if images.dim() != 4:
        raise ValueError(f"images must be (B, H, W, C), got "
                         f"{tuple(images.shape)}")
    n = homographies.shape[0]
    if tuple(homographies.shape) != (n, 3, 3):
        raise ValueError(f"homographies must be (n, 3, 3), got "
                         f"{tuple(homographies.shape)}")
    if n_axis_is_batch and images.shape[0] != n:
        raise ValueError(f"{images.shape[0]} images for {n} homographies")
    if homographies.device != images.device:
        raise ValueError(f"homographies on {homographies.device}, images on "
                         f"{images.device}")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {images.device}")


def _record(images, homographies, multi):
    """The kernel's work, while a cost count runs (``kernels/cost.py``)."""
    if cost.counting():
        n = homographies.shape[0]
        _, H, W, C = images.shape
        n_out = n * (images.shape[0] if multi else 1) * H * W * C
        cost.record("warp_projective", cost.warp(images.numel(), n_out, n,
                                                 H, W))


def _warp_library():
    """The kernel's library with its entry point typed once."""
    lib = build.load("warp_projective")
    fn = lib.xp_warp_projective
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_void_p])
    return lib


def warp_projective(images, Hinv, mode, padding_mode, multi):
    """One launch of the kernel on CUDA tensors (counted in
    ``warp_projective.launches``): images (B, H, W, C) shared by all of Hinv
    (multi) or (n, H, W, C), one per inverse homography ->
    (n, B, H, W, C) / (n, H, W, C)."""
    if images.dtype != torch.float32:
        raise TypeError(f"warp_projective takes float32 images, got "
                        f"{images.dtype}")
    lib = _warp_library()
    images = images.contiguous()
    Hinv = Hinv.contiguous()
    n = Hinv.shape[0]
    _, H, W, C = images.shape
    B = images.shape[0] if multi else 1
    out = torch.empty((n, B, H, W, C) if multi else (n, H, W, C),
                      dtype=torch.float32, device=images.device)
    err = lib.xp_warp_projective(
        MODES.index(mode), PADDING_MODES.index(padding_mode),
        images.data_ptr(), Hinv.data_ptr(), out.data_ptr(), n, B, H, W, C,
        0 if multi else H * W * C,
        torch.cuda.current_stream(images.device).cuda_stream)
    build.check(lib, err, "warp_projective launch")
    warp_projective.launches += 1
    return out


warp_projective.launches = 0


def warp_multi(images, homographies, mode="bilinear", padding_mode="zeros"):
    """images (B, H, W, C) warped by each of homographies (n, 3, 3) ->
    (n, B, H, W, C). A CUDA tensor launches the kernel (counted in
    ``warp_projective.launches``); a CPU tensor runs the plain gather."""
    _check(images, homographies, False, mode, padding_mode)
    _record(images, homographies, multi=True)
    with cost.uncounted():
        if images.device.type == "cuda":
            return warp_projective(images,
                                   inverse_homographies(homographies), mode,
                                   padding_mode, multi=True)
        return warp_image_multi(images, homographies, mode, padding_mode)


def warp_batch(images, homographies, mode="bilinear", padding_mode="zeros"):
    """images (n, H, W, C), one homography each (n, 3, 3) -> (n, H, W, C).
    Same contract and dispatch as :func:`warp_multi`."""
    _check(images, homographies, True, mode, padding_mode)
    _record(images, homographies, multi=False)
    with cost.uncounted():
        if images.device.type == "cuda":
            return warp_projective(images,
                                   inverse_homographies(homographies), mode,
                                   padding_mode, multi=False)
        return warp_image_batch(images, homographies, mode, padding_mode)
