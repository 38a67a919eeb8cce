"""ctypes wrappers of the native image functions (`csrc/host/imageproc.cc`,
a copy of the JAX package's `ops/native/imageproc.cc`): Pillow's
resampler on uint8 images and the fused normalize-and-pad. A ctypes call
releases the GIL, so the prefetch loader's worker threads run them at
once. The library builds with g++ at first use (`kernels/host_build.py`);
a failed build raises.

The plain versions are `mm_utils.resize_image_np` and `normalize_pad_np`:
the same arithmetic in numpy, which the tests hold these to byte for
byte (resize) and to 3e-7 (normalize).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from visionllm_tpu_torch.kernels.host_build import host_library

METHODS = {"bilinear": 0, "bicubic": 1, "nearest": 2}
_I64, _P = ctypes.c_int64, ctypes.c_void_p
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = host_library("imageproc")
        lib.resize_u8.restype = ctypes.c_int
        lib.resize_u8.argtypes = [_P, _I64, _I64, _I64, _P, _I64, _I64,
                                  ctypes.c_int]
        lib.normalize_pad_f32.restype = ctypes.c_int
        lib.normalize_pad_f32.argtypes = [_P, _I64, _I64, _I64, _P, _P, _P,
                                          _P, _I64, _I64]
        _LIB = lib
    return _LIB


def resize_u8(img: np.ndarray, size: Tuple[int, int],
              method: str = "bilinear") -> np.ndarray:
    """uint8 [h, w, c] or [h, w] resized to `size` (oh, ow) with Pillow's
    filters and rounding."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}")
    squeeze = img.ndim == 2
    x = np.ascontiguousarray(img[:, :, None] if squeeze else img, np.uint8)
    h, w, c = x.shape
    oh, ow = size
    out = np.empty((oh, ow, c), np.uint8)
    rc = _lib().resize_u8(x.ctypes.data, h, w, c, out.ctypes.data, oh, ow,
                          METHODS[method])
    if rc != 0:
        raise ValueError(f"resize_u8: bad sizes {x.shape} -> {size}")
    return out[:, :, 0] if squeeze else out


def normalize_pad(img: np.ndarray, mean: np.ndarray, std: np.ndarray,
                  out_hw: Tuple[int, int],
                  pad_val: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 [h, w, c] -> float32 [oh, ow, c]: (x / 255 - mean) / std in
    the image, `pad_val` (default 0) around it."""
    x = np.ascontiguousarray(img, np.uint8)
    h, w, c = x.shape
    oh, ow = out_hw
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    pad = (np.zeros(c, np.float32) if pad_val is None
           else np.ascontiguousarray(pad_val, np.float32))
    out = np.empty((oh, ow, c), np.float32)
    rc = _lib().normalize_pad_f32(x.ctypes.data, h, w, c, mean.ctypes.data,
                                  std.ctypes.data, pad.ctypes.data,
                                  out.ctypes.data, oh, ow)
    if rc != 0:
        raise ValueError(f"normalize_pad: image {x.shape} does not fit "
                         f"{out_hw}")
    return out


def normalize_pad_np(img: np.ndarray, mean: np.ndarray, std: np.ndarray,
                     out_hw: Tuple[int, int],
                     pad_val: Optional[np.ndarray] = None) -> np.ndarray:
    """The plain version of `normalize_pad`, in numpy."""
    h, w, c = img.shape
    out = np.empty((*out_hw, c), np.float32)
    out[...] = (np.zeros(c, np.float32) if pad_val is None
                else np.asarray(pad_val, np.float32))
    out[:h, :w] = ((img.astype(np.float32) / np.float32(255.0)
                    - np.asarray(mean, np.float32))
                   / np.asarray(std, np.float32))
    return out
