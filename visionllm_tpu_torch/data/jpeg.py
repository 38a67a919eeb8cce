"""ctypes wrapper of the port's JPEG decoder (`csrc/host/jpeg_decode.cc`):
baseline and progressive Huffman JPEG, 8-bit, gray or YCbCr/RGB at 4:4:4,
4:2:2 or 4:2:0, with restart intervals, decoded with libjpeg's
arithmetic (ISLOW IDCT, fancy upsampling, fixed-point YCbCr -> RGB), so
the pixels equal Pillow's `Image.open(path).convert("RGB")` (Pillow
12.1.0 on libjpeg-turbo 3.1.3) byte for byte. The call releases the GIL.

What it does not read raises `NotImplementedError` naming the file and
the feature: arithmetic coding, 12-bit samples, lossless and
hierarchical processes, 2 or 4 components (CMYK/YCCK), other sampling
factors (4:4:0, 4:1:1, ...), and progressive files whose scans leave low
AC coefficients unrefined (libjpeg block-smooths those). A corrupt or
truncated file raises `ValueError`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from visionllm_tpu_torch.kernels.host_build import host_library

JPEG_MAGIC = b"\xff\xd8\xff"
READS = ("JPEG (baseline or progressive Huffman, 8-bit; gray, YCbCr or "
         "Adobe RGB; 4:4:4, 4:2:2 or 4:2:0; restart intervals)")
_ERR_CAP = 512
_I64 = ctypes.c_int64
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = host_library("jpeg_decode")
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_info.argtypes = [ctypes.c_char_p, _I64,
                                  ctypes.POINTER(_I64), ctypes.POINTER(_I64),
                                  ctypes.c_char_p, _I64]
        lib.jpeg_decode_rgb.restype = ctypes.c_int
        lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, _I64,
                                        ctypes.c_void_p, _I64, _I64,
                                        ctypes.c_char_p, _I64]
        _LIB = lib
    return _LIB


def _raise(rc: int, err, name: str, reads: str):
    what = err.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(f"{name}: JPEG with {what} is not read by "
                                  f"the port; it reads {reads}")
    raise ValueError(f"{name}: broken JPEG ({what})")


def decode_jpeg(data: bytes, name: str = "<bytes>",
                reads: str = READS) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3]; an error names `name` (and, for a
    kind not read, `reads`)."""
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_CAP)
    h, w = _I64(), _I64()
    rc = lib.jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                       err, _ERR_CAP)
    if rc:
        _raise(rc, err, name, reads)
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode_rgb(data, len(data), out.ctypes.data, h.value,
                             w.value, err, _ERR_CAP)
    if rc:
        _raise(rc, err, name, reads)
    return out
