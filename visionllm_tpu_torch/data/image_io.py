"""Image files to uint8 [H, W, 3] arrays without Pillow (the JAX package
opens them with `Image.open(path).convert("RGB")`).

The port reads three formats, told apart by their magic bytes:

- JPEG (`FF D8 FF`): the port's native decoder (`data/jpeg.py`,
  `csrc/host/jpeg_decode.cc`), equal to Pillow's pixels byte for byte
  on what it reads (baseline and progressive Huffman, 8-bit, gray or
  YCbCr at 4:4:4, 4:2:2, 4:2:0, restart intervals);

- PNG of bit depth 8, not interlaced, in colour types gray, gray+alpha,
  RGB, RGBA and palette (with `PLTE`): the `IDAT` chunks concatenated,
  inflated with `zlib`, and each row un-filtered (None, Sub, Up,
  Average, Paeth). The pixels equal Pillow's `convert("RGB")` byte for
  byte: gray is repeated into three channels, alpha is dropped (not
  composited), palette indices look up `PLTE`.
- `.npy` holding uint8 [H, W, 3] or [H, W] (gray, repeated).

`load_label` reads a label map as `np.asarray(Image.open(path))` gives
it: a PNG's samples as stored, without the conversion to RGB (gray and
palette PNGs give [H, W]: the gray value or the palette index; gray+alpha,
RGB and RGBA give [H, W, 2 / 3 / 4]), or a uint8 `.npy` as it is.

Anything else (arithmetic-coded, 12-bit, lossless, hierarchical or CMYK
JPEG, other JPEG subsamplings, interlaced or 16-bit PNG, other bit
depths, other formats) raises `NotImplementedError` naming the file and
what is read.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from visionllm_tpu_torch.data.jpeg import JPEG_MAGIC, decode_jpeg
from visionllm_tpu_torch.data.jpeg import READS as JPEG_READS

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
NPY_MAGIC = b"\x93NUMPY"
READS = (f"{JPEG_READS}, PNG (bit depth 8, not interlaced; gray, "
         "gray+alpha, RGB, RGBA, palette) and .npy (uint8 [H, W, 3] or "
         "[H, W])")

# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def load_image(path: str) -> np.ndarray:
    """The image file at `path` as uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image_bytes(data, name=path)


def decode_image_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Encoded image bytes (a file's contents, or MMBench's base64 field
    decoded) as uint8 [H, W, 3]."""
    if data.startswith(JPEG_MAGIC):
        return decode_jpeg(data, name, READS)
    if data.startswith(PNG_MAGIC):
        return _decode_png(data, name)
    if data.startswith(NPY_MAGIC):
        return _from_npy(np.load(io.BytesIO(data), allow_pickle=False), name)
    raise NotImplementedError(f"{name}: this format is not read by the "
                              f"port; it reads {READS}")


def load_label(path: str) -> np.ndarray:
    """The label map at `path` as stored (see the module docstring): a
    PNG's samples or a uint8 `.npy`. A 16-bit PNG raises
    `NotImplementedError`, as `load_image` does."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_MAGIC):
        ctype, px, _ = _png_samples(data, path)
        return np.ascontiguousarray(px[:, :, 0] if ctype in (0, 3) else px)
    if data.startswith(NPY_MAGIC):
        arr = np.load(io.BytesIO(data), allow_pickle=False)
        if arr.dtype != np.uint8:
            raise ValueError(f"{path}: .npy labels are uint8, got "
                             f"{arr.dtype}")
        return arr
    raise NotImplementedError(f"{path}: labels are read from PNG (bit "
                              "depth 8, not interlaced) and .npy files")


def _from_npy(arr: np.ndarray, name: str) -> np.ndarray:
    if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"{name}: .npy images are uint8 [H, W, 3] or "
                         f"[H, W], got {arr.dtype} {arr.shape}")
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    return np.ascontiguousarray(arr)


def _chunks(data: bytes, name: str):
    pos = len(PNG_MAGIC)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: broken PNG chunk {kind!r} (CRC)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG without IEND")


def _decode_png(data: bytes, name: str) -> np.ndarray:
    ctype, px, palette = _png_samples(data, name)
    if ctype == 3:
        # Pillow's palette starts as a gray ramp; PLTE overwrites its head
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        lut[:len(palette)] = palette[:256]
        return lut[px[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def _png_samples(data: bytes, name: str):
    """(colour type, the unfiltered samples [H, W, samples a pixel], the
    PLTE entries or None) of an 8-bit PNG."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"{name}: PNG of bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} is not read by the port; it reads "
            f"{READS}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * bpp + 1
    if raw.size < h * stride:
        raise ValueError(f"{name}: PNG data ends early")
    rows = raw[:h * stride].reshape(h, stride)
    px = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp), name)
    return ctype, px, palette


def _unfilter(ftype: np.ndarray, filt: np.ndarray, name: str) -> np.ndarray:
    """Undo PNG's per-row filters on [H, W, bpp] bytes. Average and Paeth
    read the pixel to the left, the one above and the one above-left, all
    reconstructed; pixels of one anti-diagonal (r + x constant) depend
    only on earlier anti-diagonals, so those are reconstructed together,
    H + W - 1 steps in all. Row r is stored shifted right by r, so that an
    anti-diagonal is a column slice."""
    if ftype.size and ftype.max() > 4:
        raise ValueError(f"{name}: unknown PNG filter {int(ftype.max())}")
    h, w, bpp = filt.shape
    if not (ftype >= 3).any():
        # None, Sub and Up only: one vector step a row
        out = filt.copy()
        for r in np.nonzero(ftype)[0]:
            if ftype[r] == 1:
                np.cumsum(out[r], axis=0, dtype=np.uint8, out=out[r])
            elif r:
                out[r] += out[r - 1]
        return out
    rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
    raw = np.zeros((h, h + w, bpp), np.int16)
    raw[rows, rows + cols] = filt
    # rec[r + 1, d + 1] holds pixel (r, d - r); row 0 and the slots left
    # of each row's first pixel stay 0
    rec = np.zeros((h + 1, h + w + 1, bpp), np.int16)
    kind = ftype.astype(np.int16)[:, None]
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = rec[r0 + 1:r1 + 1, d]          # left
        b = rec[r0:r1, d]                  # above
        c = rec[r0:r1, d - 1] if d else 0  # above-left
        k = kind[r0:r1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, paeth, 0))))
        rec[r0 + 1:r1 + 1, d + 1] = (raw[r0:r1, d] + pred) & 0xFF
    return rec[rows + 1, rows + cols + 1].astype(np.uint8)
