"""The port's Pillow-free image reader (`data/image_io.py`) against Pillow's
`Image.open(p).convert("RGB")`, which the JAX package reads images with.

Byte-identical on PNGs Pillow writes from seeded noise and from smooth
seeded images (its encoder picks a filter per row, so these carry all
five) in every colour type the port reads, on hand-built PNGs that force
one filter on every row and split `IDAT` across chunks, and on `.npy`
arrays. JPEG, interlaced and 16-bit PNGs, and a broken CRC raise.
"""

import base64
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from visionllm_tpu_torch.data import image_io


def _pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _save(img: Image.Image, fmt: str = "PNG", **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _seeded(seed, shape, smooth):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    if smooth:      # gradients: Sub / Up / Average / Paeth rows
        x = (np.cumsum(x.astype(np.int64), axis=1) // 37 % 256).astype(
            np.uint8)
    return x


MODES = [("L", ()), ("LA", (2,)), ("RGB", (3,)), ("RGBA", (4,))]
SHAPES = [(37, 53), (1, 1), (1, 9), (9, 1), (64, 48)]


@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
@pytest.mark.parametrize("mode,chan", MODES, ids=[m for m, _ in MODES])
def test_png_matches_pillow(mode, chan, smooth):
    for i, shape in enumerate(SHAPES):
        arr = _seeded(i, shape + chan, smooth)
        data = _save(Image.fromarray(arr, mode))
        got = image_io.decode_image_bytes(data)
        assert got.dtype == np.uint8 and got.shape == shape + (3,)
        np.testing.assert_array_equal(got, _pillow_rgb(data))


@pytest.mark.parametrize("colours", [2, 16, 200, 256])
def test_palette_png_matches_pillow(colours):
    """8-bit palette PNGs, the PLTE as long as the colours used."""
    rng = np.random.default_rng(colours)
    for shape in ((20, 30), (7, 13), (1, 1)):
        im = Image.fromarray(rng.integers(0, colours, shape, dtype=np.uint8),
                             "P")
        im.putpalette(rng.integers(0, 256, 3 * colours).tolist())
        data = _save(im, bits=8)
        np.testing.assert_array_equal(image_io.decode_image_bytes(data),
                                      _pillow_rgb(data))


def test_palette_indices_past_plte_match_pillow():
    """8-bit indices past a 10-entry PLTE read Pillow's gray ramp."""
    rng = np.random.default_rng(3)
    im = Image.fromarray(rng.integers(0, 256, (20, 30), dtype=np.uint8), "P")
    im.putpalette(rng.integers(0, 256, 30).tolist())
    data = _save(im, bits=8)
    np.testing.assert_array_equal(image_io.decode_image_bytes(data),
                                  _pillow_rgb(data))


@pytest.mark.parametrize("kind", ["palette_4bit", "gray_1bit"])
def test_sub_byte_pngs_raise(kind):
    """Pillow writes a palette of up to 16 colours at 4 bits and mode "1"
    at 1 bit; the port reads bit depth 8 only."""
    if kind == "palette_4bit":
        im = Image.fromarray(_seeded(4, (9, 21), False) % 16, "P")
        im.putpalette(list(range(48)))
    else:
        im = Image.fromarray(_seeded(4, (9, 21), False)).convert("1")
    data = _save(im)
    with pytest.raises(NotImplementedError, match="bit depth [14]"):
        image_io.decode_image_bytes(data, name="sub.png")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filtered_rows(img: np.ndarray, filters) -> bytes:
    """PNG scanlines of img [H, W, C] uint8, row r filtered with
    filters[r] (the encoder's arithmetic, written out per byte)."""
    h, w, c = img.shape
    px = img.astype(np.int64)
    out = bytearray()
    for r in range(h):
        f = filters[r]
        out.append(f)
        for x in range(w):
            for k in range(c):
                a = px[r, x - 1, k] if x else 0
                b = px[r - 1, x, k] if r else 0
                cc = px[r - 1, x - 1, k] if r and x else 0
                pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[f]
                out.append(int(px[r, x, k] - pred) & 0xFF)
    return bytes(out)


def _png(img: np.ndarray, filters, ctype=2, depth=8, interlace=0,
         split=1) -> bytes:
    h, w = img.shape[:2]
    z = zlib.compress(_filtered_rows(img, filters))
    parts = [z[i * len(z) // split:(i + 1) * len(z) // split]
             for i in range(split)]
    return (image_io.PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace))
            + b"".join(_chunk(b"IDAT", p) for p in parts)
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", range(5),
                         ids=["none", "sub", "up", "average", "paeth"])
def test_each_filter_on_every_row_and_split_idat(filt):
    img = _seeded(10 + filt, (11, 13, 3), smooth=filt % 2 == 0)
    for split in (1, 3):
        data = _png(img, [filt] * 11, split=split)
        got = image_io.decode_image_bytes(data)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, _pillow_rgb(data))


def test_mixed_filters_rgba_split_idat():
    img = _seeded(20, (17, 9, 4), smooth=True)
    data = _png(img, [r % 5 for r in range(17)], ctype=6, split=4)
    got = image_io.decode_image_bytes(data)
    np.testing.assert_array_equal(got, img[:, :, :3])
    np.testing.assert_array_equal(got, _pillow_rgb(data))


def test_load_image_reads_png_and_npy_files(tmp_path):
    arr = _seeded(30, (12, 10, 3), smooth=True)
    Image.fromarray(arr).save(tmp_path / "a.png")
    np.testing.assert_array_equal(
        image_io.load_image(str(tmp_path / "a.png")), arr)
    # the format is sniffed from the bytes, not the name
    (tmp_path / "b.jpg").write_bytes((tmp_path / "a.png").read_bytes())
    np.testing.assert_array_equal(
        image_io.load_image(str(tmp_path / "b.jpg")), arr)
    np.save(tmp_path / "c.npy", arr)
    np.testing.assert_array_equal(
        image_io.load_image(str(tmp_path / "c.npy")), arr)
    np.save(tmp_path / "d.npy", arr[:, :, 0])
    np.testing.assert_array_equal(
        image_io.load_image(str(tmp_path / "d.npy")),
        np.repeat(arr[:, :, :1], 3, axis=2))
    np.save(tmp_path / "e.npy", arr.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        image_io.load_image(str(tmp_path / "e.npy"))


def test_base64_png_decodes_as_mmbench_rows_carry_it():
    arr = _seeded(31, (8, 6, 3), smooth=False)
    b64 = base64.b64encode(_save(Image.fromarray(arr))).decode()
    np.testing.assert_array_equal(
        image_io.decode_image_bytes(base64.b64decode(b64)), arr)


def test_formats_not_read_raise_naming_the_file(tmp_path):
    arr = _seeded(32, (16, 16, 3), smooth=True)
    Image.fromarray(arr).save(tmp_path / "x.jpg", format="JPEG")
    with pytest.raises(NotImplementedError, match=r"x\.jpg.*JPEG.*PNG"):
        image_io.load_image(str(tmp_path / "x.jpg"))
    Image.fromarray(arr.astype(np.uint16)[:, :, 0] * 200).save(
        tmp_path / "d16.png")
    with pytest.raises(NotImplementedError, match=r"d16\.png.*bit depth 16"):
        image_io.load_image(str(tmp_path / "d16.png"))
    (tmp_path / "il.png").write_bytes(_png(arr, [0] * 16, interlace=1))
    with pytest.raises(NotImplementedError, match=r"il\.png.*interlace 1"):
        image_io.load_image(str(tmp_path / "il.png"))
    Image.fromarray(arr).save(tmp_path / "x.bmp", format="BMP")
    with pytest.raises(NotImplementedError, match=r"x\.bmp"):
        image_io.load_image(str(tmp_path / "x.bmp"))


def test_broken_crc_raises():
    data = bytearray(_save(Image.fromarray(_seeded(33, (5, 5, 3), False))))
    data[-20] ^= 0xFF           # inside the last IDAT's body
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_image_bytes(bytes(data))
