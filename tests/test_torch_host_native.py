"""The port's native host libraries (`csrc/host/imageproc.cc`, `rle.cc`,
built by `kernels/host_build.py`) against their numpy plain versions and
the JAX package, on the CPU.

* `resize_u8` (bilinear, bicubic, nearest; gray and RGB; up, down and
  identity) byte for byte against the port's numpy resizer, Pillow
  (the JAX package's `resize_image` fallback) and the JAX package's own
  `ops/native/imageproc.cc`, compiled here into a temporary directory
  (not through the JAX package's loader, whose unlocked build into its
  source tree other test workers may be running);
* `normalize_pad` within 3e-7 of numpy;
* the RLE codec byte for byte against the port's numpy codec, the JAX
  package's numpy path and its `ops/native/rle.cc` compiled here;
* the build: several processes loading one fresh build directory at once
  all load it, and a failing g++ raises with its output.
"""

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from visionllm_tpu.ops import rle as jrle
from visionllm_tpu_torch.data import mm_utils, native_image
from visionllm_tpu_torch.kernels import host_build
from visionllm_tpu_torch.ops import rle as trle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(ROOT, "visionllm_tpu", "ops", "native")
PIL_METHOD = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
              "nearest": Image.NEAREST}
I64, P = ctypes.c_int64, ctypes.c_void_p


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's imageproc.cc and rle.cc built with the port's
    flags into a temporary directory."""
    d = tmp_path_factory.mktemp("jax_native")
    libs = {}
    for name in ("imageproc", "rle"):
        out = str(d / f"lib{name}.so")
        subprocess.run(["g++", *host_build.GXX_FLAGS, "-o", out,
                        os.path.join(JAX_NATIVE, name + ".cc")], check=True)
        libs[name] = ctypes.CDLL(out)
    lib = libs["imageproc"]
    lib.resize_u8.argtypes = [P, I64, I64, I64, P, I64, I64, ctypes.c_int]
    lib = libs["rle"]
    lib.rle_decode.argtypes = [ctypes.c_char_p, I64, I64, P]
    lib.rle_encode.restype = I64
    lib.rle_encode.argtypes = [P, I64, I64, ctypes.c_char_p, I64]
    lib.rle_area.restype = I64
    lib.rle_area.argtypes = [ctypes.c_char_p]
    return libs


def _image(seed, hw, channels):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    smooth = (x * 7 + y * 3) % 256
    img = (smooth[..., None] + rng.integers(0, 60, (*hw, channels))) % 256
    img = img.astype(np.uint8)
    return img[:, :, 0] if channels == 1 else img


def _jax_resize(lib, img, size, method):
    x = np.ascontiguousarray(img[:, :, None] if img.ndim == 2 else img)
    h, w, c = x.shape
    out = np.empty((*size, c), np.uint8)
    assert lib.resize_u8(x.ctypes.data, h, w, c, out.ctypes.data, *size,
                         native_image.METHODS[method]) == 0
    return out[:, :, 0] if img.ndim == 2 else out


SIZES = {"down": ((97, 130), (41, 57)), "up": ((23, 31), (64, 75)),
         "identity": ((37, 45), (37, 45))}


@pytest.mark.parametrize("direction", sorted(SIZES))
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
def test_resize_byte_equal(jax_libs, method, channels, direction):
    src, dst = SIZES[direction]
    img = _image(len(method) * 10 + channels, src, channels)
    got = native_image.resize_u8(img, dst, method)
    assert got.shape == img.shape[:0] + dst + img.shape[2:]
    np.testing.assert_array_equal(got, mm_utils.resize_image_np(img, dst,
                                                                method))
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(img).resize(
        (dst[1], dst[0]), PIL_METHOD[method])))
    np.testing.assert_array_equal(
        got, _jax_resize(jax_libs["imageproc"], img, dst, method))
    np.testing.assert_array_equal(mm_utils.resize_image(img, dst, method),
                                  got)


@pytest.mark.parametrize("src,dst,method", [
    ((480, 640), (336, 336), "bicubic"),      # CLIP from a COCO image
    ((427, 640), (800, 1199), "bilinear"),    # det up-scale
    ((367, 481), (100, 120), "bilinear")])
def test_resize_at_data_sizes(src, dst, method):
    img = _image(7, src, 3)
    np.testing.assert_array_equal(native_image.resize_u8(img, dst, method),
                                  mm_utils.resize_image_np(img, dst, method))


def test_resize_from_threads_equals_sequential():
    imgs = [_image(s, (120 + s, 90), 3) for s in range(8)]
    want = [native_image.resize_u8(im, (64, 48), "bicubic") for im in imgs]
    got = [None] * len(imgs)

    def work(i):
        got[i] = native_image.resize_u8(imgs[i], (64, 48), "bicubic")

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pad", [False, True])
def test_normalize_pad_matches_numpy(pad):
    img = _image(3, (29, 41), 3)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    pad_val = np.asarray([0.5, -1.0, 2.0], np.float32) if pad else None
    got = native_image.normalize_pad(img, mean, std, (32, 48), pad_val)
    want = native_image.normalize_pad_np(img, mean, std, (32, 48), pad_val)
    assert got.dtype == np.float32 and got.shape == (32, 48, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    with pytest.raises(ValueError, match="does not fit"):
        native_image.normalize_pad(img, mean, std, (20, 48))


def _mask(seed, h=37, w=23):
    rng = np.random.default_rng(seed)
    m = (rng.random((h, w)) < 0.5).astype(np.uint8)
    m[:, : w // 3] = 0
    m[h // 2:, w // 2:] = 1
    return m


def _jax_rle_np(monkeypatch):
    """The JAX package's codec with its native library held off: its
    numpy path."""
    monkeypatch.setattr(jrle, "_load_native", lambda: None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_byte_equal(jax_libs, monkeypatch, seed):
    mask = _mask(seed)
    if seed == 2:
        mask[0, 0] = 1          # a mask starting with a 1-run
    got = trle.rle_encode(mask)
    assert got == trle.rle_encode_np(mask)
    lib = jax_libs["rle"]
    buf = ctypes.create_string_buffer(2 * mask.size + 16)
    n = lib.rle_encode(np.ascontiguousarray(mask).ctypes.data, *mask.shape,
                       buf, len(buf))
    assert got["counts"] == buf.raw[:n].decode()
    _jax_rle_np(monkeypatch)
    assert got == jrle.rle_encode(mask)
    counts = got["counts"]
    dec = trle.rle_decode(counts, *mask.shape)
    np.testing.assert_array_equal(dec, mask)
    np.testing.assert_array_equal(dec, trle.rle_decode_np(counts,
                                                          *mask.shape))
    np.testing.assert_array_equal(dec, jrle.rle_decode(counts, *mask.shape))
    jout = np.zeros(mask.shape, np.uint8)
    assert lib.rle_decode(counts.encode(), *mask.shape, jout.ctypes.data) == 0
    np.testing.assert_array_equal(dec, jout)
    area = trle.rle_area(got)
    assert area == trle.rle_area_np(got) == jrle.rle_area(got) == \
        lib.rle_area(counts.encode()) == int(mask.sum())


def test_rle_short_counts_take_the_numpy_path(monkeypatch):
    """Counts that do not fill the mask: the native decoder refuses them
    and the numpy path decodes what is there, as in the JAX package."""
    counts = trle._string_from_counts([3, 4, 2]).decode()
    got = trle.rle_decode(counts, 4, 5)
    _jax_rle_np(monkeypatch)
    np.testing.assert_array_equal(got, jrle.rle_decode(counts, 4, 5))
    assert int(got.sum()) == 4


def test_concurrent_first_use_in_processes(tmp_path):
    """Six processes build and load every host library from one empty
    build directory at the same moment: each loads every library, and
    the directory ends with one finished library per source."""
    code = (
        "import sys, time\n"
        "from visionllm_tpu_torch.kernels import host_build as hb\n"
        "hb.BUILD_DIR = sys.argv[1]\n"
        "t = float(sys.argv[2])\n"
        "while time.time() < t: time.sleep(0.005)\n"
        "hb.build_host_all()\n"
        "from visionllm_tpu_torch.data import jpeg, native_image\n"
        "import numpy as np\n"
        "native_image.resize_u8(np.zeros((4, 4, 3), np.uint8), (2, 2))\n"
        "print('ok')\n")
    import time
    start = str(time.time() + 3.0)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               start], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    libs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".so"))
    assert libs == sorted(os.path.basename(host_build.host_lib_path(n))
                          for n in host_build.HOST_LIBS)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_failed_build_raises_with_gxx_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "rle.cc").write_text("int broken( {\n")
    monkeypatch.setattr(host_build, "HOST_SRC_DIR", str(src))
    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(host_build, "_libs", {})
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for csrc/host/"
                                           r"rle\.cc(.|\n)*error"):
        host_build.host_library("rle")
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith((".so", ".tmp"))]
