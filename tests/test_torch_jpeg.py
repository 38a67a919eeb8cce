"""The port's JPEG decoder (`csrc/host/jpeg_decode.cc` through
`data/jpeg.py` and `data/image_io.py`) against Pillow's
`np.asarray(Image.open(p).convert("RGB"))` (Pillow 12.1.0 on
libjpeg-turbo 3.1.3 here), byte for byte.

Pillow encodes each case in the test from a numpy seed: qualities 50, 75
and 95 at 4:4:4, 4:2:2 and 4:2:0, progressive with and without
`optimize`, restart markers in baseline and progressive scans, gray, and
sizes 1x1, 8x8, 17x9 and 481x367. The committed fixtures
(`tests/data/jpeg/`) match their manifest's hashes. Adobe APP14 RGB
files and files without JFIF are built from Pillow's by swapping the
APP0 segment. Each kind the decoder does not read raises
`NotImplementedError` naming the file (the headers of arithmetic-coded,
12-bit, lossless, hierarchical and 4:4:0 / 4:1:1 files are patched into
a Pillow file; CMYK comes from Pillow's CMYK mode). The COCO det dataset
and MMBench's base64 rows read from JPEGs give the JAX package's pixels.
"""

import base64
import hashlib
import io
import json
import os
import threading

import numpy as np
import pytest
from PIL import Image

from tests.mock_tokenizer import MockTokenizer
from visionllm_tpu.data.det_dataset import CocoDetDataset as JaxDetDataset
from visionllm_tpu.eval import runners as jR
from visionllm_tpu_torch.data import image_io
from visionllm_tpu_torch.data.det_dataset import CocoDetDataset
from visionllm_tpu_torch.eval import runners as tR

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")


def _image(seed, hw, gray=False):
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([x * 255 / max(w, 1), y * 255 / max(h, 1),
                  (x + y) * 128 / max(h + w, 1)], -1)
    a = a + rng.normal(0, 20, a.shape)
    a[h // 4:h // 2, w // 4:w // 2] = [200, 30, 90]
    img = Image.fromarray(np.clip(a, 0, 255).astype(np.uint8))
    return img.convert("L") if gray else img


def _encode(img, **opts):
    bio = io.BytesIO()
    img.save(bio, "JPEG", **opts)
    return bio.getvalue()


def _pillow(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _check(data, name="case.jpg"):
    got = image_io.decode_image_bytes(data, name)
    want = _pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_baseline_quality_and_subsampling(quality, subsampling):
    img = _image(quality + subsampling, (83, 117))
    _check(_encode(img, quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("optimize", [False, True])
def test_progressive(optimize, subsampling):
    img = _image(10 + subsampling, (71, 103))
    _check(_encode(img, quality=80, progressive=True, optimize=optimize,
                   subsampling=subsampling))


@pytest.mark.parametrize("opts", [
    {"restart_marker_blocks": 3},
    {"restart_marker_rows": 1, "subsampling": 1},
    {"restart_marker_rows": 2, "progressive": True},
    {"restart_marker_blocks": 7, "progressive": True, "optimize": True,
     "subsampling": 0}], ids=["blocks3", "rows1_422", "prog_rows2",
                              "prog_blocks7_444"])
def test_restart_markers(opts):
    data = _encode(_image(20, (67, 95)), quality=75, **opts)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _check(data)


@pytest.mark.parametrize("progressive", [False, True])
def test_gray(progressive):
    _check(_encode(_image(30, (45, 61), gray=True), quality=85,
                   progressive=progressive))


@pytest.mark.parametrize("hw", [(1, 1), (8, 8), (9, 17), (367, 481)],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("layout", ["420", "422_prog", "gray"])
def test_sizes(hw, layout):
    img = _image(hw[0] * 1000 + hw[1], hw, gray=layout == "gray")
    opts = {"420": {"subsampling": 2},
            "422_prog": {"subsampling": 1, "progressive": True},
            "gray": {}}[layout]
    _check(_encode(img, quality=75, **opts))


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()["files"]))
def test_fixture_matches_manifest(name):
    entry = _manifest()["files"][name]
    path = os.path.join(FIXTURES, name)
    got = image_io.load_image(path)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(got, np.asarray(
        Image.open(path).convert("RGB")))


def test_fixtures_stay_small():
    files = [f for f in os.listdir(FIXTURES) if f.endswith(".jpg")]
    assert sorted(files) == sorted(_manifest()["files"])
    assert len(files) <= 12
    assert sum(os.path.getsize(os.path.join(FIXTURES, f))
               for f in files) <= 1 << 20


def _without_app0(data):
    assert data[2:4] == b"\xff\xe0"
    return data[:2] + data[4 + int.from_bytes(data[4:6], "big"):]


@pytest.mark.parametrize("transform", [0, 1, None])
def test_adobe_and_unmarked_colour_spaces(transform):
    """APP14 transform 0 is RGB (no conversion), 1 YCbCr; with neither
    JFIF nor Adobe the component ids 1, 2, 3 say YCbCr."""
    data = _without_app0(_encode(_image(40, (33, 47)), quality=90,
                                 subsampling=0))
    if transform is not None:
        app14 = (b"\xff\xee\x00\x0eAdobe" + bytes([0, 100, 0, 0, 0, 0])
                 + bytes([transform]))
        data = data[:2] + app14 + data[2:]
    _check(data)


def _sof(data):
    return data.index(b"\xff\xc0")


def _patched(offset, value, marker=None):
    data = bytearray(_encode(_image(50, (24, 32)), quality=75,
                             subsampling=0))
    i = _sof(data)
    if marker is not None:
        data[i + 1] = marker
    if offset is not None:
        data[i + offset] = value
    return bytes(data)


NOT_READ = {
    "arithmetic": (lambda: _patched(None, 0, marker=0xC9),
                   "arithmetic coding"),
    "12bit": (lambda: _patched(4, 12), "12-bit"),
    "lossless": (lambda: _patched(None, 0, marker=0xC3), "lossless"),
    "hierarchical": (lambda: _patched(None, 0, marker=0xC5),
                     "hierarchical"),
    "cmyk": (lambda: _encode(_image(51, (24, 32)).convert("CMYK")),
             r"4 components \(CMYK/YCCK\)"),
    "440": (lambda: _patched(11, 0x12), r"sampling factors 1x2,1x1,1x1"),
    "411": (lambda: _patched(11, 0x41), r"sampling factors 4x1,1x1,1x1"),
}


@pytest.mark.parametrize("kind", sorted(NOT_READ))
def test_kinds_not_read_raise_naming_the_file(tmp_path, kind):
    make, what = NOT_READ[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(make())
    with pytest.raises(NotImplementedError,
                       match=rf"{kind}\.jpg: JPEG with {what}"):
        image_io.load_image(str(path))


def test_truncated_file_raises_value_error(tmp_path):
    data = _encode(_image(52, (40, 40)), quality=75)
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match=r"cut\.jpg: broken JPEG"):
        image_io.load_image(str(path))


def _with_dht(data, body):
    """`data` with a DHT segment of `body` put just before its first SOS,
    so the scan uses that table."""
    sos = data.index(b"\xff\xda")
    seg = b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body
    return data[:sos] + seg + data[sos:]


BAD_DHT = {
    # (table class and id, counts of codes of lengths 1..16, symbols)
    "three_of_length_1": (0x00, [3] + [0] * 15, bytes(3)),
    "all_255_of_length_1": (0x10, [255] + [0] * 15, bytes(range(255))),
    "all_ones_code": (0x00, [1, 2] + [0] * 14, bytes(3)),
    "dc_symbol_16": (0x00, [0, 1] + [0] * 14, bytes([16])),
}


@pytest.mark.parametrize("case", sorted(BAD_DHT))
def test_bad_huffman_table_raises_value_error(tmp_path, case):
    tc_th, counts, symbols = BAD_DHT[case]
    data = _with_dht(_encode(_image(53, (24, 24)), quality=75),
                     bytes([tc_th] + counts) + symbols)
    with pytest.raises(OSError):  # libjpeg refuses the table too
        _pillow(data)
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError,
                       match=rf"{case}\.jpg: broken JPEG \(bad Huffman table\)"):
        image_io.load_image(str(path))


def test_threads_decode_at_once():
    datas = [_encode(_image(60 + i, (90, 120)), quality=70 + i,
                     progressive=bool(i % 2)) for i in range(8)]
    want = [_pillow(d) for d in datas]
    got = [None] * len(datas)

    def work(i):
        got[i] = image_io.decode_image_bytes(datas[i])

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(datas))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def coco_jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_jpeg")
    imgs, anns = [], []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (45, 70)]):
        _image(70 + i, (h, w)).save(d / f"img{i}.jpg", quality=80,
                                    subsampling=2 - i)
        imgs.append({"id": i, "file_name": f"img{i}.jpg", "width": w,
                     "height": h})
        anns.append({"id": i, "image_id": i, "category_id": 1 + i % 2,
                     "bbox": [5, 5, 20, 15], "area": 300, "iscrowd": 0,
                     "segmentation": [[5, 5, 25, 5, 25, 20, 5, 20]]})
    with open(d / "ann.json", "w") as f:
        json.dump({"images": imgs, "annotations": anns,
                   "categories": [{"id": 1, "name": "cat"},
                                  {"id": 2, "name": "dog"}]}, f)
    return d


@pytest.mark.parametrize("test_mode", [True, False])
def test_coco_det_samples_from_jpegs_match_jax(coco_jpegs, test_mode):
    tok = MockTokenizer()
    kw = dict(ann_file=str(coco_jpegs / "ann.json"),
              img_prefix=str(coco_jpegs), tokenizer=tok, test_mode=test_mode,
              with_mask=True, max_gt_per_img=4, image_size=56, seed=3,
              test_scale=(48, 64), train_scales=[(40, 64), (48, 64)],
              buckets=((64, 64), (64, 96), (96, 64), (96, 96)))
    jds = JaxDetDataset(**kw)
    tds = CocoDetDataset(image_token_len=16, **kw)
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        for key in ("input_ids", "labels", "image", "image_aug",
                    "pixel_mask"):
            np.testing.assert_array_equal(got[key], want[key])
        for key in want.get("targets", {}):
            np.testing.assert_array_equal(got["targets"][key],
                                          want["targets"][key])


def test_mmbench_rows_with_base64_jpegs_match_jax_pixels(tmp_path):
    rows = ["index\tquestion\thint\tA\tB\tC\tD\tanswer\timage"]
    for i, opts in enumerate(({"subsampling": 2}, {"progressive": True},
                              {"subsampling": 0, "quality": 95})):
        b64 = base64.b64encode(_encode(_image(80 + i, (40 + i, 52)),
                                       **opts)).decode()
        rows.append(f"{i}\tWhat color?\t\tred\tgreen\tblue\tpink\tA\t{b64}")
    path = tmp_path / "mmbench.tsv"
    path.write_text("\n".join(rows) + "\n")
    want = jR._materialize_images(jR.load_mmbench(str(path)))
    got = tR._materialize_images(tR.load_mmbench(str(path)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pop("image"), w.pop("image"))
        assert g == w
