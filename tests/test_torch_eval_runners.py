"""The port's VQA-style benchmark layer against the JAX package on the
CPU: the metrics (`benchmarks.py`, `caption.py`) on the cases of
`tests/test_benchmarks.py` and `tests/test_benchmark_runners.py`, every
loader and `score_rows` on fixture files in each benchmark's format (PNG
images, base64 PNGs in the MMBench tsv; JAX reads them through Pillow),
`run_vqa` token for token at B1 and B2 and `run_benchmark` end to end on
the tiny core in fp32 with one param tree in both, `measure_latency` on
the CPU, and the image-token count of `run_vqa`'s prompts under pixel
shuffle (`ROADMAP.md` §C.2).
"""

import base64
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_internvl import _tiny as tiny_26b
from tests.test_torch_unipose import o0_jit
from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.eval import benchmarks as jB
from visionllm_tpu.eval import caption as jcap
from visionllm_tpu.eval import runners as jR
from visionllm_tpu.eval import vqa as jvqa
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.eval import benchmarks as tB
from visionllm_tpu_torch.eval import caption as tcap
from visionllm_tpu_torch.eval import runners as tR
from visionllm_tpu_torch.eval import vqa as tvqa
from visionllm_tpu_torch.eval.latency import measure_latency
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.models.composite import build_core
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

IMAGE_SIZE, IMAGE_TOKENS = 56, 16      # tiny_test_config's CLIP
MAX_NEW, MAX_LEN = 6, 160


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

OPTS = ["a red ball", "a blue cube", "a green cone"]
CAPTION_CANDS = ["a cat sits on the mat", "a dog runs in the park",
                 "completely unrelated words here"]
CAPTION_REFS = [["a cat sits on the mat", "the cat is on a mat"],
                ["a dog runs in the park", "a dog running through a park"],
                ["nothing matches at all", "a bird"]]
METRIC_CASES = [
    ("normalize_answer", ("The cat!",)), ("normalize_answer", ("A  dog.",)),
    ("vqa_accuracy", ([{"prediction": "blue",
                        "answers": ["blue"] * 4 + ["red"] * 6},
                       {"prediction": "red", "answer": "red"},
                       {"prediction": "green", "answer": "red"}],)),
    ("parse_yes_no", ("Yes, it is.",)), ("parse_yes_no", ("no",)),
    ("parse_yes_no", ("I think yes",)), ("parse_yes_no", ("maybe",)),
    ("mme_scores", ([{"image_id": 1, "answer": "yes", "prediction": "Yes"},
                     {"image_id": 1, "answer": "no", "prediction": "No"},
                     {"image_id": 2, "answer": "yes", "prediction": "No"},
                     {"image_id": 2, "answer": "no", "prediction": "No"}],)),
    ("pope_scores", ([{"answer": "yes", "prediction": "yes"},
                      {"answer": "no", "prediction": "yes"},
                      {"answer": "no", "prediction": "no"}],)),
    ("extract_choice", ("B", OPTS)), ("extract_choice", ("(C) a green cone",
                                                         OPTS)),
    ("extract_choice", ("The answer is B.", OPTS)),
    ("extract_choice", ("It's a blue cube", OPTS)),
    ("choice_accuracy", ([{"prediction": "A", "options": OPTS,
                           "answer": "a"},
                          {"prediction": "a green cone", "options": OPTS,
                           "answer": "C"}],)),
    ("mmvet_keyword_score", ([{"prediction": "a brown wall",
                               "answer": "wall"},
                              {"prediction": "x", "keywords": ["a", "b"]}],)),
    ("relaxed_accuracy", ([{"prediction": "21%", "answer": "20%"},
                           {"prediction": "25%", "answer": "20%"},
                           {"prediction": "Ab", "answer": "ab"}],)),
    ("anls", ([{"prediction": "hello", "answer": "hello"},
               {"prediction": "help", "answer": "hello"},
               {"prediction": "xyz", "answers": ["hello", "xy"]}],)),
]


@pytest.mark.parametrize("name,args", METRIC_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(METRIC_CASES)])
def test_benchmark_metrics_match_jax(name, args):
    assert getattr(tB, name)(*args) == getattr(jB, name)(*args)
    assert set(tB.BENCHMARK_METRICS) == set(jB.BENCHMARK_METRICS)


@pytest.mark.parametrize("cands", [CAPTION_CANDS, CAPTION_CANDS[::-1]])
def test_caption_metrics_match_jax(cands):
    assert tcap.CiderD().compute(cands, CAPTION_REFS) == \
        jcap.CiderD().compute(cands, CAPTION_REFS)
    assert tcap.bleu4(cands, CAPTION_REFS) == jcap.bleu4(cands, CAPTION_REFS)


# ---------------------------------------------------------------------------
# loaders and scoring, on fixture files
# ---------------------------------------------------------------------------

def _png_bytes(seed, shape=(32, 48, 3)):
    arr = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_bench(d):
    """Fixture files of each benchmark's format under `d` (PNG images)."""
    for i in range(3):
        (d / f"img{i}.png").write_bytes(_png_bytes(i))
    mme = d / "mme"
    (mme / "images" / "color").mkdir(parents=True)
    (mme / "images" / "color" / "img0.png").write_bytes(_png_bytes(0))
    (mme / "color.txt").write_text(
        "img0.png\tIs the car red in the image? Please answer yes or no."
        "\tYes\nimg0.png\tIs the car blue in the image? Please answer yes "
        "or no.\tNo\nbroken line\n")
    (d / "pope.jsonl").write_text("\n".join(
        json.dumps({"image": f"img{i % 3}.png",
                    "text": f"Is there a {o} in the image?", "label": lab})
        for i, (o, lab) in enumerate((("dog", "yes"), ("surfboard", "no"),
                                      ("cat", "yes"), ("car", "no"),
                                      ("tree", "yes")))))
    rows = ["index\tquestion\thint\tA\tB\tC\tD\tanswer\timage"]
    for i, (hint, d_opt) in enumerate((("", "yellow"), ("Look.", "nan"),
                                       ("nan", "pink"))):
        b64 = base64.b64encode(_png_bytes(10 + i)).decode()
        rows.append(f"{i}\tWhat color?\t{hint}\tred\tgreen\tblue\t{d_opt}"
                    f"\t{'ABC'[i]}\t{b64}")
    (d / "mmbench.tsv").write_text("\n".join(rows) + "\n")
    (d / "seed.jsonl").write_text(json.dumps({
        "image": "img0.png",
        "text": "What is shown?\nA. cat\nB. dog\nC. wall\nD. sky",
        "answer": "C"}) + "\n")
    (d / "sqa.jsonl").write_text(json.dumps({
        "image": "img1.png", "hint": "Look closely.",
        "question": "Which is a color?", "choices": ["rock", "brown"],
        "answer": 1}) + "\n")
    (d / "mmvet.json").write_text(json.dumps({
        "v1_0": {"imagename": "img2.png", "question": "What is here?",
                 "answer": "a wall"}}))
    (d / "vqa.jsonl").write_text(json.dumps({
        "image": "img0.png", "question": "What color is the wall?",
        "question_id": 7, "answer": ["brown"] * 6 + ["tan"] * 4}) + "\n"
        + json.dumps({"image": "img1.png", "question": "Which?",
                      "question_id": 8, "answer": "left"}) + "\n")
    (d / "caption.json").write_text(json.dumps({
        "images": [{"id": 5, "file_name": "img0.png"},
                   {"id": 6, "file_name": "img1.png"}],
        "annotations": [{"image_id": 5, "caption": "a wall"},
                        {"image_id": 6, "caption": "noise"},
                        {"image_id": 5, "caption": "brown wall"}]}))
    (d / "karpathy.json").write_text(json.dumps([
        {"image": "img2.png", "caption": "a single caption"},
        {"image": "img0.png", "captions": ["one", "two"]}]))
    return d


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return write_bench(tmp_path_factory.mktemp("bench_port"))


def _loads(bench_dir):
    d = str(bench_dir)
    return [("mme", lambda R: R.load_mme(d + "/mme")),
            ("mme", lambda R: R.load_mme(d + "/mme", limit=1)),
            ("pope", lambda R: R.load_pope(d + "/pope.jsonl", d)),
            ("pope", lambda R: R.load_pope(d + "/pope.jsonl", d, limit=2)),
            ("mmbench", lambda R: R.load_mmbench(d + "/mmbench.tsv")),
            ("seed", lambda R: R.load_seed(d + "/seed.jsonl", d)),
            ("scienceqa", lambda R: R.load_scienceqa(d + "/sqa.jsonl", d)),
            ("mmvet", lambda R: R.load_mmvet(d + "/mmvet.json", d)),
            ("vqav2_val", lambda R: R.load_vqa_jsonl(d + "/vqa.jsonl", d)),
            ("gqa_testdev", lambda R: R.load_vqa_jsonl(d + "/vqa.jsonl", d)),
            ("caption", lambda R: R.load_caption(d + "/caption.json", d)),
            ("caption", lambda R: R.load_caption(d + "/karpathy.json", d))]


def test_loaders_and_images_match_jax(bench_dir):
    assert tR.VQA_SUITES == jR.VQA_SUITES
    assert set(tR.BENCHMARKS) == set(jR.BENCHMARKS)
    assert tR.CAPTION_PROMPT == jR.CAPTION_PROMPT
    for name, load in _loads(bench_dir):
        want, got = load(jR), load(tR)
        assert got == want, name
        for g, w in zip(tR._materialize_images(got),
                        jR._materialize_images(want)):
            np.testing.assert_array_equal(g.pop("image"), w.pop("image"))
            assert g == w


def test_mmbench_reads_base64_images_past_csvs_field_limit(tmp_path):
    """A 300 KB base64 PNG: JAX's loader stops at csv's default field
    limit (131072 characters, ROADMAP.md §C.2); the port's reads it, and
    leaves the limit as it found it."""
    import csv
    png = _png_bytes(40, (200, 400, 3))
    b64 = base64.b64encode(png).decode()
    assert len(b64) > 131072
    path = tmp_path / "big.tsv"
    path.write_text("index\tquestion\thint\tA\tB\tC\tD\tanswer\timage\n"
                    f"0\tWhat?\t\tred\tgreen\tblue\tpink\tA\t{b64}\n")
    before = csv.field_size_limit()
    with pytest.raises(csv.Error, match="field larger than field limit"):
        jR.load_mmbench(str(path))
    rows = tR.load_mmbench(str(path))
    assert csv.field_size_limit() == before
    assert rows[0]["image_b64"] == b64
    img = tR._materialize_images(rows)[0]["image"]
    np.testing.assert_array_equal(
        img, np.asarray(Image.open(io.BytesIO(png)).convert("RGB")))


PREDICTIONS = ["Yes, it is.", "no", "The answer is C.", "It looks blue",
               "red", "brown", "tan", "a wall", "left"]


def test_score_rows_matches_jax(bench_dir):
    for k, (name, load) in enumerate(_loads(bench_dir)):
        rows = load(jR)
        for i, r in enumerate(rows):
            r["prediction"] = PREDICTIONS[(i + k) % len(PREDICTIONS)]
        assert tR.score_rows(name, rows) == jR.score_rows(name, rows), name
    for bench in ("vizwiz_test", "docvqa_val", "chartqa_test_human"):
        rows = [{"prediction": "7", "answer": "7"}]
        assert tR.score_rows(bench, rows) == jR.score_rows(bench, rows)
    with pytest.raises(ValueError, match="unknown benchmark"):
        tR.score_rows("nope", [])


# ---------------------------------------------------------------------------
# run_vqa / run_benchmark on the tiny core
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cores():
    """The tiny JAX core (fp32) with its init params, the port's core with
    them loaded, and both greedy generate closures (JAX's compiled at XLA
    optimization level 0), each recording the tokens it returns."""
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_gdino=False, use_unipose=False, use_sd=False,
                           use_ip2p=False, use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jcore = JaxCore(jcfg, dtype=jnp.float32)
    ids = np.asarray([[1] + [jtid.imp] * IMAGE_TOKENS + [5, 6]], np.int32)
    params = jax.jit(lambda r: jcore.init(
        r, jnp.asarray(ids), jnp.zeros((1, IMAGE_SIZE, IMAGE_SIZE, 3)),
        jtid))(jax.random.PRNGKey(3))["params"]
    params = jax.tree.map(np.asarray, params)
    tcore = build_core(tconfig.tiny_test_config(use_gdino=False, gdino=None),
                       device="cpu", dtype=torch.float32)
    load_jax_params(tcore, params)

    jgen = jax_generate_fn(jcore, jtid, max_new_tokens=MAX_NEW,
                           max_len=MAX_LEN)
    inner = o0_jit(lambda p, i, im, m, lv: jgen.__wrapped__(
        p, i, im, attn_mask=m, live=lv))
    jtokens, ttokens = [], []

    def jgen_o0(p, i, im, attn_mask=None, live=None):
        out = inner(p, i, im, attn_mask, live)
        jtokens.append(np.asarray(out["out_tokens"])[
            :, :int(out["num_generated"])])
        return out

    tgen = build_generate_fn(tcore, SpecialTokenIds.synthetic(),
                             max_new_tokens=MAX_NEW, max_len=MAX_LEN)

    def tgen_rec(*a, **k):
        out = tgen(*a, **k)
        ttokens.append(out["out_tokens"][:, :out["num_generated"]].numpy())
        return out

    return params, jgen_o0, tgen_rec, jtokens, ttokens


def _questions(n):
    rng = np.random.default_rng(11)
    words = ["what", "color", "is", "the", "wall", "left", "of", "a", "dog"]
    return [{"image": rng.integers(0, 256, (30 + 7 * i, 40, 3),
                                   dtype=np.uint8),
             "question": " ".join(rng.choice(words, 3 + 2 * i)) + "?",
             "answer": "yes", "question_id": i} for i in range(n)]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_run_vqa_matches_jax_token_for_token(cores, batch_size):
    """Three questions of different prompt lengths: at B2 a full batch
    and a tail with a dead row."""
    params, jgen, tgen, jtokens, ttokens = cores
    tok = MockTokenizer()
    qs = _questions(3)
    jtokens.clear()
    ttokens.clear()
    want = jvqa.run_vqa(jgen, params, tok, qs, image_size=IMAGE_SIZE,
                        batch_size=batch_size)
    got = tvqa.run_vqa(tgen, tok, qs, image_token_len=IMAGE_TOKENS,
                       image_size=IMAGE_SIZE, batch_size=batch_size,
                       device="cpu")
    assert len(jtokens) == len(ttokens) == (3 if batch_size == 1 else 2)
    for g, w in zip(ttokens, jtokens):
        np.testing.assert_array_equal(g, w)
    assert got == want


@pytest.mark.parametrize("bench", ["pope", "mmbench"])
def test_run_benchmark_matches_jax(cores, bench_dir, bench):
    params, jgen, tgen, _, _ = cores
    tok = MockTokenizer()
    d = str(bench_dir)
    rows = (jR.load_pope(d + "/pope.jsonl", d) if bench == "pope"
            else jR.load_mmbench(d + "/mmbench.tsv"))
    for bs in (1, 4):
        want = jR.run_benchmark(bench, jgen, params, tok, rows,
                                image_size=IMAGE_SIZE, batch_size=bs)
        got = tR.run_benchmark(bench, tgen, tok, rows,
                               image_token_len=IMAGE_TOKENS,
                               image_size=IMAGE_SIZE, batch_size=bs,
                               device="cpu")
        assert got == want, bs


def test_run_vqa_prompts_count_the_shuffled_feature_rows():
    """Under pixel shuffle the prompt carries the model's feature rows
    (4 at 56 px), where JAX's `run_vqa` puts (56 // 14) ** 2 = 16."""
    cfg = tiny_26b(tconfig, image_size=IMAGE_SIZE)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        rows = core.encode_images(torch.zeros(1, IMAGE_SIZE, IMAGE_SIZE,
                                              3))[0].shape[1]
    tok = MockTokenizer()
    imp = tok.convert_tokens_to_ids("<im_patch>")
    seen = []

    def fake(ids, *a, **k):
        seen.append(np.asarray(ids))
        return {"out_tokens": torch.full((ids.shape[0], 1), 2),
                "num_generated": 1}

    for bs in (1, 2):
        seen.clear()
        tvqa.run_vqa(fake, tok, _questions(2),
                     image_token_len=cfg.image_token_len,
                     image_size=IMAGE_SIZE, batch_size=bs, device="cpu")
        assert all(int((s[0] == imp).sum()) == rows == 4 for s in seen)
        seen.clear()
        jvqa.run_vqa(lambda p, ids, *a, **k: fake(ids), None, tok,
                     _questions(2), image_size=IMAGE_SIZE, batch_size=bs)
        assert all(int((s[0] == imp).sum()) == 16 for s in seen)


def test_measure_latency_on_the_cpu():
    cfg = tconfig.tiny_test_config(use_gdino=False, gdino=None)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    res = measure_latency(core, SpecialTokenIds.synthetic(), prompt_len=40,
                          max_len=64, n_prefill=2, n_decode=4)
    assert set(res) == {"ttft_s", "decode_tok_s"}
    assert all(np.isfinite(v) and v > 0 for v in res.values())


def test_run_vqa_and_benchmarks_need_a_device_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvqa.run_vqa(None, MockTokenizer(), [], image_token_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tR.run_benchmark("pope", None, MockTokenizer(), [],
                         image_token_len=16)
