"""Tensor parallel serving of the port on a (data 2, model 2) mesh of
four gloo ranks on the CPU, against the JAX package's unsharded runs
(its `tests/test_generation_sharded.py` and the sharded slot step of
`tests/test_slots.py`).

One spawn (`tests/torch_dist_worker.py`) builds the tiny composite on
every rank from one flax param tree (`load_jax_params`), applies
`apply_shardings` (column / row parallel projections over "model",
FSDP2 over "data"), loads the tree again into the sharded model (each
DTensor parameter takes its shard) and runs greedy generate, a [DET]-forced generate,
the slot engine with staggered arrivals and `infer_det`:

* greedy tokens equal JAX's `build_generate_fn`'s, hidden states within
  1e-4, and the [DET]-forced run counts down the [EMB] rows;
* each slot stream equals its request's solo JAX run;
* `infer_det` within 1e-4 of JAX's (the top-k choices exactly);
* every rank gives the same answers, and the placements are those of
  the mesh rules;
* after a forward the layer units are sharded again and the root stays
  gathered (the order `apply_shardings` gives FSDP2's initialization);
* heads that "model" does not divide raise `ValueError`, int4 and LoRA
  layers `NotImplementedError` naming `ROADMAP.md` A.8.4;
* on a data-only mesh `apply_shardings` applies FSDP2 alone and the
  logits stay bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_unipose import o0_jit, random_flax_params
from tests.torch_dist_worker import run
from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.generation import build_generate_fn as jax_generate_fn
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.models.visionllm import VisionLLM as JaxCore
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds

WORLD = 4
MAX_NEW, MAX_LEN, SLOT_LEN, DET = 10, 128, 48, 128
TID = SpecialTokenIds.synthetic()
JTID = JaxTid.synthetic()
TOL = 1e-4


def _det_prompt(cfg):
    ids = [1, 10, 11] + [TID.imp] * cfg.vis_encoder.num_patches + [12]
    ids += [TID.det] + [TID.emb + i for i in range(cfg.num_embs)] + [13, 2]
    return np.asarray([ids], np.int32)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    jcfg = jax_tiny_config(use_unipose=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    size = jcfg.vis_encoder.image_size
    img_len = jcfg.vis_encoder.num_patches
    det_ids = _det_prompt(jcfg)

    def init_method(m, input_ids, images, images_aug, tid):
        m.core(input_ids, images, tid, compute_logits=True)
        return m.infer_det(input_ids, images, images_aug, tid)

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.asarray(det_ids), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, DET, DET, 3)), JTID, method=init_method),
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, random_flax_params(shapes, 0))

    rng = np.random.RandomState(0)
    # equal lengths: one compile of the JAX generate loop serves them all
    prompts = [[1, 5, 6] + [TID.imp] * img_len + [7, 8],
               [1] + [TID.imp] * img_len + [9, 10, 11, 12],
               [1, 13, 14, 15] + [TID.imp] * img_len + [16]]
    images = rng.rand(3, size, size, 3).astype(np.float32)
    det_images = (0.5 * rng.standard_normal((1, size, size, 3))).astype(
        np.float32)
    det_aug = (0.5 * rng.standard_normal((1, DET, DET, 3))).astype(np.float32)

    gen = jax_generate_fn(JaxCore(jcfg, dtype=jnp.float32), JTID,
                          max_new_tokens=MAX_NEW, max_len=MAX_LEN)
    want = {}
    ids0 = jnp.asarray([prompts[0]], jnp.int32)
    out = gen(params["core"], ids0, jnp.asarray(images[:1]))
    want["tokens"] = np.asarray(out["out_tokens"])
    want["hidden"] = np.asarray(out["out_hidden"])
    out = gen(params["core"], ids0, jnp.asarray(images[:1]),
              jnp.asarray([JTID.det], jnp.int32))
    want["tokens_det"] = np.asarray(out["out_tokens"])
    want["solo"] = []
    for i, p in enumerate(prompts):
        out = gen(params["core"], jnp.asarray([p], jnp.int32),
                  jnp.asarray(images[i:i + 1]))
        n = int(out["num_generated"])
        want["solo"].append(np.asarray(out["out_tokens"][0, :n]))
    det = o0_jit(lambda p, a, b, c: jmodel.apply(
        {"params": p}, a, b, c, JTID, method=JaxModel.infer_det))(
            params, jnp.asarray(det_ids), jnp.asarray(det_images),
            jnp.asarray(det_aug))
    want["det"] = {k: np.asarray(v) for k, v in det.items()}

    inputs = {"params": params, "max_new": MAX_NEW, "max_len": MAX_LEN,
              "ids": np.asarray([prompts[0]], np.int64),
              "images": images[:1], "prompts": prompts, "slot_images": images,
              "slot_len": SLOT_LEN, "arrivals": [0, 2, 4],
              "det_ids": det_ids.astype(np.int64), "det_images": det_images,
              "det_aug": det_aug}
    workdir = tmp_path_factory.mktemp("tp")
    torch.save(inputs, workdir / "inputs.pt")
    got = run("tp", WORLD, str(workdir))
    return got, want, jcfg


def test_tp_greedy_decode_matches_jax(tp):
    got, want, _ = tp
    for rank, res in enumerate(got):
        np.testing.assert_array_equal(res["tokens"], want["tokens"],
                                      err_msg=f"rank {rank}")
        np.testing.assert_allclose(res["hidden"], want["hidden"], atol=TOL,
                                   rtol=TOL, err_msg=f"rank {rank}")


def test_tp_det_countdown(tp):
    got, want, jcfg = tp
    for res in got:
        toks = res["tokens_det"][0]
        np.testing.assert_array_equal(toks, want["tokens_det"][0])
        assert toks[0] == TID.det
        np.testing.assert_array_equal(
            toks[1:1 + jcfg.num_embs],
            [TID.emb + i for i in range(jcfg.num_embs)])


def test_tp_slot_streams_match_solo(tp):
    got, want, _ = tp
    for res in got:
        for i, (stream, solo) in enumerate(zip(res["streams"], want["solo"])):
            np.testing.assert_array_equal(stream[:len(solo)], solo,
                                          err_msg=f"request {i}")


def test_tp_infer_det_matches_jax(tp):
    got, want, _ = tp
    n_valid = 1           # one [DET] group: the rest are fp32-min pads
    for rank, res in enumerate(got):
        det, ref = res["det"], want["det"]
        np.testing.assert_allclose(det["logits"][..., :n_valid],
                                   ref["logits"][..., :n_valid], atol=TOL,
                                   rtol=TOL, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(det["logits"][..., n_valid:],
                                      ref["logits"][..., n_valid:])
        for k in ("pred_boxes", "enc_boxes"):
            np.testing.assert_allclose(det[k], ref[k], atol=TOL, rtol=TOL,
                                       err_msg=f"rank {rank} {k}")
        # masks: 2e-4, as the unsharded parity test holds them
        np.testing.assert_allclose(det["pred_masks"], ref["pred_masks"],
                                   atol=2e-4, rtol=2e-4, err_msg=f"rank {rank}")


def test_tp_placements(tp):
    """TP projections are split over "model" (q/k/v/gate/up on the output
    dim, o/down on the input dim) and FSDP over "data" on JAX's data dim
    of the same weight; a parameter JAX leaves whole is split on dim 0."""
    placements = tp[0][0]["placements"]
    p = "core.llm.layers.0."
    # (data, model) mesh dims of a 2-D DTensor parameter
    assert placements[p + "q_proj.weight"] == [("Shard", 1), ("Shard", 0)]
    assert placements[p + "o_proj.weight"] == [("Shard", 0), ("Shard", 1)]
    assert placements[p + "input_layernorm.weight"] == [("Shard", 0)]
    assert placements["core.vis_encoder.layers.0.fc1.weight"] == [
        ("Shard", 1)]


def test_tp_units_after_forward(tp):
    """FSDP2 frees a layer unit after its forward (its parameters are the
    (data, model) shards again) and keeps the root unit gathered (its
    own parameters are whole tensors): the condition `apply_shardings`
    orders through FSDP2's private lazy init."""
    for res in tp[0]:
        before, after = res["placements"], res["placements_after"]
        for name in ("core.llm.layers.0.q_proj.weight",
                     "core.llm.layers.1.o_proj.weight",
                     "core.vis_encoder.layers.0.fc1.weight"):
            assert after[name] == before[name], name
        assert after["core.llm.layers.0.q_proj.weight"] == [
            ("Shard", 1), ("Shard", 0)]
        for name in ("core.llm.norm.weight", "core.llm.embed_tokens.weight"):
            assert len(after[name]) < 2, (name, after[name])
        assert after["core.llm.norm.weight"] == []


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_refusals")
    torch.save({}, workdir / "inputs.pt")
    return run("tp_refusals", 2, str(workdir))


def test_tp_refusals(refusals):
    for res in refusals:
        res = res["errors"]
        assert res["heads"].startswith("ValueError: model axis 2 must "
                                       "divide the LLM's 3 heads")
        for kind in ("int4", "lora"):
            assert res[kind].startswith("NotImplementedError")
            assert "ROADMAP.md A.8.4" in res[kind]


def test_data_only_mesh_applies_fsdp_alone(refusals):
    """A "model" axis of 1 splits nothing: `apply_shardings` leaves the
    projections plain modules under FSDP2 (the layer units' parameters
    sharded over "data" alone, the root's gathered), the cache at the
    whole kv heads, and the logits bit-equal."""
    for res in refusals:
        res = res["data_only"]
        assert res["equal"] and res["tp_size"] == 1
        assert res["placements"]["layers.0.q_proj.weight"] == [("Shard", 1)]
        for name, placements in res["placements"].items():
            if name.startswith("layers."):      # a layer unit: "data" shards
                assert len(placements) == 1 and placements[0][0] == "Shard", \
                    name
            else:                               # the root: gathered
                assert placements == [], name
