"""Parity of the port's UniPose inference forward and `infer_pose`
against the JAX package on the CPU, in fp32, at the tiny test config
(UniPose d32, 1 encoder and 3 decoder layers of which 2 box layers, 4
body points, 5 groups, on a Swin-T backbone; CLIP and LLaMA 2 layers).
The flax param tree's shapes come from `jax.eval_shape` of the JAX init
and its values from numpy with a seed (`random_flax_params`: no norm at
exactly 1, no bias at 0); the tree goes into the port through
`load_jax_params`. The JAX side compiles at XLA's backend optimization
level 0 (`o0_jit`), which halves the compile time of these graphs on the
CPU and changes no operation.

The first sample pads the bottom half of a 128 px image, so its padding
spans a whole cell of the stride-64 level and the encoder proposals hold
masked (tied) entries; those tie with one another only, and every tied
entry has the same logits and boxes, so `enc_logits` and `enc_boxes`
compare whatever order a top-k gives the ties. Keypoint query slots are
cropped (5 > 4 body points) in one case and padded (3 < 4) in the other.

Tolerance: 1e-4 abs + 1e-4 rel on logits (valid text columns), boxes and
keypoints; the padded text columns hold the fp32 minimum exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.unipose.model import UniPose as JaxUniPose
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.unipose.model import UniPose
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

DET = 128
TOL = dict(atol=1e-4, rtol=1e-4)
# per sample: valid (rows, columns) of the det image, object query slots
# valid, keypoint query slots valid
CASES = {
    "crop": (((64, DET), [True, True, False], [True, False, True, True,
                                                True]),
             ((DET, 96), [True, False, False], [True, True, True, False,
                                                  False])),
    "pad": (((96, 80), [True, False], [True, True, False]),),
}


def o0_jit(fn):
    """`jax.jit(fn)` for positional array arguments, each new argument
    signature compiled with `xla_backend_optimization_level` 0."""
    cache = {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in cache:
            cache[key] = jax.jit(fn).lower(*args).compile(
                {"xla_backend_optimization_level": 0})
        return cache[key](*args)

    return call


def random_flax_params(shapes, seed):
    """numpy values for a flax param tree given as shapes: Dense and conv
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1), learned query
    and level embeddings ~ N(0, 1), every other leaf ~ N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(s.shape[:-1]) if len(s.shape) == 4 \
                else s.shape[-2]
            return x / np.sqrt(fan_in)
        if name in ("scale", "weight"):
            return 1.0 + 0.1 * x
        if name in ("level_embed", "tgt_embed", "hw", "hw_append",
                    "query_position_embeddings"):
            return x
        return 0.02 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_cfg():
    return jax_tiny_config(use_gdino=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)


def _inputs(name, text_dim, num_embs):
    samples = CASES[name]
    B = len(samples)
    rng = np.random.default_rng(list(CASES).index(name))
    pix = (0.5 * rng.standard_normal((B, DET, DET, 3))).astype(np.float32)
    mask = np.zeros((B, DET, DET), bool)
    for b, ((rows, cols), _, _) in enumerate(samples):
        mask[b, :rows, :cols] = True
    obj_m = np.asarray([obj for _, obj, _ in samples])
    kpt_m = np.asarray([kpt for _, _, kpt in samples])
    obj_q = rng.standard_normal((B, obj_m.shape[1], num_embs, text_dim)
                                ).astype(np.float32)
    kpt_q = rng.standard_normal((B, kpt_m.shape[1], num_embs, text_dim)
                                ).astype(np.float32)
    return pix, obj_q, obj_m, kpt_q, kpt_m, mask


def _assert_pose_close(got, want, obj_valid):
    """obj_valid [B, P_obj]: the valid text columns of the logits."""
    gl, wl = got["pred_logits"].numpy(), np.asarray(want["pred_logits"])
    cols = np.broadcast_to(obj_valid[:, None], gl.shape)
    np.testing.assert_allclose(gl[cols], wl[cols], **TOL)
    np.testing.assert_array_equal(gl[~cols], wl[~cols])
    for key in ("pred_boxes", "pred_keypoints"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL)


@pytest.fixture(scope="module")
def unipose(composite):
    jcfg, params, _, _ = composite
    jmod = JaxUniPose(jcfg.unipose, jnp.float32)
    tmod = UniPose(tiny_test_config().unipose)
    load_jax_params(tmod, params["unipose"])

    fwd = o0_jit(lambda p, pix, oq, om, kq, km, mask: jmod.apply(
        {"params": p}, pix, oq, om, kq, km, pixel_mask=mask))
    return (jcfg.unipose, lambda *a: fwd(params["unipose"], *a),
            tmod.eval())


@pytest.mark.parametrize("name", list(CASES))
def test_unipose_forward_matches_jax(unipose, name):
    cfg, jfwd, tmod = unipose
    ins = _inputs(name, cfg.text_dim, 4)
    want = jfwd(*[jnp.asarray(a) for a in ins])
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) for a in ins[:5]],
                   pixel_mask=torch.from_numpy(ins[5]))
    n_obj = ins[2].shape[1]
    B = ins[0].shape[0]
    G, nb = cfg.num_groups, cfg.num_body_points
    assert got["pred_logits"].shape == (B, G, ins[2].shape[1])
    assert got["pred_keypoints"].shape == (B, G, 3 * nb)
    _assert_pose_close(got, want, ins[2])
    ge, we = got["enc_logits"].numpy(), np.asarray(want["enc_logits"])
    cols = np.broadcast_to(ins[2][:, None], ge.shape)
    np.testing.assert_allclose(ge[cols], we[cols], **TOL)
    np.testing.assert_allclose(got["enc_boxes"].numpy(),
                               np.asarray(want["enc_boxes"]), **TOL)


def test_hw_append_is_a_parameter_past_17_body_points():
    """`hw_append` holds the keypoint priors past the 17 COCO ones: a
    parameter at 68 body points, absent at 4 (JAX keeps a constant
    [0, 2] there), so `load_jax_params` fills both layouts."""
    import dataclasses
    small = dataclasses.replace(tiny_test_config().unipose,
                                num_body_points=4)
    big = dataclasses.replace(small, num_body_points=68)
    names_small = dict(UniPose(small).named_parameters())
    names_big = dict(UniPose(big).named_parameters())
    assert "hw_append" not in names_small and names_small["hw"].shape == (4, 2)
    assert names_big["hw"].shape == (17, 2)
    assert names_big["hw_append"].shape == (51, 2)


def _pose_prompt(tid, n_img, n_kpt, num_embs=4):
    embs = [tid.emb + i for i in range(num_embs)]
    ids = [1, 10, 11] + [tid.imp] * n_img + [12, tid.det] + embs + [13]
    for k in range(n_kpt):
        ids += [tid.pose] + embs + [20 + k]
    return np.asarray([ids + [2]], np.int32)


@pytest.fixture(scope="module")
def composite():
    torch.set_num_threads(1)
    jcfg = _jax_cfg()
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    size = jcfg.vis_encoder.image_size
    ids = jnp.asarray(_pose_prompt(jtid, jcfg.vis_encoder.num_patches, 4))

    def init_method(m, input_ids, images, images_aug, tid):
        m.core(input_ids, images, tid, compute_logits=True)
        return m.infer_pose(input_ids, images, images_aug, tid, 1)

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, ids, jnp.zeros((1, size, size, 3)), jnp.zeros((1, DET, DET, 3)),
        jtid, method=init_method), jax.random.PRNGKey(0))["params"]
    params = random_flax_params(shapes, 0)
    tmodel = build_model(tiny_test_config(use_gdino=False, gdino=None),
                         device="cpu", dtype=torch.float32)
    load_jax_params(tmodel, params)

    fwd = o0_jit(lambda p, input_ids, images, images_aug, pixel_mask:
                 jmodel.apply({"params": p}, input_ids, images, images_aug,
                              jtid, 1, pixel_mask=pixel_mask,
                              method=JaxModel.infer_pose))
    return jcfg, params, lambda *a: fwd(params, *a), tmodel


@pytest.mark.parametrize("n_kpt", [3])
def test_infer_pose_matches_jax(composite, n_kpt):
    jcfg, _, jfwd, tmodel = composite
    tid = SpecialTokenIds.synthetic()
    ids = _pose_prompt(tid, jcfg.vis_encoder.num_patches, n_kpt)
    rng = np.random.default_rng(10 + n_kpt)
    size = jcfg.vis_encoder.image_size
    images = (0.5 * rng.standard_normal((1, size, size, 3))).astype(
        np.float32)
    aug = (0.5 * rng.standard_normal((1, DET, DET, 3))).astype(np.float32)
    mask = np.zeros((1, DET, DET), bool)
    mask[:, :, :96] = True
    want = jfwd(jnp.asarray(ids), jnp.asarray(images), jnp.asarray(aug),
                jnp.asarray(mask))
    got = tmodel.infer_pose(torch.from_numpy(ids).long(),
                            torch.from_numpy(images), torch.from_numpy(aug),
                            tid, 1, pixel_mask=torch.from_numpy(mask))
    _assert_pose_close(got, want, np.ones((1, 1), bool))
