"""End-to-end parity of the port's `infer_det` against the JAX
`VisionLLMWithTools.infer_det` on the CPU, in fp32, at the tiny test
config (CLIP 2 layers, LLaMA 2 layers, Grounding-DINO 1+2 layers with a
Swin-T backbone on a 128 px det image). The JAX params go into the port
through `load_jax_params`; inputs are made with numpy from a seed.

Tolerance: 1e-4 abs + 1e-4 rel on logits / boxes, 2e-4 on masks. The
chain is ~40 fp32 layers deep, so summation-order differences add up to
a few 1e-6 relative; the top-k query selection must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.utils.convert import load_jax_params

DET = 128


def _prompt(cfg, tid, groups):
    ids = [1, 10, 11] + [tid.imp] * cfg.vis_encoder.num_patches + [12]
    for g in range(groups):
        ids += [tid.det] + [tid.emb + i for i in range(cfg.num_embs)]
        ids += [13 + g]
    return np.asarray([ids + [2]], np.int32)


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(use_unipose=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    ids = _prompt(jcfg, jtid, 1)
    size = jcfg.vis_encoder.image_size

    def init_method(m, input_ids, images, images_aug, tid):
        m.core(input_ids, images, tid, compute_logits=True)
        return m.infer_det(input_ids, images, images_aug, tid)

    params = jax.jit(lambda r: jmodel.init(
        r, jnp.asarray(ids), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, DET, DET, 3)), jtid, method=init_method))(
            jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(np.asarray, params)

    tmodel = build_model(tiny_test_config(use_unipose=False, unipose=None),
                         device="cpu", dtype=torch.float32)
    load_jax_params(tmodel, params)

    @jax.jit
    def jfwd(p, input_ids, images, images_aug):
        return jmodel.apply({"params": p}, input_ids, images, images_aug,
                            jtid, method=JaxModel.infer_det)

    return jcfg, params, jfwd, tmodel


@pytest.mark.parametrize("groups", [1, 2])
def test_infer_det_matches_jax(models, groups):
    jcfg, params, jfwd, tmodel = models
    tid = SpecialTokenIds.synthetic()
    ids = _prompt(jcfg, tid, groups)
    rng = np.random.default_rng(groups)
    size = jcfg.vis_encoder.image_size
    images = (0.5 * rng.standard_normal((1, size, size, 3))).astype(np.float32)
    aug = (0.5 * rng.standard_normal((1, DET, DET, 3))).astype(np.float32)

    want = jfwd(params, jnp.asarray(ids), jnp.asarray(images),
                jnp.asarray(aug))
    got = tmodel.infer_det(torch.from_numpy(ids).long(),
                           torch.from_numpy(images), torch.from_numpy(aug),
                           tid)
    n_valid = groups      # valid text columns; the rest are fp32-min pads
    np.testing.assert_allclose(got["logits"].numpy()[..., :n_valid],
                               np.asarray(want["logits"])[..., :n_valid],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got["logits"].numpy()[..., n_valid:],
                                  np.asarray(want["logits"])[..., n_valid:])
    np.testing.assert_allclose(got["pred_boxes"].numpy(),
                               np.asarray(want["pred_boxes"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["pred_masks"].numpy(),
                               np.asarray(want["pred_masks"]),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got["enc_boxes"].numpy(),
                               np.asarray(want["enc_boxes"]),
                               atol=1e-4, rtol=1e-4)
