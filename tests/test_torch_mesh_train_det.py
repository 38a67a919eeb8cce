"""The det group's train step on gloo meshes of data 2 and of (data 2,
model 2) against JAX's step on the global batch, on the CPU in fp32 at
`tiny_test_config` (Grounding-DINO with CDN and masks; the vision
encoder and the LLM frozen, as in stage 1, and the Swin backbone too,
which keeps JAX's compile and the gathered state small; the Trainer's
mesh tests train a backbone).

Two steps of `make_det_train_step` on each mesh (`shard_train_step`:
the model under FSDP2, and at model 2 the frozen LLM split by tensor
parallelism, so the trainable bridge's and Grounding-DINO's gradients
come back through its column- and row-parallel backward; each rank on
one of the two rows) from the flax tree JAX starts from, with the JAX
step's draws for the global batch (`tests/test_torch_train.jax_noise`):
every rank reports JAX's metrics and gradient norm, the global batch's
(the normalizers count the boxes of both rows: 2 on one data rank, 3 on
the other), and the gathered masters and Adam moments are JAX's
(`tests/mesh_train_ref.py` for the tolerance).
"""

import pytest
import torch

import jax
import jax.numpy as jnp

from tests.mesh_train_ref import (MESHES, check_metrics, check_state, f32,
                                  jax_steps, mesh_runs)
from tests.test_torch_train import _batch_np, jax_noise
from tests.test_torch_unipose import random_flax_params
from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import runner as jrunner
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch.config import tiny_test_config
from visionllm_tpu_torch.models.composite import build_model

OPT = dict(learning_rate=1e-3, total_steps=1000)
FREEZE = dict(freeze_llm=True, freeze_backbone=True)
KEYS = (31, 32)


@pytest.fixture(scope="module")
def det(tmp_path_factory):
    jcfg = jax_tiny_config(use_unipose=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    bnp = _batch_np(jcfg, jtid)
    jb = jax.tree.map(jnp.asarray, bnp)
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jb, jtid),
                            jax.random.PRNGKey(0))["params"]
    params = f32(random_flax_params(shapes, 0))
    keys = [jax.random.PRNGKey(k) for k in KEYS]
    cfg = tiny_test_config(use_unipose=False, unipose=None)
    noises = [jax_noise(k, jcfg.gdino, bnp["targets"]["labels"].shape)
              for k in keys]
    case = dict(cfg=cfg, params=params, group="gdino",
                tc=FREEZE, opt=OPT, batches=[bnp, bnp],
                noises=noises)
    got = mesh_runs({"det": case}, tmp_path_factory.mktemp("mesh_det"))
    jfrozen = jrunner.frozen_predicate(jrunner.TrainConfig(**FREEZE), jcfg)
    want = jax_steps(
        params, lambda t: jstep.build_optimizer(
            jstep.OptimizerConfig(**OPT), t),
        lambda tx: jstep.make_det_train_step(jmodel, tx, jtid,
                                             frozen=jfrozen),
        [jb, jb], keys, jstep, jfrozen)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    return want, got(), model


@pytest.mark.parametrize("mesh", list(MESHES))
def test_det_steps_on_mesh_report_jax_metrics(det, mesh):
    want, got, _ = det
    assert [r["det"]["rows"] for r in got[mesh]] == [1] * len(got[mesh])
    check_metrics(got[mesh], want, "det")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_det_steps_on_mesh_reach_jax_state(det, mesh):
    want, got, model = det
    assert got[mesh][0]["det"]["steps"] == (2, 2)
    check_state(got[mesh], want, "det", model, OPT["learning_rate"])
