"""The pose group's train step on a gloo mesh of data 2 against JAX's
step on the global batch, on the CPU in fp32 at
`tiny_test_config`'s UniPose (3 decoder layers, CDN; the vision encoder,
the LLM and the Swin backbone frozen).

Two steps of `make_pose_train_step` on the mesh (`shard_train_step`;
each rank on one of the two rows, one of which has padding in its pixel
mask) from the flax tree JAX starts from, with the JAX step's CDN draws
for the global batch (`tests/test_torch_pose_train.jax_pose_noise`):
every rank reports JAX's metrics and gradient norm (the normalizer
counts the 5 boxes of both rows), and the gathered masters and Adam
moments are JAX's (`tests/mesh_train_ref.py` for the tolerance; tensor
parallelism: `tests/test_torch_mesh_train_chat.py`).
"""

import dataclasses

import pytest
import torch

import jax
import jax.numpy as jnp

from tests.mesh_train_ref import (DATA2, check_metrics, check_state, f32,
                                  jax_steps, mesh_runs)
from tests.test_torch_pose_train import B, N, _batch_np, jax_pose_noise
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
KEYS = (41, 42)


@pytest.fixture(scope="module")
def pose(tmp_path_factory):
    jcfg = jax_tiny_config(use_gdino=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    bnp = _batch_np(jcfg, jtid, jcfg.unipose.num_body_points)
    jb = jax.tree.map(jnp.asarray, bnp)

    def init_method(m, batch, tid):
        m.core(batch["input_ids"], batch["images"], tid, compute_logits=True)
        return m.forward_pose(batch, tid, 1, jax.random.PRNGKey(0))

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jb, jtid, method=init_method), jax.random.PRNGKey(0))["params"]
    params = f32(random_flax_params(shapes, 3))
    keys = [jax.random.PRNGKey(k) for k in KEYS]
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    assert dataclasses.asdict(cfg.unipose) == dataclasses.asdict(
        jcfg.unipose)
    noises = [jax_pose_noise(k, cfg.unipose.dn_number, (B, N)) for k in keys]
    case = dict(cfg=cfg, params=params, group="unipose", tc=FREEZE, opt=OPT,
                batches=[bnp, bnp], noises=noises)
    got = mesh_runs({"pose": case}, tmp_path_factory.mktemp("mesh_pose"),
                    DATA2)
    jfrozen = jrunner.frozen_predicate(jrunner.TrainConfig(**FREEZE), jcfg)
    want = jax_steps(
        params, lambda t: jstep.build_optimizer(
            jstep.OptimizerConfig(**OPT), t),
        lambda tx: jstep.make_pose_train_step(jmodel, tx, jtid, 1,
                                              frozen=jfrozen),
        [jb, jb], keys, jstep, jfrozen)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    return want, got(), model


@pytest.mark.parametrize("mesh", list(DATA2))
def test_pose_steps_on_mesh_report_jax_metrics(pose, mesh):
    want, got, _ = pose
    assert [r["pose"]["rows"] for r in got[mesh]] == [1] * len(got[mesh])
    check_metrics(got[mesh], want, "pose")


@pytest.mark.parametrize("mesh", list(DATA2))
def test_pose_steps_on_mesh_reach_jax_state(pose, mesh):
    want, got, model = pose
    assert got[mesh][0]["pose"]["steps"] == (2, 2)
    check_state(got[mesh], want, "pose", model, OPT["learning_rate"])
