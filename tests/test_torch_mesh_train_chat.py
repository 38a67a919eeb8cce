"""The chat group's train step on gloo meshes against JAX's step on the
global batch, on the CPU in fp32 at `tiny_test_config`'s chat composite
with the region encoder (the vision encoder frozen; the LLM trained, so
at model 2 its column- and row-parallel projections, embedding and head
train as tensor-parallel shards under FSDP2).

Each case runs two steps of `make_chat_train_step` on the mesh
(`shard_train_step`; each rank on one of the two rows, one with 2
padded tokens, so the token mean's count differs by rank) from the flax
tree JAX starts from; every rank reports JAX's loss and gradient norm,
and the gathered masters and Adam moments are JAX's
(`tests/mesh_train_ref.py` for the tolerance):

* `plain` on data 2 and on (data 2, model 2);
* on data 2: gradient accumulation at k = 2 (two micro-steps, the
  second on the rows swapped; JAX's `optax.MultiSteps`: the running
  mean is gathered too), the LLaMA under remat "full" (held to the plain
  JAX run: `jax.checkpoint` changes no value), and LoRA (r 4, the LLM's
  base frozen, its factors trained).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.mesh_train_ref import (DATA2, MESHES, check_metrics, check_state,
                                  f32, jax_steps, mesh_runs)
from tests.test_torch_chat_train import _batch, _cfg
from tests.test_torch_unipose import random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import runner as jrunner
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch.models.composite import build_model

OPT = dict(learning_rate=1e-3, total_steps=100)
LORA = dict(lora_r=4, lora_alpha=16.0)
JTID = JaxTid.synthetic()
EXTRA = ("k2", "remat", "lora")


def _swapped(b):
    return {k: v[::-1].copy() for k, v in b.items()}


def _jax_chat(lora):
    jcfg = jconfig.tiny_test_config(use_gdino=False, use_unipose=False,
                                    use_sd=False, use_ip2p=False,
                                    use_region_encoder=True)
    if lora:
        jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(
            jcfg.llm, **LORA))
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    jb = jax.tree.map(jnp.asarray, _batch(True))
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jb, JTID, method=JaxModel.forward_chat), jax.random.PRNGKey(0))
    params = f32(random_flax_params(shapes["params"], 11))
    return jcfg, jmodel, params


def _run_jax(jcfg, jmodel, params, freeze, batches, accum=1):
    jfrozen = jrunner.frozen_predicate(jrunner.TrainConfig(**freeze), jcfg)
    return jax_steps(
        params, lambda t: jstep.build_optimizer(
            jstep.OptimizerConfig(grad_accum_steps=accum, **OPT), t),
        lambda tx: jstep.make_chat_train_step(jmodel, tx, JTID,
                                              frozen=jfrozen),
        [jax.tree.map(jnp.asarray, b) for b in batches],
        [jax.random.PRNGKey(0)] * len(batches), jstep, jfrozen, accum)


@pytest.fixture(scope="module")
def chat(tmp_path_factory):
    b = _batch(True)
    jcfg, jmodel, params = _jax_chat(False)
    ljcfg, ljmodel, lparams = _jax_chat(True)
    cfg = _cfg()
    lcfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **LORA))
    rcfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                            remat="full"))
    base = dict(cfg=cfg, params=params, group="vlm", tc={}, opt=OPT,
                batches=[b, b], noises=[None, None])
    cases = {"plain": base,
             "k2": dict(base, batches=[b, _swapped(b)],
                        opt=dict(OPT, grad_accum_steps=2)),
             "remat": dict(base, cfg=rcfg),
             "lora": dict(base, cfg=lcfg, params=lparams,
                          tc={"freeze_llm": True})}
    work = tmp_path_factory.mktemp("mesh_chat")
    waits = [mesh_runs(cases, work, DATA2),
             mesh_runs({"plain": base}, work,
                       {"data2_model2": MESHES["data2_model2"]})]
    want = {"plain": _run_jax(jcfg, jmodel, params, {}, [b, b]),
            "k2": _run_jax(jcfg, jmodel, params, {}, [b, _swapped(b)], 2),
            "lora": _run_jax(ljcfg, ljmodel, lparams,
                             {"freeze_llm": True}, [b, b])}
    want["remat"] = want["plain"]
    got = {}
    for wait in waits:
        got.update(wait())
    models = {"plain": build_model(cfg, device="cpu", dtype=torch.float32),
              "lora": build_model(lcfg, device="cpu", dtype=torch.float32)}
    models["k2"] = models["remat"] = models["plain"]
    return want, got, models


@pytest.mark.parametrize("mesh", list(MESHES))
def test_chat_steps_on_mesh_report_jax_metrics(chat, mesh):
    want, got, _ = chat
    assert [r["plain"]["rows"] for r in got[mesh]] == [1] * len(got[mesh])
    check_metrics(got[mesh], want["plain"], "plain")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_chat_steps_on_mesh_reach_jax_state(chat, mesh):
    want, got, models = chat
    check_state(got[mesh], want["plain"], "plain", models["plain"],
                OPT["learning_rate"])
    masters = got[mesh][0]["plain"]["state"]["masters"]
    assert any(".q_proj." in n for n in masters)


@pytest.mark.parametrize("case", EXTRA)
def test_chat_variants_on_data_mesh_match_jax(chat, case):
    want, got, models = chat
    ranks = got["data2"]
    check_metrics(ranks, want[case], case)
    check_state(ranks, want[case], case, models[case], OPT["learning_rate"])
    res = ranks[0][case]
    if case == "k2":
        # one applied step after two micro-steps; the running mean is
        # zero again after it, as optax's
        assert res["steps"] == (2, 1)
        assert all(not np.any(a) for a in res["state"]["acc"].values())
    elif case == "lora":
        llm = [n for n in res["state"]["masters"] if n.startswith("core.llm")]
        assert llm and all("lora_" in n for n in llm)
    else:
        assert res["steps"] == (2, 2)
