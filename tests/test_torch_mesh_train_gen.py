"""The [GEN] and [EDIT] groups' train steps on a gloo mesh of data 2
against JAX's steps on the global batch, on the CPU
in fp32 at `tiny_test_config` with the tiny SD / IP2P heads (the vision
encoder, the LLM and the [GEN] UNet frozen; the [EDIT] UNet trained).

Two steps of `make_gen_train_step` (gen and edit) on the mesh
(`shard_train_step`; each rank on one of the two rows) from the flax
tree JAX starts from, with the JAX heads' draws for the global batch
(`tests/test_torch_gen_train.jax_gen_noise`): every rank reports JAX's
metrics and gradient norm (the image and caption losses are means over
the global batch: each rank's mean of its equal share, over the two
shares, summed), and the gathered masters and Adam moments are JAX's
(`tests/mesh_train_ref.py` for the tolerance; tensor parallelism:
`tests/test_torch_mesh_train_chat.py` and `_det.py`). The UNets keep
their conv weights in channels_last on every device (`unet.MAP_FORMAT`),
which FSDP2 refuses to shard: the trained [EDIT] UNet's stay whole on
each rank, the step sums their gradients over the data ranks itself and
the clipping norm counts them once (`parallel.mesh.holders`).
"""

import pytest
import torch

import jax
import jax.numpy as jnp

from tests.mesh_train_ref import (DATA2, check_metrics, check_state, f32,
                                  jax_steps, mesh_runs)
from tests.test_torch_gen_train import HEAD, _batch_np, _tree, jax_gen_noise
from visionllm_tpu import config as jconfig
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import runner as jrunner
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch.models.composite import build_model

OPT = dict(learning_rate=1e-3, total_steps=1000)
FREEZE = dict(freeze_llm=True)
KEYS = (51, 52)
GROUPS = {"sd": False, "ip2p": True}


@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    jcfg = jconfig.tiny_test_config(use_gdino=False, use_unipose=False,
                                    use_region_encoder=False)
    jtid = JaxTid.synthetic()
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    batches = {e: _batch_np(jcfg, jtid, e) for e in (False, True)}
    jb = {e: jax.tree.map(jnp.asarray, b) for e, b in batches.items()}

    def init_method(m, gen, edit, tid, rng):
        m.forward_gen(gen, tid, rng)
        out = m.forward_edit(edit, tid, rng)
        # the heads' __call__ also makes the VAE decoders' params
        embs = jnp.zeros((2, 8, 64))
        m.sd(embs, gen["output_images"], rng)
        m.ip2p(embs, edit["input_images"], edit["output_images"], rng)
        return out

    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jb[False], jb[True], jtid, r, method=init_method),
        jax.random.PRNGKey(0))
    params = f32(_tree(shapes, 5))
    jfrozen = jrunner.frozen_predicate(jrunner.TrainConfig(**FREEZE), jcfg)
    keys = [jax.random.PRNGKey(k) for k in KEYS]
    want, cases = {}, {}
    cfg = pconfig.tiny_test_config(
        use_gdino=False, gdino=None, use_unipose=False, unipose=None,
        use_sd=True, sd=pconfig.SDConfig(**HEAD), use_ip2p=True,
        ip2p=pconfig.IP2PConfig(**HEAD))
    for group, edit in GROUPS.items():
        cases[group] = dict(
            cfg=cfg, params=params, group=group, tc=FREEZE, opt=OPT,
            batches=[batches[edit]] * 2,
            noises=[jax_gen_noise(k, 2, edit) for k in keys])
    got = mesh_runs(cases, tmp_path_factory.mktemp("mesh_gen"), DATA2)
    for group, edit in GROUPS.items():
        want[group] = jax_steps(
            params, lambda t: jstep.build_optimizer(
                jstep.OptimizerConfig(**OPT), t),
            lambda tx, e=edit: jstep.make_gen_train_step(
                jmodel, tx, jtid, edit=e, frozen=jfrozen),
            [jb[edit]] * 2, keys, jstep, jfrozen)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    return want, got(), model


@pytest.mark.parametrize("mesh", list(DATA2))
@pytest.mark.parametrize("group", list(GROUPS))
def test_gen_steps_on_mesh_report_jax_metrics(gen, group, mesh):
    want, got, _ = gen
    assert [r[group]["rows"] for r in got[mesh]] == [1] * len(got[mesh])
    check_metrics(got[mesh], want[group], group)


@pytest.mark.parametrize("mesh", list(DATA2))
@pytest.mark.parametrize("group", list(GROUPS))
def test_gen_steps_on_mesh_reach_jax_state(gen, group, mesh):
    want, got, model = gen
    assert got[mesh][0][group]["steps"] == (2, 2)
    check_state(got[mesh], want[group], group, model, OPT["learning_rate"])
    # the trained [EDIT] UNet's conv weights, whole on each rank
    whole = got[mesh][0][group]["whole"]
    assert whole and all(n.startswith("ip2p.unet.") and n.endswith(".weight")
                         for n in whole), whole
    if group == "ip2p":
        assert set(whole) < set(got[mesh][0][group]["state"]["masters"])
