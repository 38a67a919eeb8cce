"""The chat tool group's training path in the port against the JAX
package on the CPU, in fp32, at the tiny config with the region encoder
on and no tool decoder:

* `forward_chat` (loss, lm_loss, logits, ignore_flag) without and with
  `regions` (<region> tokens fed by the region encoder), 1e-4;
* one `make_chat_train_step` with stage-1 freezing (the vision encoder
  frozen), without and with regions: the loss and the gradient norm,
  1e-4;
* `LlavaChatDataset` ("llava") on the repo's JPEG fixtures: ids and
  labels identical to JAX's and pixels within 1e-6, for `pad` and
  `anyres` (the `dynamic_preprocess` tiles and their thumbnail), an image
  row and a text-only row; a missing image is replaced by a row drawn
  from the dataset's `rng`;
* `Trainer.train` over all five tool groups (chat, det, pose, [GEN],
  [EDIT]) from files: each group's step runs with finite metrics.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_train import _capture_grads
from tests.test_torch_trainer_tools import HEAD, _ds_cfgs
from tests.test_torch_trainer_tools import files  # noqa: F401 (a fixture)
from tests.test_torch_unipose import o0_jit, random_flax_params
from visionllm_tpu import config as jconfig
from visionllm_tpu.data.llava_dataset import LlavaChatDataset as JLlava
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.train import runner as jrunner
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.data.build import build_dataset, seeded_sample
from visionllm_tpu_torch.data.llava_dataset import LlavaChatDataset
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train import train_step as tstep
from visionllm_tpu_torch.train.runner import (NOT_PORTED, TrainConfig,
                                              Trainer, frozen_predicate)
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import HashedWordTokenizer

JPEGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "jpeg")
TID = SpecialTokenIds.synthetic()
JTID = JaxTid.synthetic()
SIZE = 56
IMG_LEN = 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(regions):
    rng = np.random.default_rng(1 if regions else 0)
    ids = [1, 9] + [TID.imp] * IMG_LEN + [11]
    if regions:
        ids += [TID.reg, 12, TID.reg, 13]
    ids = np.asarray([ids + [14, 15, 16, 17, 2]] * 2, np.int32)
    attn = np.ones_like(ids)
    attn[1, -2:] = 0
    b = {"input_ids": ids,
         "labels": np.where((ids >= 10) & (ids < 32000) & (attn > 0), ids,
                            -100).astype(np.int32),
         "attn_mask": attn,
         "images": (0.5 * rng.standard_normal((2, SIZE, SIZE, 3))
                    ).astype(np.float32)}
    if regions:
        masks = np.zeros((2, 2, SIZE, SIZE), np.float32)
        masks[0, 0, 4:20, 10:30] = 1
        masks[0, 1, 30:50, 5:15] = 1
        masks[1, 0, 10:40, 20:50] = 1
        masks[1, 1, :, SIZE - 6:] = 1
        b["regions"] = masks
    return b


def _port_batch(b):
    out = {k: _t(v) for k, v in b.items()}
    for k in ("input_ids", "labels", "attn_mask"):
        out[k] = out[k].long()
    return out


def _cfg():
    return tconfig.tiny_test_config(use_gdino=False, gdino=None,
                                    use_unipose=False, unipose=None,
                                    use_region_encoder=True)


@pytest.fixture(scope="module")
def chat():
    torch.set_num_threads(1)
    jcfg = jconfig.tiny_test_config(use_gdino=False, use_unipose=False,
                                    use_sd=False, use_ip2p=False,
                                    use_region_encoder=True)
    jmodel = JaxModel(jcfg, dtype=jnp.float32, tool_dtype=jnp.float32)
    jb = jax.tree.map(jnp.asarray, _batch(True))
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jb, JTID, method=JaxModel.forward_chat), jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, random_flax_params(shapes["params"],
                                                         11))
    return jcfg, jmodel, params


def _port_model(params):
    model = build_model(_cfg(), device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    return model


@pytest.mark.parametrize("regions", [False, True])
def test_forward_chat_matches_jax(chat, regions):
    _, jmodel, params = chat
    b = _batch(regions)
    want = o0_jit(lambda p, bb: jmodel.apply(
        {"params": p}, bb, JTID, method=JaxModel.forward_chat))(
            params, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got = _port_model(params).forward_chat(_port_batch(b), TID)
    assert sorted(got) == sorted(want)
    for k in ("loss", "lm_loss", "logits", "ignore_flag"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert float(want["ignore_flag"]) == 0.0


@pytest.mark.parametrize("regions", [False, True])
def test_chat_step_matches_jax(chat, regions):
    jcfg, jmodel, params = chat
    jfrozen = jrunner.frozen_predicate(jrunner.TrainConfig(), jcfg)
    tx = jstep.build_optimizer(
        jstep.OptimizerConfig(learning_rate=1e-3, total_steps=100),
        jstep.split_frozen(params, jfrozen)[0])
    tx = optax.chain(_capture_grads(), tx)
    state = jstep.TrainState.create(params, tx, frozen=jfrozen)
    fn = o0_jit(jstep.make_chat_train_step(jmodel, tx, JTID,
                                           frozen=jfrozen))
    b = _batch(regions)
    jstate, want = fn(state, jax.tree.map(jnp.asarray, b),
                      jax.random.PRNGKey(0))
    want = {k: float(v) for k, v in want.items()}
    want["grad_norm"] = float(np.sqrt(sum(
        np.sum(np.asarray(g, np.float64) ** 2)
        for g in jax.tree_util.tree_leaves(jstate.opt_state[0]))))

    model = _port_model(params)
    frozen = frozen_predicate(TrainConfig(), _cfg())
    ttx = tstep.build_optimizer(tconfig.OptimizerConfig(
        learning_rate=1e-3, total_steps=100), model, frozen)
    tstate = tstep.TrainState.create(model, ttx, frozen)
    step = tstep.make_chat_train_step(model, ttx, TID, frozen)
    tstate, got = step(tstate, _port_batch(b))
    assert sorted(got) == sorted(want) == ["grad_norm", "loss"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), v, err_msg=k, **TOL)
    if regions:
        trained = [n for n in tstate.masters if n.startswith(
            "core.region_encoder")]
        assert trained and all(not torch.equal(
            tstate.masters[n], dict(_port_model(params).named_parameters())
            [n]) for n in trained[:3])


# ---------------------------------------------------------------------------
# the llava dataset
# ---------------------------------------------------------------------------

def _fixtures():
    return sorted(f for f in os.listdir(JPEGS) if f.endswith(".jpg"))


@pytest.fixture(scope="module")
def llava_ann(tmp_path_factory):
    d = tmp_path_factory.mktemp("llava")
    rows = [{"image": f, "conversations": [
        {"from": "human", "value": f"<image>\nDescribe picture {i}."},
        {"from": "gpt", "value": f"A photo of thing {i} and more."},
        {"from": "human", "value": "And the colour?"},
        {"from": "gpt", "value": "Mostly grey."}]}
        for i, f in enumerate(_fixtures()[:4])]
    rows.append({"conversations": [
        {"from": "human", "value": "What is two and two?"},
        {"from": "gpt", "value": "Four."}]})
    path = str(d / "llava.json")
    with open(path, "w") as f:
        json.dump(rows, f)
    return path, len(rows)


@pytest.mark.parametrize("aspect", ["pad", "anyres"])
def test_llava_dataset_matches_jax(llava_ann, aspect):
    path, n = llava_ann
    tok = MockTokenizer()
    kw = dict(image_size=SIZE, image_aspect_ratio=aspect, image_max_tile=4)
    jds = JLlava(path, JPEGS, tok, **kw)
    ds = build_dataset({"type": "llava", "ann_file": path,
                        "image_folder": JPEGS, **kw}, tok,
                       image_token_len=IMG_LEN)
    assert isinstance(ds, LlavaChatDataset) and len(ds) == n == len(jds)
    tiles = set()
    for i in range(n):
        want, got = jds[i], ds[i]
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["img_metas"] == want["img_metas"]
        if "image" in want:
            assert got["image"].shape == want["image"].shape
            np.testing.assert_allclose(got["image"], want["image"],
                                       rtol=1e-6, atol=1e-6)
            tiles.add(got["image"].shape[0])
    if aspect == "pad":
        assert tiles == {1}
    else:
        assert max(tiles) > 1, tiles


def test_llava_missing_image_takes_a_seeded_substitute(tmp_path):
    rows = [{"image": "missing.jpg", "conversations": [
        {"from": "human", "value": "<image>\nhi"},
        {"from": "gpt", "value": "there"}]}] + [
        {"image": f, "conversations": [
            {"from": "human", "value": f"<image>\nrow {i}"},
            {"from": "gpt", "value": "ok"}]}
        for i, f in enumerate(_fixtures()[:3])]
    path = str(tmp_path / "rows.json")
    with open(path, "w") as f:
        json.dump(rows, f)
    ds = LlavaChatDataset(path, JPEGS, MockTokenizer(),
                          image_token_len=IMG_LEN, image_size=SIZE)
    a = seeded_sample(ds, 0, "0:1:0")
    b = seeded_sample(ds, 0, "0:1:0")
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    rng, sub = random.Random("0:1:0"), 0
    while sub == 0:                     # row 0's image is missing
        sub = rng.randrange(len(rows))
    np.testing.assert_array_equal(a["input_ids"], ds._get(sub)["input_ids"])
    bad = LlavaChatDataset(path, str(tmp_path), MockTokenizer(),
                           image_token_len=IMG_LEN, image_size=SIZE)
    with pytest.raises(FileNotFoundError):
        bad[0]


# ---------------------------------------------------------------------------
# Trainer.train over the five tool groups
# ---------------------------------------------------------------------------

# the sampler seed whose first 5 batches hold one batch of each group
FIVE_SEED = 1


def test_trainer_trains_five_groups(files, tmp_path):  # noqa: F811
    assert NOT_PORTED == {}
    root, paths = files
    chat = str(tmp_path / "chat.json")
    with open(chat, "w") as f:
        json.dump([{"image": f"img{i}.jpg", "conversations": [
            {"from": "human", "value": f"<image>\nwhat is box {i}?"},
            {"from": "gpt", "value": f"a red box {i}"}]} for i in range(4)],
                  f)
    cfg = tconfig.tiny_test_config(
        use_sd=True, sd=tconfig.SDConfig(**HEAD), use_ip2p=True,
        ip2p=tconfig.IP2PConfig(**HEAD))
    tc = TrainConfig(output_dir=str(tmp_path / "out"), batch_size=2,
                     total_steps=5, log_every=1, save_every=100,
                     num_workers=2, freeze_llm=True, freeze_backbone=True,
                     seed=FIVE_SEED,
                     optimizer=tconfig.OptimizerConfig(learning_rate=1e-3,
                                                       total_steps=10))
    trainer = Trainer(cfg, tc, TID, device="cpu", dtype=torch.float32)
    ds_cfgs = _ds_cfgs(root, paths, cfg) + [
        {"type": "llava", "ann_file": chat, "image_folder": root,
         "image_size": cfg.vis_encoder.image_size}]
    state = trainer.train(ds_cfgs, HashedWordTokenizer())
    assert state.step == 5
    groups = [h["group"] for h in trainer.history]
    assert sorted(groups) == ["gdino", "ip2p", "sd", "unipose", "vlm"]
    with open(os.path.join(tc.output_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for g, row in zip(groups, rows):
        assert all(np.isfinite(v) for v in row.values()), row
        if g == "vlm":
            assert sorted(k for k in row if k not in ("step", "time")) == [
                "grad_norm", "loss"]
