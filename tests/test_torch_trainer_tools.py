"""`Trainer.train` over all four tool groups on the CPU, at the tiny test
config with the tiny [GEN] / [EDIT] heads: COCO detection, COCO
keypoints (4 joints, the tiny UniPose's body points), text-to-image and
editing pairs over small Pillow JPEGs, interleaved by the
`TaskGroupedBatchSampler` (a batch never mixes groups), in fp32.

* Each group's step runs (det, pose, [GEN], [EDIT]) with finite metrics
  under its own keys, and the last checkpoint holds the run's state.
* 2 steps, then a fresh Trainer resuming from that checkpoint for 2 more,
  ends bit for bit where 4 straight steps do: the metrics of every step,
  the fp32 masters, both Adam moments and the parameters, whichever
  group each step took (`HashedWordTokenizer` and
  `torch.use_deterministic_algorithms(True)`, as in
  `tests/test_torch_trainer.py`).
* The frozen parameters (vision encoder, LLM, the tools' backbones, the
  [GEN] UNet, both VAEs; the backbones frozen keep the checkpoints at
  19 MB) are unchanged; the trained ones of every tool moved.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train.runner import TrainConfig, Trainer
from visionllm_tpu_torch.utils import checkpoint as tckpt
from visionllm_tpu_torch.utils.simple_tokenizer import HashedWordTokenizer

HEAD = dict(llm_hidden_size=64, sd_hidden_size=32, num_queries=7,
            num_embs_gen=8, sample_size=16, cross_attention_dim=32)
KPTS = ["nose", "left eye", "right eye", "left ear"]
GROUPS = {"gdino", "unipose", "sd", "ip2p"}
# the run's seed: its sampler's first 4 batches hold one of each group
SEED = 1


def _cfg():
    return tconfig.tiny_test_config(
        use_sd=True, sd=tconfig.SDConfig(**HEAD), use_ip2p=True,
        ip2p=tconfig.IP2PConfig(**HEAD))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_train")
    rng = np.random.default_rng(0)
    imgs, det, pose = [], [], []
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                        ).save(d / f"img{i}.jpg", quality=90)
        imgs.append({"id": i, "file_name": f"img{i}.jpg", "width": 64,
                     "height": 48})
        box = [5.0 + i, 5.0, 30.0, 25.0]
        det.append({"id": i + 1, "image_id": i, "category_id": 1 + i % 2,
                    "bbox": box, "area": 750, "iscrowd": 0})
        xy = rng.uniform([5 + i, 5], [35 + i, 30], (4, 2))
        v = np.asarray([2, 1, 2, 0 if i % 2 else 2])
        kp = np.concatenate([np.where(v[:, None] > 0, xy, 0), v[:, None]],
                            1).ravel().tolist()
        pose.append(dict(det[-1], category_id=1, keypoints=kp,
                         num_keypoints=int((v > 0).sum())))
    paths = {}
    for name, anns, cats in (
            ("det", det, [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}]),
            ("pose", pose, [{"id": 1, "name": "person"}])):
        paths[name] = str(d / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({"images": imgs, "annotations": anns,
                       "categories": cats}, f)
    paths["t2i"] = str(d / "t2i.json")
    with open(paths["t2i"], "w") as f:
        json.dump([{"image": f"img{i}.jpg", "caption": f"a red box {i}"}
                   for i in range(4)], f)
    paths["ip2p"] = str(d / "ip2p.json")
    with open(paths["ip2p"], "w") as f:
        json.dump([{"input_image": f"img{i}.jpg",
                    "output_image": f"img{(i + 1) % 4}.jpg",
                    "instruction": "swap the colours"} for i in range(4)], f)
    return str(d), paths


def _ds_cfgs(root, paths, cfg):
    small = {"image_size": cfg.vis_encoder.image_size,
             "train_scales": [(48, 64)], "buckets": ((64, 64),)}
    gen = {"img_prefix": root, "output_size": 32,
           "num_embs_gen": cfg.sd.num_embs_gen}
    return [
        {"type": "coco_det", "ann_file": paths["det"], "img_prefix": root,
         "max_gt_per_img": 4, **small},
        {"type": "coco_pose", "ann_file": paths["pose"], "img_prefix": root,
         "keypoint_names": KPTS, "num_body_points": 4, "max_gt_per_img": 4,
         **small},
        {"type": "text2img", "ann_file": paths["t2i"], **gen},
        {"type": "ip2p", "ann_file": paths["ip2p"],
         "image_size": cfg.vis_encoder.image_size, **gen},
    ]


def _train(files, out, steps, num_workers):
    root, paths = files
    cfg = _cfg()
    tc = TrainConfig(output_dir=out, batch_size=2, total_steps=100,
                     log_every=1, save_every=2, num_workers=num_workers,
                     freeze_llm=True, freeze_backbone=True, seed=SEED,
                     optimizer=tconfig.OptimizerConfig(learning_rate=1e-3,
                                                       total_steps=10))
    trainer = Trainer(cfg, tc, SpecialTokenIds.synthetic(), device="cpu",
                      dtype=torch.float32)
    state = trainer.train(_ds_cfgs(root, paths, cfg), HashedWordTokenizer(),
                          max_steps=steps)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return trainer, state, rows


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    torch.set_num_threads(1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = str(tmp_path_factory.mktemp("straight"))
        b = str(tmp_path_factory.mktemp("resumed"))
        straight = _train(files, a, 4, 2)
        first = _train(files, b, 2, 0)
        resumed = _train(files, b, 4, 3)
    finally:
        torch.use_deterministic_algorithms(was)
    return {"straight": straight, "first": first, "resumed": resumed,
            "dirs": (a, b)}


def test_four_groups_train_from_files(runs):
    trainer, state, rows = runs["straight"]
    assert state.step == 4 and [r["step"] for r in rows] == [1, 2, 3, 4]
    groups = [h["group"] for h in trainer.history]
    assert set(groups) == GROUPS, groups
    keys = {"gdino": "det_loss", "unipose": "pose_loss",
            "sd": "image_loss", "ip2p": "image_loss"}
    for g, row in zip(groups, rows):
        assert keys[g] in row and "grad_norm" in row, (g, sorted(row))
        assert all(np.isfinite(v) for v in row.values()), row
    pose_row = rows[groups.index("unipose")]
    assert "loss_oks" in pose_row and "dn_loss_class_l2" in pose_row
    ck = tckpt.restore_checkpoint(os.path.join(runs["dirs"][0],
                                               "checkpoints"))
    assert ck["step"] == 4 and ck["position"] == 4
    # every tool's trained parameters moved; the frozen ones did not
    model = trainer.model
    fresh = build_model(_cfg(), device="cpu", dtype=torch.float32,
                        seed=SEED)
    before = dict(fresh.named_parameters())
    moved = {n.split(".")[0] for n, p in model.named_parameters()
             if n in state.masters and not torch.equal(p, before[n])}
    assert {"gdino", "unipose", "sd", "ip2p", "core"} <= moved
    for n, p in model.named_parameters():
        if n not in state.masters:
            assert n.startswith(("core.vis_encoder", "core.llm", "sd.unet",
                                 "sd.vae", "ip2p.vae")) \
                or ".backbone." in n, n
            assert torch.equal(p, before[n]), n


def test_two_plus_resume_plus_two_equals_four_bitwise_across_groups(runs):
    strainer, straight, srows = runs["straight"]
    _, first, _ = runs["first"]
    trainer, resumed, rrows = runs["resumed"]
    assert first.step == 2 and resumed.step == 4
    assert [h["position"] for h in trainer.history] == [2, 3]
    assert [h["group"] for h in trainer.history] == \
        [h["group"] for h in strainer.history][2:]
    for r, s in zip(rrows, srows):
        assert {k: v for k, v in r.items() if k != "time"} == \
            {k: v for k, v in s.items() if k != "time"}
    for n, w in straight.masters.items():
        assert torch.equal(resumed.masters[n], w), n
        assert torch.equal(resumed.mu[n], straight.mu[n]), n
        assert torch.equal(resumed.nu[n], straight.nu[n]), n
    params = dict(resumed.model.named_parameters())
    for n, p in straight.model.named_parameters():
        assert torch.equal(params[n], p), n
