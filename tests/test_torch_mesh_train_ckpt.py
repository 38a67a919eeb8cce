"""Checkpoints between the Trainer on a mesh and in one process, and
`cli train --distributed` over two processes, on the CPU in fp32 (gloo
ranks through `tests/torch_dist_worker.py`).

* `Trainer.train` on a data-2 mesh over the det, pose, [GEN] and [EDIT]
  batches of `tests/test_torch_trainer_tools.py` (the LLM trained, the
  backbones frozen): 2 steps on the mesh, its gathered checkpoint resumed
  by a one-process Trainer for 2 more, and the reverse (2 one-process
  steps resumed on the mesh for 2 more), each end where 4 one-process
  steps do within 1e-5: the metrics of steps 3 and 4 and the masters and
  both moments of the step-4 checkpoint. The mesh's step-2 checkpoint
  holds the one-process one's keys, shapes and dtypes, its values within
  1e-5, and the step, position, generator and seed exactly. A mesh sums
  each gradient in another order than one process, and Adam's first
  steps (about lr * sign(g)) turn the rounding of a gradient at its
  rounding level into steps of up to lr either way: a master whose
  gradient is noise (the straight run's RMS gradient, from its second
  moment, below `NOISE` of the global one) and an element of a master
  whose RMS gradient is within `TINY` of its tensor's largest are held
  within 2 * lr a step instead (`tests/mesh_train_ref.py` does the same
  with JAX's gradients).
* Two processes of `python -m visionllm_tpu_torch.cli train --tiny
  --device cpu --distributed` (torchrun's variables) on a llava set
  write the checkpoint that one process of the same command writes:
  its keys, shapes and dtypes, its values within 1e-5.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_trainer_tools import SEED, _cfg, _ds_cfgs
from tests.test_torch_trainer_tools import files  # noqa: F401 (a fixture)
from tests.torch_dist_worker import start
from visionllm_tpu_torch import cli as tcli
from visionllm_tpu_torch import config as tconfig
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train.runner import TrainConfig, Trainer
from visionllm_tpu_torch.utils import checkpoint as tckpt
from visionllm_tpu_torch.utils.simple_tokenizer import HashedWordTokenizer

TOL = dict(rtol=1e-5, atol=1e-5)
NOISE = 1e-6
TINY = 1e-4
TC = dict(batch_size=2, total_steps=100, log_every=1, save_every=2,
          num_workers=0, freeze_llm=False, freeze_backbone=True, seed=SEED)
OPT = dict(learning_rate=1e-3, total_steps=10)


def _one_process(ds_cfgs, out, steps):
    tc = TrainConfig(output_dir=out, optimizer=tconfig.OptimizerConfig(**OPT),
                     **TC)
    Trainer(_cfg(), tc, SpecialTokenIds.synthetic(), device="cpu",
            dtype=torch.float32).train(ds_cfgs, HashedWordTokenizer(),
                                       max_steps=steps)


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


def _ckpt(out, step):
    return tckpt.restore_checkpoint(os.path.join(out, "checkpoints"), step)


def _same_layout(got, want):
    assert sorted(got) == sorted(want)
    for part in ("masters", "mu", "nu", "acc"):
        assert sorted(got[part]) == sorted(want[part]), part
        for n, w in want[part].items():
            assert got[part][n].shape == w.shape, (part, n)
            assert got[part][n].dtype == w.dtype, (part, n)


def _close_state(got, want):
    """Masters and moments within TOL; the masters of noise gradients and
    the elements of rounding-level ones within Adam's bound."""
    bound = 2.02 * OPT["learning_rate"] * int(want["gradient_step"])
    rms = {n: v.double().sqrt().numpy() for n, v in want["nu"].items()}
    total = np.sqrt(sum(np.sum(r ** 2) for r in rms.values()))
    for part in ("masters", "mu", "nu"):
        for n, w in want[part].items():
            g, w = got[part][n].numpy(), w.numpy()
            if part == "masters":
                r = rms[n]
                tiny = r <= TINY * r.max()
                if 0 < np.linalg.norm(r) <= NOISE * total:
                    tiny[...] = True
                assert np.abs(g - w)[tiny].max(initial=0) <= bound, n
                g, w = g[~tiny], w[~tiny]
            np.testing.assert_allclose(g, w, err_msg=f"{part} {n}", **TOL)


def _close_rows(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, err_msg=f"{w['step']} {k}",
                                       **TOL)


@pytest.fixture(scope="module")
def crossing(files, tmp_path_factory):  # noqa: F811
    torch.set_num_threads(1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    root, paths = files
    ds_cfgs = _ds_cfgs(root, paths, _cfg())
    d = {k: str(tmp_path_factory.mktemp(k))
         for k in ("straight", "mesh_first", "one_first", "work")}
    try:
        _one_process(ds_cfgs, d["one_first"], 2)
        torch.save({"cfg": _cfg(), "tc": TC, "opt": OPT, "ds_cfgs": ds_cfgs,
                    "runs": [(d["mesh_first"], 2), (d["one_first"], 4)]},
                   os.path.join(d["work"], "inputs.pt"))
        wait = start("trainer_runs", 2, d["work"])
        _one_process(ds_cfgs, d["straight"], 4)
        ranks = wait()
        _one_process(ds_cfgs, d["mesh_first"], 4)
    finally:
        torch.use_deterministic_algorithms(was)
    return d, ranks


def test_mesh_runs_take_the_one_process_batches(crossing):
    d, ranks = crossing
    assert ranks[0] == ranks[1]
    first, resumed = ranks[0]
    assert first["step"] == 2 and resumed["step"] == 4
    straight = _rows(d["straight"])
    assert [r["step"] for r in _rows(d["mesh_first"])] == [1, 2, 3, 4]
    # one batch of each group: the two halves of the straight run's
    groups = first["groups"] + resumed["groups"]
    assert sorted(groups) == ["gdino", "ip2p", "sd", "unipose"]
    _close_rows(_rows(d["mesh_first"])[:2], straight[:2])


def test_mesh_checkpoint_is_the_one_process_checkpoint(crossing):
    d, _ = crossing
    got, want = _ckpt(d["mesh_first"], 2), _ckpt(d["straight"], 2)
    _same_layout(got, want)
    for k in ("step", "position", "seed", "mini_step", "gradient_step"):
        assert got[k] == want[k], k
    assert torch.equal(got["generator"], want["generator"])
    _close_state(got, want)


@pytest.mark.parametrize("first", ["mesh_first", "one_first"])
def test_resume_across_mesh_and_one_process(crossing, first):
    """Mesh then one process, and one process then mesh: steps 3 and 4
    and the step-4 checkpoint are the straight run's."""
    d, _ = crossing
    _close_rows(_rows(d[first])[-2:], _rows(d["straight"])[2:])
    got, want = _ckpt(d[first], 4), _ckpt(d["straight"], 4)
    _same_layout(got, want)
    _close_state(got, want)


@pytest.fixture(scope="module")
def llava_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_llava")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (48, 56, 3), dtype=np.uint8)
                        ).save(d / f"img{i}.jpg", quality=90)
        rows.append({"image": f"img{i}.jpg", "conversations": [
            {"from": "human", "value": f"<image>\nwhat is in picture {i}?"},
            {"from": "gpt", "value": f"a noisy square number {i}"}]})
    (d / "chat.json").write_text(json.dumps(rows))
    (d / "data.json").write_text(json.dumps([{
        "type": "llava", "ann_file": str(d / "chat.json"),
        "image_folder": str(d), "image_size": 56}]))
    cfg = tconfig.tiny_test_config(use_gdino=False, gdino=None,
                                   use_unipose=False, unipose=None)
    (d / "model.json").write_text(cfg.to_json())
    return d


def _train_argv(d, out):
    # --tiny: fp32 (the model of --model-config)
    return ["train", "--tiny", "--model-config", str(d / "model.json"),
            "--device", "cpu", "--data", str(d / "data.json"), "--output",
            str(out), "--batch-size", "2", "--steps", "2", "--num-workers",
            "0"]


def test_cli_train_distributed_writes_the_one_process_checkpoint(
        llava_set, tmp_path):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "visionllm_tpu_torch.cli",
            *_train_argv(llava_set, tmp_path / "two"), "--distributed"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=root)
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        torch.set_num_threads(1)
        tcli.main(_train_argv(llava_set, tmp_path / "one"))
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    got, want = _ckpt(tmp_path / "two", 2), _ckpt(tmp_path / "one", 2)
    _same_layout(got, want)
    assert got["position"] == want["position"] == 2
    _close_state(got, want)
    # rank 0 alone logged and wrote
    assert sorted(os.listdir(tmp_path / "two" / "checkpoints")) == ["2"]
