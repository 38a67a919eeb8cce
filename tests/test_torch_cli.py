"""The port's command line (`python -m visionllm_tpu_torch.cli`) against
the JAX package's `visionllm_tpu.cli` on the CPU.

* `eval-det` (with masks), `eval-semseg` (a config file that gives
  `class_names`), `eval-interactive` and `eval-region` with `--tiny` on
  one npz checkpoint of the JAX layout (the tiny composite's core with
  its region encoder, gdino and unipose, `random_flax_params`): the port
  with `--device cpu` prints JAX's metrics (within 1e-6; the region eval
  identical). The JAX CLI builds its tiny composite in bf16; here it is
  held in fp32, as the port builds `--tiny` models (`ROADMAP.md` §C.3),
  and its device functions compile at XLA optimization level 0.
* Every subcommand takes JAX's flags, and `--device` besides.
* `dist_kwargs_from_env` on the slurm, MPI and torchrun cases of
  `tests/test_cli_eval.py`; `--distributed`, `--tokenizer` and a run
  without a card or `--device` refused.
* `eval-vqa` (caption) prints JAX's metrics on the same checkpoint;
  `serve` answers on a port; `train` hands `Trainer` its flags.
* `VisionLLMConfig.to_json` / `from_json` across the two packages.
"""

import contextlib
import dataclasses
import json
import re

import numpy as np
import pytest
import torch
from unittest import mock

import jax.numpy as jnp

from tests.test_torch_coco_data import BUCKETS, TEST_SCALE, write_coco
from tests.test_torch_data_variants import ADE_CLASSES, _seg_label
from tests.test_torch_evalx import o0, tiny_composite, write_region_files
from visionllm_tpu import cli as jcli
from visionllm_tpu import config as jconfig
from visionllm_tpu.eval import eval_det as jeval_det
from visionllm_tpu.eval import eval_interactive as jeval_inter
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.utils.checkpoint import save_params_npz
from visionllm_tpu_torch import cli as tcli
from visionllm_tpu_torch import config as tconfig

METRIC_TOL = 1e-6


@pytest.fixture(scope="module")
def cli_set(tmp_path_factory):
    """An npz checkpoint of the tiny composite, a COCO set with semseg
    labels and region files, and one eval config a command (the tiny
    test scale and bucket; the semseg one with `class_names`)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("cli")
    _, params = tiny_composite()
    save_params_npz(str(root / "tiny.npz"), params)
    ann = write_coco(root, seed=41)
    with open(ann) as f:
        images = json.load(f)["images"]
    rng = np.random.default_rng(42)
    rows = []
    for i, im in enumerate(images[:2]):
        Image.fromarray(_seg_label(rng, im["height"], im["width"],
                                   len(ADE_CLASSES))).save(
            root / f"label{i}.png")
        rows.append({"image": im["file_name"], "label": f"label{i}.png"})
    with open(root / "semseg.json", "w") as f:
        json.dump(rows, f)
    common = {"img_prefix": str(root), "test_mode": True,
              "test_scale": TEST_SCALE, "buckets": BUCKETS}
    configs = {
        "eval-det": {"type": "coco_det", "ann_file": ann, **common},
        "eval-semseg": {"type": "semseg", "ann_file": str(root /
                                                         "semseg.json"),
                        "class_names": ADE_CLASSES, **common},
        "eval-interactive": {"type": "coco_interactive", "ann_file": ann,
                             "max_regions": 4, **common}}
    paths = {}
    for cmd, ds in configs.items():
        paths[cmd] = root / f"{cmd}.py"
        paths[cmd].write_text(f"datasets = [{ds!r}]\n")
    return {"root": root, "npz": str(root / "tiny.npz"), "configs": paths,
            "region": write_region_files(root, ann)}


def _f32_model(cfg, dtype=None):
    return JaxModel(cfg, dtype=jnp.float32, tool_dtype=jnp.float32)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_both(capsys, argv):
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch(
            "visionllm_tpu.models.composite.VisionLLMWithTools", _f32_model))
        stack.enter_context(mock.patch.object(
            jeval_det, "make_det_infer_fn", o0(jeval_det.make_det_infer_fn)))
        stack.enter_context(mock.patch.object(
            jeval_inter, "make_interactive_infer_fn",
            o0(jeval_inter.make_interactive_infer_fn)))
        jcli.main(argv)
    want = _last_json(capsys)
    torch.set_num_threads(1)
    tcli.main(argv + ["--device", "cpu"])
    return _last_json(capsys), want


@pytest.mark.parametrize("cmd", ["eval-det", "eval-semseg",
                                 "eval-interactive"])
def test_cli_eval_prints_jax_metrics(cli_set, capsys, cmd):
    argv = [cmd, "--tiny", "--ckpt", cli_set["npz"], "--config",
            str(cli_set["configs"][cmd]), "--limit", "3"]
    if cmd == "eval-det":
        argv.append("--with-mask")
    got, want = _run_both(capsys, argv)
    assert set(got) == set(want) and want
    for key, w in want.items():
        assert (np.isnan(w) and np.isnan(got[key])) or \
            abs(got[key] - w) <= METRIC_TOL, (key, got, want)


def test_cli_eval_region_prints_jax_metrics(cli_set, capsys):
    argv = ["eval-region", "--task", "region-classification", "--tiny",
            "--ckpt", cli_set["npz"], "--ann",
            cli_set["region"]["classification"], "--imgs",
            str(cli_set["root"]), "--max-new-tokens", "3", "--limit", "2"]
    got, want = _run_both(capsys, argv)
    assert got == want
    assert set(got) == {"semantic_similarity", "semantic_iou"}


def test_cli_eval_vqa_prints_jax_metrics(cli_set, capsys):
    """`eval-vqa --benchmark caption` (the JAX CLI test's command) on the
    checkpoint's core: the same CIDEr and BLEU-4."""
    cap = cli_set["root"] / "cap.json"
    cap.write_text(json.dumps([
        {"image": "img0.png", "caption": ["a test image"]},
        {"image": "img1.png", "caption": ["another test image"]}]))
    argv = ["eval-vqa", "--benchmark", "caption", "--tiny", "--ckpt",
            cli_set["npz"], "--data", str(cap), "--imgs",
            str(cli_set["root"]), "--max-new-tokens", "4"]
    got, want = _run_both(capsys, argv)
    assert got == want and set(got) == {"CIDEr", "Bleu_4"}


def test_cli_serve_answers_on_the_port(cli_set):
    """`serve` builds the service of its flags (here with the perception
    endpoints) behind `make_server`: /healthz answers on 127.0.0.1."""
    import threading
    import urllib.request
    args = tcli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--perception", "--max-new-tokens", "4",
         "--ckpt", cli_set["npz"]])
    srv, svc = tcli.make_service(args)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
        assert svc.core.cfg == tconfig.tiny_test_config(
            use_region_encoder=True)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        th.join(10)


def test_cli_train_builds_the_trainer(tmp_path):
    """`train` hands `Trainer` the flags' config and run settings (the
    loop itself is held against JAX's by tests/test_torch_trainer.py)."""
    seen = {}

    class Recorder:
        def __init__(self, cfg, tc, tid, *, device, dtype):
            seen.update(cfg=cfg, tc=tc, device=device, dtype=dtype)

        def train(self, ds_cfgs, tok):
            seen.update(ds_cfgs=ds_cfgs)

    data = tmp_path / "data.json"
    data.write_text(json.dumps([{"type": "coco_det", "ann_file": "a.json",
                                 "img_prefix": "imgs"}]))
    with mock.patch("visionllm_tpu_torch.train.runner.Trainer", Recorder):
        tcli.main(["train", "--tiny", "--device", "cpu", "--data",
                   str(data), "--steps", "3", "--batch-size", "2",
                   "--num-workers", "0", "--grad-accum", "2", "--remat",
                   "full", "--output", str(tmp_path / "out")])
    assert seen["cfg"].llm.remat == "full" and seen["dtype"] == torch.float32
    tc = seen["tc"]
    assert (tc.total_steps, tc.batch_size, tc.num_workers,
            tc.optimizer.grad_accum_steps) == (3, 2, 0, 2)
    assert seen["device"] == "cpu" and seen["ds_cfgs"][0]["type"] == \
        "coco_det"


COMMANDS = ["eval-det", "eval-pose", "eval-grd", "eval-semseg",
            "eval-interactive", "eval-region", "eval-vqa", "serve", "train"]


def _flags(main, cmd, capsys):
    with pytest.raises(SystemExit):
        main([cmd, "--help"])
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*",
                          capsys.readouterr().out)) - {"--help"}


@pytest.mark.parametrize("cmd", COMMANDS)
def test_cli_takes_jax_flags(cmd, capsys):
    want, got = _flags(jcli.main, cmd, capsys), _flags(tcli.main, cmd,
                                                       capsys)
    assert got == want | {"--device"}, (got ^ (want | {"--device"}))


DIST_CASES = {
    "slurm_list": ({"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
                    "SLURM_NODELIST": "tpu-host-[12-15,20],aux-1"}, None),
    "slurm_port": ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2",
                    "SLURM_NODELIST": "nodeA,nodeB",
                    "MASTER_PORT": "12345"}, None),
    "slurm_addr": ({"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
                    "SLURM_NODELIST": "nodeA,nodeB",
                    "MASTER_ADDR": "10.0.0.1"}, None),
    "mpi": ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4",
             "MASTER_ADDR": "head0"}, None),
    "mpi_no_addr": ({"OMPI_COMM_WORLD_RANK": "0",
                     "OMPI_COMM_WORLD_SIZE": "2"}, KeyError),
    "torchrun": ({"RANK": "2", "WORLD_SIZE": "4", "MASTER_ADDR": "h",
                  "MASTER_PORT": "29501"}, None),
    "none": ({"PATH": "/usr/bin"}, None)}


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_dist_kwargs_from_env_matches_jax(case):
    env, err = DIST_CASES[case]
    if err is not None:
        for fn in (jcli.dist_kwargs_from_env, tcli.dist_kwargs_from_env):
            with pytest.raises(err, match="MASTER_ADDR"):
                fn(env)
        return
    assert tcli.dist_kwargs_from_env(env) == jcli.dist_kwargs_from_env(env)


def test_cli_refusals(cli_set, capsys):
    """`--tokenizer` exits with the message; without a card a run needs
    `--device`."""
    base = ["eval-det", "--tiny", "--config",
            str(cli_set["configs"]["eval-det"])]
    with pytest.raises(SystemExit, match="transformers"):
        tcli.main(base + ["--tokenizer", "some/dir", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(base)


def test_cli_distributed_two_ranks(cli_set):
    """`eval-det --distributed --device cpu` on two processes launched as
    torchrun launches them (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT):
    both join one gloo group, run the command whole and print the same
    metrics."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "visionllm_tpu_torch.cli", "eval-det",
            "--tiny", "--device", "cpu", "--distributed", "--ckpt",
            cli_set["npz"], "--config", str(cli_set["configs"]["eval-det"]),
            "--limit", "2"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=root)
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("name", ["vllm_7b_config", "vllm_26b_config",
                                  "tiny_test_config"])
def test_config_json_round_trips_across_packages(name, tmp_path):
    """A JSON written by either package loads in the other to an equal
    config: the port's fields equal, the JAX-only fields that no module
    reads (`JAX_ONLY_FIELDS`) at their defaults; `--model-config` reads
    it."""
    kw = {"use_sd": False, "use_ip2p": False, "sd": None, "ip2p": None} \
        if name == "tiny_test_config" else {}
    jcfg = getattr(jconfig, name)(**kw)
    tcfg = getattr(tconfig, name)(
        **({"use_region_encoder": True} if kw else {}))
    from_jax = tconfig.VisionLLMConfig.from_json(jcfg.to_json())
    assert from_jax == tcfg
    assert tconfig.VisionLLMConfig.from_json(tcfg.to_json()) == tcfg
    back = jconfig.VisionLLMConfig.from_json(tcfg.to_json())
    assert json.loads(back.to_json()) == json.loads(jcfg.to_json())
    path = tmp_path / "cfg.json"
    path.write_text(jcfg.to_json())
    args = tcli.build_parser().parse_args(
        ["eval-det", "--model-config", str(path), "--quant", "int8"])
    assert tcli.model_config(args) == dataclasses.replace(
        tcfg, llm=dataclasses.replace(tcfg.llm, quant="int8"))
