"""Command-line entry points (counterpart of `visionllm_tpu/cli.py`, the
reference's scripts/ layer), with the same subcommands and flags:

  python -m visionllm_tpu_torch.cli eval-det   --ann ... --imgs ... [--ckpt x.npz]
  python -m visionllm_tpu_torch.cli eval-pose  --ann ... --imgs ...
  python -m visionllm_tpu_torch.cli eval-grd   --ann ... --imgs ...
  python -m visionllm_tpu_torch.cli eval-semseg --config cfg.py
  python -m visionllm_tpu_torch.cli eval-interactive --ann ... --imgs ...
  python -m visionllm_tpu_torch.cli eval-region --task region-caption --ann ...
  python -m visionllm_tpu_torch.cli eval-vqa   --benchmark pope --data ...
  python -m visionllm_tpu_torch.cli serve      --port 8000 [--slots 8]
  python -m visionllm_tpu_torch.cli train      --data datasets.json

The model is `vllm_7b_config()`, or `tiny_test_config` with the region
encoder on under `--tiny`, or the JSON of `--model-config`
(`VisionLLMConfig.from_dict`; a JSON of either package). `--ckpt` reads
an npz of the JAX package's param layout (`utils/checkpoint.py:
load_params_npz`, keys "core/llm/...") into the port's modules
(`utils/convert.py:load_jax_params`); without it the model keeps its
seeded random weights (seed 0). `--quant` / `--kv-quant` quantize the
LLM after loading, as the JAX CLI does.

Differences from the JAX CLI (`ROADMAP.md` §C.3):

- `--device`: the model runs on CUDA unless the caller names another
  device (`cpu`); with no card and no `--device` it raises, as every
  entry point of the port does (`device.resolve_device`);
- `--tiny` builds the models in fp32 (the JAX CLI builds the tiny
  composite in bf16, the tiny generate core in fp32), other runs in bf16;
- `--tokenizer` needs `transformers`, which the port does not use: it
  exits with a message, and every command uses the word-level
  `SimpleTokenizer` with `SpecialTokenIds.synthetic()`, as the JAX CLI
  uses its `MockTokenizer` without `--tokenizer`;
- `--distributed` joins the processes through
  `parallel.mesh.init_process_group_for` (NCCL on `cuda:{LOCAL_RANK}`
  unless `--device` names another device; gloo on the CPU) where the JAX
  CLI calls `jax.distributed.initialize`, from `--coordinator /
  --num-processes / --process-id` or a scheduler's environment
  (`dist_kwargs_from_env`); every process then runs the command whole, as
  the JAX CLI's do: `train` lays the Trainer's mesh over the processes
  (`train/runner.py`), and rank 0 writes the one-process checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Mapping, Optional

import torch

from visionllm_tpu_torch.config import (VisionLLMConfig, tiny_test_config,
                                        vllm_7b_config)
from visionllm_tpu_torch.device import resolve_device

EVAL_DATASETS = {"eval-det": "coco_det", "eval-grd": "refcoco_grd",
                 "eval-pose": "coco_pose", "eval-semseg": "semseg",
                 "eval-interactive": "coco_interactive"}
TOKENIZER_REFUSAL = (
    "--tokenizer needs the `transformers` package, which the port does "
    "not use; leave it out to run with the built-in SimpleTokenizer")


# ---------------------------------------------------------------- models

def model_config(args) -> VisionLLMConfig:
    """The run's config: `--model-config`, else `tiny_test_config` with
    the region encoder (`--tiny`), else `vllm_7b_config()`; `--quant`
    and `--kv-quant` set on the LLM."""
    if getattr(args, "model_config", None):
        with open(args.model_config) as f:
            cfg = VisionLLMConfig.from_dict(json.load(f))
    elif args.tiny:
        cfg = tiny_test_config(use_region_encoder=True)
    else:
        cfg = vllm_7b_config()
    quant = getattr(args, "quant", "")
    kv_quant = getattr(args, "kv_quant", "")
    if quant or kv_quant:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, quant=quant, kv_quant=kv_quant))
    return cfg


def _dtype(args) -> torch.dtype:
    return torch.float32 if args.tiny else torch.bfloat16


def _dense(cfg: VisionLLMConfig) -> VisionLLMConfig:
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                            quant=""))


def _quantize(module: torch.nn.Module, cfg: VisionLLMConfig) -> None:
    from visionllm_tpu_torch.ops.quant import quantize_serving_params
    if cfg.llm.quant:
        quantize_serving_params(module, bits=4 if cfg.llm.quant == "int4"
                                else 8, act=cfg.llm.quant == "w8a8")


def load_params(path: Optional[str]) -> Optional[Dict[str, Any]]:
    from visionllm_tpu_torch.utils.checkpoint import load_params_npz
    return load_params_npz(path) if path else None


def load_composite_params(model: torch.nn.Module,
                          params: Mapping[str, Any]) -> None:
    """Each top-level subtree of a composite's flax params ("core",
    "gdino", ...) into the module of that name, every leaf matched
    (`load_jax_params`); a subtree with no such module raises `KeyError`.
    A tool of the model that the tree lacks keeps its seeded weights, and
    is named on stderr."""
    from visionllm_tpu_torch.utils.convert import load_jax_params
    if "core" not in params:
        raise KeyError("the checkpoint has no 'core' subtree; its top "
                       f"level holds {sorted(params)}")
    for name, sub in params.items():
        mod = getattr(model, name, None)
        if not isinstance(mod, torch.nn.Module):
            raise KeyError(f"the checkpoint's subtree {name!r} has no "
                           "module in this model")
        load_jax_params(mod, sub)
    kept = [n for n, m in model.named_children() if n not in params]
    if kept:
        print(f"checkpoint: {kept} keep their seeded weights",
              file=sys.stderr)


def build_composite(args, cfg: VisionLLMConfig, device: torch.device,
                    params: Optional[Mapping[str, Any]] = None):
    """`build_model` of `cfg` on `device`, the checkpoint's params loaded,
    then the LLM quantized under `--quant`."""
    from visionllm_tpu_torch.models.composite import build_model
    model = build_model(_dense(cfg), device=device, dtype=_dtype(args))
    if params is not None:
        load_composite_params(model, params)
    _quantize(model, cfg)
    model.cfg = model.core.cfg = cfg
    model.core.llm.cfg = cfg.llm
    return model


def build_core_from(args, cfg: VisionLLMConfig, device: torch.device,
                    params: Optional[Mapping[str, Any]] = None):
    """`build_core` of `cfg` on `device` with a checkpoint's core params
    (its "core" subtree, or the whole tree of a core's checkpoint), then
    the LLM quantized under `--quant`."""
    from visionllm_tpu_torch.models.composite import build_core
    from visionllm_tpu_torch.utils.convert import load_jax_params
    core = build_core(_dense(cfg), device=device, dtype=_dtype(args))
    if params is not None:
        load_jax_params(core, params["core"] if "core" in params
                        else params)
    _quantize(core, cfg)
    core.cfg, core.llm.cfg = cfg, cfg.llm
    return core


def tokenizer_and_ids(args):
    """(`SimpleTokenizer`, `SpecialTokenIds.synthetic()`); `--tokenizer`
    exits with `TOKENIZER_REFUSAL`."""
    from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
    from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer
    if getattr(args, "tokenizer", None):
        raise SystemExit(TOKENIZER_REFUSAL)
    return SimpleTokenizer(), SpecialTokenIds.synthetic()


# ---------------------------------------------------------------- flags

def _model_flags(sub) -> None:
    sub.add_argument("--ckpt", default=None,
                     help="npz of the JAX package's param layout")
    sub.add_argument("--model-config", default=None)
    sub.add_argument("--tokenizer", default=None,
                     help="refused: it needs `transformers`")
    sub.add_argument("--tiny", action="store_true")
    sub.add_argument("--device", default=None,
                     help="cuda (the default) or cpu")
    sub.add_argument("--quant", default="", choices=["", "int8", "w8a8", "int4"],
                     help="serving-only weight quantization of the LLM "
                          "products (ops/quant.py, ops/quant4.py)")
    sub.add_argument("--kv-quant", default="", choices=["", "int8"],
                     help="serving-only int8 KV-cache storage")


def _common(sub) -> None:
    sub.add_argument("--ann", default=None)
    sub.add_argument("--imgs", default=None)
    sub.add_argument("--config", default=None,
                     help="eval config (path or shipped key like "
                          "'det/coco_val'); overrides --ann/--imgs")
    sub.add_argument("--limit", type=int, default=None)
    _model_flags(sub)
    _dist_flags(sub)


def _dist_flags(p) -> None:
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run: join the processes' group "
                        "(torchrun, slurm or OpenMPI environment, or the "
                        "three flags below)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _dataset_cfgs(args, default_type: str):
    """--config (declarative, possibly several datasets) or --ann/--imgs
    (one dataset)."""
    if args.config:
        from visionllm_tpu_torch.eval.configs import load_eval_config
        return load_eval_config(args.config)
    if not (args.ann and args.imgs):
        raise SystemExit("need --config or both --ann and --imgs")
    return [{"type": default_type, "ann_file": args.ann,
             "img_prefix": args.imgs, "test_mode": True}]


# ---------------------------------------------------------------- distributed

def _slurm_head_node(node_list: str) -> str:
    """First hostname of a slurm node list: `scontrol show hostname` when
    it runs, else the compressed form parsed ("host-[3-5,9],other-1" ->
    "host-3")."""
    import subprocess
    try:
        out = subprocess.run(
            ["scontrol", "show", "hostname", node_list],
            capture_output=True, text=True, timeout=10)
        first = out.stdout.split()
        if out.returncode == 0 and first:
            return first[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    head = node_list.split(",")[0]
    if "[" in head:
        prefix, rng = head.split("[", 1)
        return prefix + rng.rstrip("]").split(",")[0].split("-")[0]
    return head


def dist_kwargs_from_env(environ) -> dict:
    """The process group's coordinator, size and rank from a scheduler's
    environment (the reference's dist_utils.py:33-104): slurm
    (SLURM_PROCID / SLURM_NTASKS / SLURM_NODELIST, the coordinator the
    list's first node unless MASTER_ADDR is set), OpenMPI
    (OMPI_COMM_WORLD_RANK / _SIZE and MASTER_ADDR) or torchrun's env://
    (RANK / WORLD_SIZE / MASTER_ADDR); the port from MASTER_PORT, else
    29500. {} when no scheduler's variables are set."""
    port = environ.get("MASTER_PORT", "29500")
    if "SLURM_PROCID" in environ and "SLURM_NTASKS" in environ:
        addr = environ.get("MASTER_ADDR") or _slurm_head_node(
            environ["SLURM_NODELIST"])
        return dict(coordinator_address=f"{addr}:{port}",
                    num_processes=int(environ["SLURM_NTASKS"]),
                    process_id=int(environ["SLURM_PROCID"]))
    if "OMPI_COMM_WORLD_RANK" in environ:
        if "MASTER_ADDR" not in environ:
            raise KeyError(
                "MPI launch: the environment variable MASTER_ADDR "
                "is not set")
        return dict(
            coordinator_address=f"{environ['MASTER_ADDR']}:{port}",
            num_processes=int(environ["OMPI_COMM_WORLD_SIZE"]),
            process_id=int(environ["OMPI_COMM_WORLD_RANK"]))
    if "RANK" in environ and "WORLD_SIZE" in environ \
            and "MASTER_ADDR" in environ:
        return dict(
            coordinator_address=f"{environ['MASTER_ADDR']}:{port}",
            num_processes=int(environ["WORLD_SIZE"]),
            process_id=int(environ["RANK"]))
    return {}


def _maybe_init_distributed(args) -> None:
    """Join the process group of a `--distributed` run: the coordinator,
    size and rank from the three flags or from the scheduler's
    environment; the device `cuda:{LOCAL_RANK}` unless `--device` names
    another (which then also picks the backend)."""
    if not getattr(args, "distributed", False):
        return
    import os

    from visionllm_tpu_torch.parallel.mesh import init_process_group_for
    if args.coordinator:
        kw = dict(coordinator_address=args.coordinator,
                  num_processes=args.num_processes,
                  process_id=args.process_id)
        if None in kw.values():
            raise SystemExit("--coordinator needs --num-processes and "
                             "--process-id")
    else:
        kw = dist_kwargs_from_env(os.environ)
        if not kw:
            raise SystemExit(
                "--distributed needs --coordinator / --num-processes / "
                "--process-id or a launcher's environment (torchrun's "
                "RANK / WORLD_SIZE / MASTER_ADDR, slurm or OpenMPI)")
    if args.device is None:
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    init_process_group_for(args.device,
                           init_method=kw["coordinator_address"],
                           world_size=kw["num_processes"],
                           rank=kw["process_id"])


# ---------------------------------------------------------------- parser

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("visionllm_tpu_torch")
    subs = parser.add_subparsers(dest="cmd", required=True)
    det = subs.add_parser("eval-det")
    _common(det)
    det.add_argument("--with-mask", action="store_true")
    for name in ("eval-pose", "eval-grd", "eval-semseg",
                 "eval-interactive"):
        _common(subs.add_parser(name))
    reg = subs.add_parser(
        "eval-region", help="region-prompted generation evals "
        "(caption / recognition / classification / vcr)")
    reg.add_argument("--task", required=True,
                     choices=("region-caption", "region-recognition",
                              "region-classification", "vcr"))
    reg.add_argument("--ann", required=True)
    reg.add_argument("--imgs", default="")
    reg.add_argument("--vocab", default="coco",
                     help="recognition vocabulary tag (coco|lvis)")
    reg.add_argument("--test-format", default="bbox",
                     choices=("bbox", "mask"))
    reg.add_argument("--limit", type=int, default=None)
    reg.add_argument("--max-new-tokens", type=int, default=None)
    _model_flags(reg)
    vqa = subs.add_parser(
        "eval-vqa", help="VQA benchmark runners (MME / POPE / MMBench / "
        "SEED / ScienceQA / MM-Vet / caption / jsonl suites)")
    vqa.add_argument("--benchmark", required=True)
    vqa.add_argument("--data", required=True,
                     help="benchmark file: MME root dir / POPE-SEED-"
                          "ScienceQA jsonl / MMBench tsv / MM-Vet json /"
                          " VQA-suite jsonl")
    vqa.add_argument("--imgs", default="",
                     help="image prefix (jsonl suites) or MME image root")
    vqa.add_argument("--limit", type=int, default=None)
    vqa.add_argument("--max-new-tokens", type=int, default=None)
    vqa.add_argument("--gen-batch", type=int, default=1,
                     help="B prompts left-padded into one batched "
                          "decode (token-identical to B1)")
    _model_flags(vqa)
    sv = subs.add_parser(
        "serve", help="HTTP serving front end (POST /v1/generate)")
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--max-new-tokens", type=int, default=256)
    sv.add_argument("--max-prompt", type=int, default=1024)
    sv.add_argument("--conv", default="vicuna_v1")
    sv.add_argument("--max-batch", type=int, default=1,
                    help="micro-batch size: concurrent requests coalesce "
                         "into one batched decode")
    sv.add_argument("--batch-window-ms", type=float, default=4.0,
                    help="how long a non-full batch waits for company")
    sv.add_argument("--slots", type=int, default=0,
                    help="continuous batching: N decode slots (replaces "
                         "--max-batch/--spec-k)")
    sv.add_argument("--decode-span", type=int, default=1,
                    help="with --slots: tokens generated a device call")
    sv.add_argument("--prefill-chunk", type=int, default=0,
                    help="with --slots: admit prompts in C-token chunks")
    sv.add_argument("--max-queue", type=int, default=256,
                    help="waiting-request bound; beyond it HTTP 503")
    sv.add_argument("--sessions", type=int, default=0,
                    help="with --slots: park up to M finished sessions' "
                         "KV for follow-up turns")
    sv.add_argument("--session-chunk", type=int, default=64,
                    help="token window width for session extension")
    sv.add_argument("--max-ctx", type=int, default=None,
                    help="override the per-slot KV buffer length")
    sv.add_argument("--max-regions", type=int, default=8,
                    help="max visual-prompt regions a request")
    sv.add_argument("--perception", action="store_true",
                    help="also serve POST /v1/detect, /v1/ground and "
                         "/v1/pose through infer.Predictor")
    sv.add_argument("--sampling", action="store_true",
                    help="requests may pass temperature / top_p / seed")
    sv.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding draft length (B1)")
    _model_flags(sv)
    tr = subs.add_parser("train")
    tr.add_argument("--model-config", default=None)
    tr.add_argument("--data", required=True,
                    help="json list of dataset configs")
    tr.add_argument("--tokenizer", default=None,
                    help="refused: it needs `transformers`")
    tr.add_argument("--output", default="output")
    tr.add_argument("--batch-size", type=int, default=8)
    tr.add_argument("--steps", type=int, default=1000)
    tr.add_argument("--num-workers", type=int, default=2,
                    help="prefetch loader threads (0 = synchronous)")
    tr.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches accumulated an optimizer step; "
                         "--steps counts micro-batches")
    tr.add_argument("--remat", default="", choices=["", "dots", "full"],
                    help="rematerialize LLM decoder layers in the "
                         "backward pass")
    tr.add_argument("--tiny", action="store_true")
    tr.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    _dist_flags(tr)
    return parser


# ---------------------------------------------------------------- commands

def _eval_datasets(args, cfg, tok):
    from visionllm_tpu_torch.data.build import build_dataset
    for ds_cfg in _dataset_cfgs(args, EVAL_DATASETS[args.cmd]):
        ds_cfg = dict(ds_cfg)
        ds_cfg.setdefault("image_size", cfg.vis_encoder.image_size)
        ds_cfg.setdefault("image_token_len", cfg.image_token_len)
        if args.cmd == "eval-det":
            ds_cfg.setdefault("with_mask", args.with_mask)
        yield (ds_cfg.get("ann_file", ds_cfg["type"]),
               ds_cfg.get("with_mask", False), build_dataset(ds_cfg, tok))


def run_eval(args) -> Dict[str, Any]:
    """eval-det / -grd / -pose / -semseg / -interactive: the metrics of
    each dataset of the run, by its annotation file (one dataset: its
    metrics alone). Prints {"timings": {"build_s", "eval_s"}} on stderr:
    the model's build and the evaluation's seconds."""
    import visionllm_tpu_torch.data  # noqa: F401  (registers the types)
    cfg = model_config(args)
    tok, tid = tokenizer_and_ids(args)
    t = time.perf_counter()
    model = build_composite(args, cfg, resolve_device(args.device),
                            load_params(args.ckpt))
    timings = {"build_s": time.perf_counter() - t}
    t = time.perf_counter()
    results = {}
    for name, with_mask, ds in _eval_datasets(args, cfg, tok):
        if args.cmd == "eval-det":
            from visionllm_tpu_torch.eval.eval_det import evaluate_det
            results[name] = evaluate_det(model, ds, tid, limit=args.limit,
                                         with_mask=with_mask)
        elif args.cmd == "eval-grd":
            from visionllm_tpu_torch.eval.eval_grd import evaluate_grd
            results[name] = evaluate_grd(model, ds, tid, limit=args.limit)
        elif args.cmd == "eval-semseg":
            from visionllm_tpu_torch.eval.eval_semseg import evaluate_semseg
            results[name] = evaluate_semseg(model, ds, tid,
                                            limit=args.limit)
        elif args.cmd == "eval-interactive":
            from visionllm_tpu_torch.eval.eval_interactive import \
                evaluate_interactive
            results[name] = evaluate_interactive(model, ds, tid,
                                                 limit=args.limit)
        else:
            from visionllm_tpu_torch.eval.eval_pose import evaluate_pose
            results[name] = evaluate_pose(model, ds, tid, limit=args.limit)
    timings["eval_s"] = time.perf_counter() - t
    print(json.dumps({"timings": timings}), file=sys.stderr)
    return results[name] if len(results) == 1 else results


def _generate_fn(args, cfg, tid, tok, max_new_tokens):
    from visionllm_tpu_torch.generation import build_generate_fn
    core = build_core_from(args, cfg, resolve_device(args.device),
                           load_params(args.ckpt))
    return build_generate_fn(core, tid, max_new_tokens=max_new_tokens,
                             eos_id=tok.eos_token_id)


def run_eval_vqa(args, parser) -> Dict[str, Any]:
    from visionllm_tpu_torch.eval import runners as R
    cfg = model_config(args)
    tok, tid = tokenizer_and_ids(args)
    bench = args.benchmark
    loaders = {
        "mme": lambda: R.load_mme(args.data, args.imgs or None,
                                  limit=args.limit),
        "pope": lambda: R.load_pope(args.data, args.imgs, limit=args.limit),
        "mmbench": lambda: R.load_mmbench(args.data, limit=args.limit),
        "seed": lambda: R.load_seed(args.data, args.imgs, limit=args.limit),
        "scienceqa": lambda: R.load_scienceqa(args.data, args.imgs,
                                              limit=args.limit),
        "mmvet": lambda: R.load_mmvet(args.data, args.imgs,
                                      limit=args.limit),
        "caption": lambda: R.load_caption(args.data, args.imgs,
                                          limit=args.limit)}
    if bench in loaders:
        rows = loaders[bench]()
    elif bench in R.VQA_SUITES:
        rows = R.load_vqa_jsonl(args.data, args.imgs, limit=args.limit)
    else:
        parser.error(f"unknown benchmark {bench} (known: mme, pope, "
                     f"mmbench, seed, scienceqa, mmvet, caption, "
                     f"{', '.join(R.VQA_SUITES)})")
    max_new = (args.max_new_tokens
               or (30 if bench == "caption" else None)
               or R.VQA_SUITES.get(bench, {}).get("max_new_tokens", 32))
    gen = _generate_fn(args, cfg, tid, tok, max_new)
    return R.run_benchmark(bench, gen, tok, rows,
                           image_token_len=cfg.image_token_len,
                           image_size=cfg.vis_encoder.image_size,
                           batch_size=args.gen_batch,
                           device=resolve_device(args.device))


def run_eval_region(args) -> Dict[str, Any]:
    from visionllm_tpu_torch.eval import region_eval as RE
    cfg = model_config(args)
    tok, tid = tokenizer_and_ids(args)
    loader, _, default_max_new = RE.TASKS[args.task]
    kwargs: Dict[str, Any] = {"limit": args.limit}
    if args.task == "region-recognition":
        kwargs["vocab"] = args.vocab
    if args.task != "vcr":
        kwargs["test_format"] = args.test_format
    rows = loader(args.ann, args.imgs, **kwargs)
    gen = _generate_fn(args, cfg, tid, tok,
                       args.max_new_tokens or default_max_new)
    res = RE.run_region_eval(args.task, gen, cfg, tok, rows,
                             device=resolve_device(args.device))
    res.pop("predictions", None)
    return res


def make_service(args):
    """The `serve` command's (server, service): a `ChatService` of the
    flags behind `make_server`, and with `--perception` a `Predictor` on
    the same model (one set of weights)."""
    from visionllm_tpu_torch.infer import Predictor
    from visionllm_tpu_torch.serve import ChatService, make_server
    cfg = model_config(args)
    tok, _ = tokenizer_and_ids(args)
    device = resolve_device(args.device)
    params = load_params(args.ckpt)
    predictor = None
    if args.perception:
        model = build_composite(args, cfg, device, params)
        core = model.core
        predictor = Predictor(cfg, model, tok, device=device)
    else:
        core = build_core_from(args, cfg, device, params)
    svc = ChatService(
        cfg, core, tok, conv_version=args.conv,
        max_new_tokens=args.max_new_tokens, max_prompt=args.max_prompt,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        spec_k=args.spec_k, slots=args.slots,
        prefill_chunk=args.prefill_chunk, decode_span=args.decode_span,
        sampling=args.sampling, max_queue=args.max_queue,
        sessions=args.sessions, session_chunk=args.session_chunk,
        max_ctx=args.max_ctx, max_regions=args.max_regions, device=device)
    return make_server(svc, args.host, args.port,
                       predictor=predictor), svc


def run_train(args) -> None:
    from visionllm_tpu_torch.config import OptimizerConfig
    from visionllm_tpu_torch.train.runner import TrainConfig, Trainer
    cfg = model_config(args)
    if args.remat:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, remat=args.remat))
    with open(args.data) as f:
        ds_cfgs = json.load(f)
    tok, tid = tokenizer_and_ids(args)
    tc = TrainConfig(output_dir=args.output, batch_size=args.batch_size,
                     total_steps=args.steps, num_workers=args.num_workers,
                     optimizer=OptimizerConfig(
                         grad_accum_steps=args.grad_accum))
    Trainer(cfg, tc, tid, device=args.device,
            dtype=_dtype(args)).train(ds_cfgs, tok)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    _maybe_init_distributed(args)
    try:
        _run(args, parser)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run(args, parser) -> None:
    if args.cmd in EVAL_DATASETS:
        print(json.dumps(run_eval(args)))
    elif args.cmd == "eval-vqa":
        print(json.dumps(run_eval_vqa(args, parser)))
    elif args.cmd == "eval-region":
        print(json.dumps(run_eval_region(args)))
    elif args.cmd == "serve":
        srv, svc = make_service(args)
        print(f"serving on http://{args.host}:{srv.server_address[1]}",
              flush=True)
        try:
            srv.serve_forever()
        finally:
            srv.server_close()
            svc.close()
    else:
        run_train(args)


if __name__ == "__main__":
    main()
