"""Training entry point: config -> datasets -> prefetch loader -> train
steps -> metrics and checkpoints (counterpart of
`visionllm_tpu/train/runner.py`, after the reference's train.py:271-709
and VisionLLMv2Trainer).

`Trainer(model_cfg, tc, tid).train(dataset_cfgs, tokenizer)` builds the
datasets of `dataset_cfgs`, draws task-grouped batches
(`TaskGroupedBatchSampler`: a batch never mixes tool groups), builds them
on `tc.num_workers` threads (`PrefetchLoader`, `collate`), and runs the
group's train step on the card (the CPU when `device="cpu"`), logging
`metrics.jsonl` and saving a checkpoint every `save_every` steps and at
the end.

Every tool group is ported: `vlm` (chat, VQA, caption and region
tasks) through `make_chat_train_step`, `gdino` (det, grd and seg)
through `make_det_train_step`, `unipose` (pose) through
`make_pose_train_step` (with `tc.num_obj_patches`), `sd` ([GEN]) and
`ip2p` ([EDIT]) through `make_gen_train_step`. LoRA
(`LLMConfig.lora_r`; its factors are never frozen), rematerialization
(`LLMConfig.remat`, `GDinoConfig.remat`) and gradient accumulation
(`tc.optimizer.grad_accum_steps`) come with the configs. As in JAX,
`step` counts micro-steps: `log_every`, `save_every`, `total_steps` and
the checkpoint names count them, and a checkpoint taken mid-accumulation
holds the running mean, so a resumed run finishes the accumulation.

Resume differs from the JAX Trainer on purpose (`ROADMAP.md` §C.2): the
JAX `train()` restarts the sampler from its first batch and its PRNG from
`tc.seed` on resume, so a resumed run repeats the first batches. The port
saves the generator's state and the number of batches taken, skips those
batches on resume, and draws each sample's augmentations from
`random.Random` seeded by the sample's position in the run
(`seeded_sample`), so "2 steps, save, resume, 2 steps" equals "4 steps"
and `num_workers` changes no batch. Like the JAX loop, one pass over the
sampler ends the run, whatever `total_steps` says.

Under an initialized process group the Trainer lays a mesh over it, as
the JAX Trainer always does (`build_mesh(n_model=tc.n_model)`): the
model is sharded by `apply_shardings` (FSDP2 over "data", tensor
parallelism over "model" when `n_model > 1`; quantized or LoRA LLMs
there raise naming `ROADMAP.md` A.8.4) and each step is the one-process
step on the global batch (`train_step`'s module docstring). Every rank
builds the whole global batch, as JAX collates it before placing it,
and takes its rows (`shard_batch`): each rank so sees the collator's
padding and target count of the whole batch, and the samples are the
one-process run's. Only rank 0 writes `metrics.jsonl` and checkpoints;
a checkpoint is gathered to it and has the one-process format, and
each rank restores its parts of one, so a checkpoint crosses between a
mesh and one process both ways. With no group the Trainer is the
one-process Trainer, and `n_model > 1` raises `ValueError`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from visionllm_tpu_torch.config import OptimizerConfig, VisionLLMConfig
from visionllm_tpu_torch.data.build import (TaskGroupedBatchSampler,
                                            build_multi_datasets,
                                            group_of_task, seeded_sample)
from visionllm_tpu_torch.data.collator import collate
from visionllm_tpu_torch.data.loader import PrefetchLoader
from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.parallel.mesh import (apply_shardings, build_mesh,
                                               full_of, shard_batch)
from visionllm_tpu_torch.train.train_step import (TrainState,
                                                  build_optimizer,
                                                  make_chat_train_step,
                                                  make_det_train_step,
                                                  make_gen_train_step,
                                                  make_pose_train_step)
from visionllm_tpu_torch.utils.checkpoint import (latest_step,
                                                  restore_checkpoint,
                                                  save_checkpoint)

# tool group -> the ROADMAP item that ports its train step (all ported)
NOT_PORTED: Dict[str, str] = {}
# batch keys of the image arrays, which go to the model's dtype
IMAGE_KEYS = ("images", "images_aug", "input_images", "output_images")


@dataclasses.dataclass
class TrainConfig:
    """The JAX `TrainConfig`, field for field."""

    output_dir: str = "output"
    batch_size: int = 8
    total_steps: int = 10_000
    log_every: int = 10
    save_every: int = 1000
    seed: int = 0
    n_model: int = 1                  # TP axis size (under a group)
    num_workers: int = 2              # prefetch loader threads (0 = sync)
    num_obj_patches: int = 1          # pose obj/kpt query split
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    # freezing matrix (reference train.py:533-558; modeling_sd.py:104-106
    # freezes the SD vae/text-encoder/unet, ip2p keeps its unet trainable)
    freeze_vis_encoder: bool = True
    freeze_llm: bool = False
    freeze_backbone: bool = False
    freeze_sd_unet: bool = True


def frozen_predicate(tc: TrainConfig, model_cfg: VisionLLMConfig
                     ) -> Callable[[str], bool]:
    """path -> True where the parameter is frozen (dotted paths)."""
    def frozen(path: str) -> bool:
        if "lora_" in path:
            return False
        if tc.freeze_vis_encoder and path.startswith("core.vis_encoder"):
            return True
        if tc.freeze_llm and path.startswith("core.llm"):
            return True
        if tc.freeze_backbone and ".backbone." in path:
            return True
        if path.startswith(("sd.vae", "ip2p.vae")):
            return True
        if tc.freeze_sd_unet and path.startswith("sd.unet"):
            return True
        return False
    return frozen


class MetricLogger:
    """`metrics.jsonl` under the output directory, and a console line."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        keys = ", ".join(f"{k}={float(v):.4f}" for k, v in
                         list(metrics.items())[:6])
        print(f"step {step}: {keys}", flush=True)


def to_device(batch: Dict[str, Any], device: torch.device,
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """A collated numpy batch as tensors on `device`: integer arrays as
    int64, the image arrays in the model's `dtype`, other floats (target
    boxes and masks) in fp32, bools as bools; lists dropped."""
    def conv(key, a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.bool:
            pass
        elif not t.is_floating_point():
            t = t.long()
        elif key in IMAGE_KEYS:
            t = t.to(dtype)
        else:
            t = t.float()
        return t.to(device, non_blocking=True)

    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = conv(k, v)
        elif isinstance(v, dict):
            out[k] = {kk: conv(kk, vv) for kk, vv in v.items()}
    return out


class Trainer:
    """The training loop of one model on one device, or on a mesh over
    the initialized process group (see the module docstring).

    Args:
      model_cfg, tc, tid: the model's config, the run's, the special
        token ids.
      device: CUDA when None (raises without a card); "cpu" runs the
        plain versions (under a process group, a gloo one).
      dtype: the model's compute dtype (its fp32 masters live in the
        optimizer state).
    """

    def __init__(self, model_cfg: VisionLLMConfig, tc: TrainConfig,
                 tid: SpecialTokenIds, *,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.mesh = None
        if dist.is_initialized():
            self.mesh = build_mesh(n_model=tc.n_model)
            n_data = self.mesh["data"].size()
            if tc.batch_size % n_data:
                raise ValueError(
                    f"batch size {tc.batch_size} does not split over the "
                    f"{n_data} data ranks")
        elif tc.n_model > 1:
            raise ValueError(
                f"TrainConfig.n_model={tc.n_model} needs a process group "
                "of a multiple of that size (parallel.mesh."
                "init_process_group_for)")
        self.rank0 = not dist.is_initialized() or dist.get_rank() == 0
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.tc = tc
        self.tid = tid
        self.dtype = dtype
        self.model: Optional[torch.nn.Module] = None
        self.frozen = frozen_predicate(tc, model_cfg)
        self.logger = MetricLogger(tc.output_dir)
        self.ckpt_dir = os.path.join(tc.output_dir, "checkpoints")
        self.position = 0          # batches taken from the sampler
        # per step: batch position, tool group, seconds waited for the
        # batch, and the perf_counter time when the step returned
        self.history: List[Dict[str, float]] = []
        self._steps: Dict[str, Any] = {}

    def init_state(self) -> TrainState:
        """The model (`build_model` with seed `tc.seed`, unless
        `self.model` is set already), optimizer and state, and the step
        generator; the latest checkpoint under `output_dir` restores the
        masters, moments, step, accumulation state, generator and
        sampler position."""
        if self.model is None:
            self.model = build_model(self.cfg, device=self.device,
                                     dtype=self.dtype, seed=self.tc.seed)
        self.tx = build_optimizer(self.tc.optimizer, self.model, self.frozen)
        if self.mesh is not None:
            apply_shardings(self.model, self.mesh)
        state = TrainState.create(self.model, self.tx, self.frozen,
                                  mesh=self.mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.tc.seed)
        self.position = 0
        if latest_step(self.ckpt_dir) is not None:
            self._restore(state, restore_checkpoint(self.ckpt_dir))
            print(f"resumed from step {state.step}", flush=True)
        return state

    def save(self, state: TrainState) -> str:
        """Checkpoint the state (with the accumulation's micro-step,
        applied steps and running mean), the generator and the sampler
        position as `ckpt_dir/<step>/`. On a mesh the masters, moments
        and running mean are gathered to rank 0 one tensor at a time,
        rank 0 writes the one-process checkpoint and the others wait."""
        parts = {}
        for part in ("masters", "mu", "nu", "acc"):
            parts[part] = getattr(state, part)
            if self.mesh is not None:
                parts[part] = {n: self._gathered(t, state.params[n])
                               for n, t in parts[part].items()}
        path = os.path.join(self.ckpt_dir, str(state.step))
        if self.rank0:
            path = save_checkpoint(self.ckpt_dir, state.step, {
                "step": state.step, **parts, "mini_step": state.mini_step,
                "gradient_step": state.gradient_step,
                "generator": self.generator.get_state(),
                "position": self.position, "seed": self.tc.seed})
        if self.mesh is not None:
            dist.barrier()
        return path

    def _gathered(self, t: torch.Tensor, like: torch.Tensor
                  ) -> Optional[torch.Tensor]:
        """The whole of a state tensor whose parts the ranks hold, on the
        host of rank 0 (None on the others)."""
        full = full_of(t, like)
        return full.cpu() if self.rank0 else None

    def _restore(self, state: TrainState, ck: Dict[str, Any]) -> None:
        if ck["seed"] != self.tc.seed:
            raise ValueError(f"checkpoint of seed {ck['seed']} resumed "
                             f"with seed {self.tc.seed}")
        if set(ck["masters"]) != set(state.masters):
            raise ValueError("the checkpoint holds other trainable "
                             "parameters than this model")
        if set(ck["acc"]) != set(state.acc):
            raise ValueError("the checkpoint was taken at another "
                             "grad_accum_steps")
        state.load(ck)
        state.step = int(ck["step"])
        state.mini_step = int(ck["mini_step"])
        state.gradient_step = int(ck["gradient_step"])
        state.write_back()
        self.generator.set_state(ck["generator"])
        self.position = int(ck["position"])

    def step_fn_for(self, group: str):
        """The train step of a tool group (`data.build.TASK_GROUPS`),
        built at its first batch."""
        if group in NOT_PORTED:
            raise NotImplementedError(
                f"the {group!r} tool group's train step is not ported "
                f"(ROADMAP.md {NOT_PORTED[group]})")
        if group not in self._steps:
            args = (self.model, self.tx, self.tid)
            if group == "vlm":
                fn = make_chat_train_step(*args, self.frozen)
            elif group == "gdino":
                fn = make_det_train_step(*args, self.frozen)
            elif group == "unipose":
                fn = make_pose_train_step(*args, self.tc.num_obj_patches,
                                          self.frozen)
            else:
                fn = make_gen_train_step(*args, edit=group == "ip2p",
                                         frozen=self.frozen)
            self._steps[group] = fn
        return self._steps[group]

    def loader(self, concat, batches: Sequence[Sequence[int]],
               start: int = 0) -> PrefetchLoader:
        """The prefetch loader over `batches[start:]`: each item is
        (dataset indices, collated batch without img_metas / captions);
        the sample in slot j of batch p is seeded by (tc.seed, p, j)."""
        seed = self.tc.seed
        keyed = [[(p, j, i) for j, i in enumerate(b)]
                 for p, b in enumerate(batches)][start:]

        class _Seeded:
            def __getitem__(self, key):
                p, j, i = key
                return i, seeded_sample(concat, i, f"{seed}:{p}:{j}")

        def coll(pairs):
            batch = collate([s for _, s in pairs])
            batch.pop("img_metas", None)
            batch.pop("captions", None)
            return [i for i, _ in pairs], batch

        return PrefetchLoader(_Seeded(), keyed, coll,
                              num_workers=self.tc.num_workers)

    def train(self, dataset_cfgs: Sequence[Dict], tokenizer,
              max_steps: Optional[int] = None) -> TrainState:
        """Train until `max_steps` (or `tc.total_steps`) or the end of one
        pass over the sampler, and checkpoint the last step unless its
        `save_every` checkpoint is already written; returns the state.
        Each batch takes its tool group's step (on a mesh, on this rank's
        rows of it). A step whose metrics (loss terms, gradient norm; the
        global batch's on a mesh, so every rank sees the same) are not
        all finite raises `FloatingPointError` before anything is logged
        or saved for it; reading them makes each step wait for the
        device."""
        tc = self.tc
        concat = build_multi_datasets(
            [{"image_token_len": self.cfg.image_token_len, **c}
             for c in dataset_cfgs], tokenizer)
        batches = list(TaskGroupedBatchSampler(concat, tc.batch_size,
                                               seed=tc.seed))
        state = self.init_state()
        limit = max_steps or tc.total_steps
        it = iter(self.loader(concat, batches, self.position))
        saved = None
        try:
            while state.step < limit:
                t0 = time.perf_counter()
                try:
                    idx, batch = next(it)
                except StopIteration:
                    break
                wait = time.perf_counter() - t0
                group = group_of_task(concat.task_of(idx[0]))
                step = self.step_fn_for(group)
                batch = to_device(batch, self.device, self.dtype)
                draws = {"generator": self.generator}
                if self.mesh is not None:
                    # the global batch's draws; the step keeps its rows
                    draws = {"noise": step.draw(self.generator, batch)}
                    batch = shard_batch(batch, self.mesh)
                state, metrics = step(state, batch, **draws)
                self.position += 1
                values = dict(zip(metrics, torch.stack(
                    [v.float() for v in metrics.values()]).tolist()))
                bad = {k: v for k, v in values.items()
                       if not math.isfinite(v)}
                if bad:
                    raise FloatingPointError(
                        f"step {state.step}: non-finite {bad}; the last "
                        f"checkpoint is that of step "
                        f"{latest_step(self.ckpt_dir)}")
                if state.step % tc.log_every == 0 and self.rank0:
                    self.logger.log(state.step, values)
                self.history.append({"position": self.position - 1,
                                     "group": group, "data_wait_s": wait,
                                     "t_end": time.perf_counter()})
                if state.step % tc.save_every == 0:
                    self.save(state)
                    saved = state.step
        finally:
            it.close()
        if saved != state.step:
            self.save(state)
        return state
