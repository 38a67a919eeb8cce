"""Optimizer and the train steps of the chat, det, pose, [GEN] and [EDIT]
tool groups (counterpart of `visionllm_tpu/train/train_step.py`:
`build_optimizer`, `split_frozen`, `TrainState`, `make_chat_train_step`,
`make_det_train_step`, `make_pose_train_step`, `make_gen_train_step`).

Each step takes its random draws from the caller's `torch.Generator`
(`draw_step_noise`, `draw_pose_noise`, `draw_gen_noise`) or as `noise=`,
so a test can feed the draws JAX made from its keys; each loss function
(`det_loss`, `pose_loss`, `gen_loss`) also returns the step's discrete
choices and takes them back, so two runs that differ by rounding compare
on the same decisions.

Numerics: the model holds its parameters in its compute dtype (bf16 on
the card); the optimizer keeps fp32 master copies and Adam moments of the
trainable parameters only and writes the rounded masters back into the
model after each step, which gives the gradient of the JAX package's
fp32 parameters cast to bf16 at use. Frozen parameters get
`requires_grad=False`: no gradient buffer, no optimizer state, and no
backward through modules with nothing trainable upstream (the frozen ViT).

The update is the optax chain of the JAX `build_optimizer`, written out:
one global-norm clip over all trainable gradients, then per parameter
group (`low`, `llm`, `base` by `LOW_LR_PAT` / `LLM_LR_PAT` on the dotted
parameter path) Adam with bias correction and eps outside the square
root, decoupled weight decay on parameters with ndim >= 2, the warmup +
cosine schedule and the group's lr multiplier. The arithmetic is
elementwise on the card (PyTorch operations); it launches no kernel of
this package.

Gradient accumulation (`OptimizerConfig.grad_accum_steps` k > 1) is
`optax.MultiSteps` as the JAX `build_optimizer` wraps the chain: each
micro-step folds its gradient into an fp32 running mean, `acc + (g - acc)
/ (mini_step + 1)` (optax's Welford update), and every k-th applies the
chain to that mean (clipping sees the mean) and zeroes it. The other
micro-steps leave the masters, the moments and the model's parameters
as they are, bit for bit. The schedule and Adam's bias correction count
applied steps (`TrainState.gradient_step`), `TrainState.step` counts
micro-steps. Every step reports `grad_norm`: the global norm of the
gradient the update sees, on a micro-step that does not apply the norm
of the running mean so far.

On a mesh (`TrainState.mesh`; `shard_train_step`, the Trainer under a
process group) a step is the one-process step on the global batch, as
XLA's jitted step is in JAX. The model is sharded by `apply_shardings`
(FSDP2 over "data", tensor parallelism over "model"); each rank takes its
rows of the global batch and of the global batch's draws (`step.draw`:
the Trainer draws them on every rank from the same generator); the
loss runs under `global_batch.split_over`, so each rank's loss is its
part of the global loss; FSDP2 sums (not averages) the data ranks'
gradients into each rank's shard; the masters, moments and running mean
are fp32 copies of this rank's shards (ZeRO-style, the layout JAX's
`opt_sh` gives), updated as plain tensors (no DTensor dispatch: the
update is elementwise); the clipping norm is the global one, each shard
counted once (`parallel.mesh.holders`); the metrics are summed over the
data ranks, so every rank reports the global batch's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from visionllm_tpu_torch.config import GDinoConfig, OptimizerConfig
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.parallel.global_batch import split_over
from visionllm_tpu_torch.parallel.mesh import (apply_shardings,
                                               gathered_units, holders,
                                               local_part, regather,
                                               shard_batch, shard_of)
from visionllm_tpu_torch.train.cdn import dn_loss, draw_cdn_noise
from visionllm_tpu_torch.train.losses import (detection_loss_with_aux,
                                              draw_mask_points)
from visionllm_tpu_torch.train.pose_losses import pose_loss_with_aux

LOW_LR_PAT = re.compile(
    r"(backbone|sampling_offsets|reference_points_head|ref_point_head)")
LLM_LR_PAT = re.compile(r"(core\.llm|core\.vl_bridge|region_encoder)")

Frozen = Optional[Callable[[str], bool]]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's `warmup_cosine_decay_schedule`: linear from init to peak
    over the warmup, then cosine from peak to end over the rest."""
    def sched(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        n = decay_steps - warmup_steps
        c = min(count - warmup_steps, n)
        cosine = 0.5 * (1 + math.cos(math.pi * c / n))
        alpha = end_value / peak_value
        return peak_value * ((1 - alpha) * cosine + alpha)
    return sched


def split_frozen(model: nn.Module, frozen: Frozen) -> Dict[str, nn.Parameter]:
    """Set `requires_grad=False` on every frozen parameter and return the
    trainable ones by dotted path."""
    trainable = {}
    for name, p in model.named_parameters():
        if frozen is not None and frozen(name):
            p.requires_grad_(False)
        else:
            p.requires_grad_(True)
            trainable[name] = p
    return trainable


def _global_norm(tensors, copies: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """optax's `global_norm` of a list of fp32 tensors; with `copies`
    (how many ranks hold each tensor's part), of the whole tensors that
    the world's parts make: each squared local norm over its copies,
    summed over every rank."""
    norms = torch.stack(torch._foreach_norm(tensors))
    if copies is None:
        return torch.linalg.vector_norm(norms)
    sq = (norms.square() / copies).sum()
    dist.all_reduce(sq)
    return sq.sqrt()


class AdamW:
    """The JAX `build_optimizer` chain over named trainable parameters."""

    def __init__(self, cfg: OptimizerConfig, names):
        self.cfg = cfg
        if cfg.schedule == "cosine":
            # warmup_steps = 0 starts at the peak, not at a zero step
            init = cfg.learning_rate if cfg.warmup_steps == 0 else 0.0
            self.schedule = warmup_cosine_decay_schedule(
                init, cfg.learning_rate, max(cfg.warmup_steps, 1),
                max(cfg.total_steps, 2))
        else:
            self.schedule = lambda count: cfg.learning_rate
        self.mult = {n: self._mult(n) for n in names}

    def _mult(self, name: str) -> float:
        if LOW_LR_PAT.search(name):
            return self.cfg.lr_multiplier
        if LLM_LR_PAT.search(name):
            return self.cfg.lr_llm_multiplier
        return 1.0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: "TrainState"
               ) -> torch.Tensor:
        """One step on `state`'s masters and moments in place; returns the
        global gradient norm before clipping."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        names = list(state.masters)
        g = [grads[n].float() for n in names]
        g_norm = _global_norm(g, state.copies)
        # clip_by_global_norm: t if norm < max else t / norm * max
        clip = torch.where(g_norm < cfg.max_grad_norm,
                           torch.ones_like(g_norm),
                           cfg.max_grad_norm / g_norm)
        count = state.gradient_step + 1
        lr = self.schedule(state.gradient_step)
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        for n, gi in zip(names, g):
            gi = gi * clip
            mu, nu, w = state.mu[n], state.nu[n], state.masters[n]
            mu.mul_(b1).add_(gi, alpha=1 - b1)
            nu.mul_(b2).addcmul_(gi, gi, value=1 - b2)
            upd = (mu / c1) / ((nu / c2).sqrt() + cfg.eps)
            if cfg.weight_decay and w.ndim >= 2:
                upd = upd + cfg.weight_decay * w
            w.add_(upd, alpha=-lr * self.mult[n])
        return g_norm


def build_optimizer(cfg: OptimizerConfig, model: nn.Module,
                    frozen: Frozen = None) -> AdamW:
    """AdamW with per-group lr multipliers over the model's trainable
    parameters (`frozen(path) -> True` marks one frozen; see
    `split_frozen`)."""
    return AdamW(cfg, list(split_frozen(model, frozen)))


@dataclasses.dataclass
class TrainState:
    """Step count (micro-steps), the model, and the fp32 masters and Adam
    moments of its trainable parameters (by dotted path); `mini_step`,
    micro-steps into the current accumulation, and `gradient_step`,
    applied steps (Adam's count and the schedule's step; equal to `step`
    when k is 1), as optax's `MultiStepsState` has them; and `acc`, the
    fp32 running mean of the gradients (its `acc_grads`), empty when k is
    1.

    On a mesh (`mesh`, the `DeviceMesh` the model was sharded over by
    `apply_shardings`) the masters, moments and running mean hold this
    rank's parts of each tensor; `params` holds the trainable parameters
    as the mesh lays them out (FSDP2's sharded DTensors; a parameter
    FSDP2 leaves whole is a plain tensor on every rank) and `copies` how
    many ranks hold the same part of each (`parallel.mesh.holders`, in
    the masters' order)."""

    step: int
    model: nn.Module
    masters: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    mini_step: int = 0
    gradient_step: int = 0
    acc: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mesh: Any = None
    params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    copies: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, model: nn.Module, tx: AdamW, frozen: Frozen = None,
               mesh=None) -> "TrainState":
        """A fresh state of `model`'s trainable parameters; with `mesh`, of a
        model that `apply_shardings` sharded over it, in this rank's parts
        (the one layout of a state on a mesh: `on_mesh` and the Trainer's
        restore fill it with `load`)."""
        with _sharded(model, mesh):
            trainable = split_frozen(model, frozen)
        if set(trainable) != set(tx.mult):
            raise ValueError("the optimizer was built for other "
                             "trainable parameters")
        return cls._laid_out(model, trainable,
                             tx.cfg.grad_accum_steps > 1, mesh)

    @classmethod
    def _laid_out(cls, model: nn.Module, trainable: Dict[str, torch.Tensor],
                  accum: bool, mesh) -> "TrainState":
        """The state of the `trainable` parameters (the masters their
        values, in this rank's parts) and, on `mesh`, the sharded
        parameters, the copies of each part, and FSDP2 set to sum the data
        ranks' gradients (the losses are each rank's part of the global
        loss)."""
        with _sharded(model, mesh):
            masters = {n: local_part(p).detach().float().clone()
                       for n, p in trainable.items()}

        def zeros():
            return {n: torch.zeros_like(w) for n, w in masters.items()}
        state = cls(step=0, model=model, masters=masters, mu=zeros(),
                    nu=zeros(), acc=zeros() if accum else {})
        if mesh is None:
            return state
        state.mesh = mesh
        state.params = dict(trainable)
        if dist.get_world_size() > 1:
            device = next(iter(masters.values())).device if masters else None
            state.copies = torch.tensor(
                [float(holders(p)) for p in trainable.values()],
                device=device)
        for m in model.modules():
            if hasattr(m, "set_gradient_divide_factor"):
                m.set_gradient_divide_factor(1.0)
                # a plain SUM where torch has the switch (gloo has no
                # pre-multiplied sum; NCCL's, by 1, is one too)
                if hasattr(m, "set_force_sum_reduction_for_comms"):
                    m.set_force_sum_reduction_for_comms(True)
        return state

    def on_mesh(self, mesh) -> "TrainState":
        """This one-process state on `mesh`, after `apply_shardings`
        sharded its model over it: `create`'s layout, holding this rank's
        parts of the masters, moments and running mean."""
        with _sharded(self.model, mesh):
            params = {n: p for n, p in self.model.named_parameters()
                      if n in self.masters}
        state = TrainState._laid_out(self.model, params, bool(self.acc),
                                     mesh)
        state.load({"masters": self.masters, "mu": self.mu,
                    "nu": self.nu, "acc": self.acc})
        state.step, state.mini_step, state.gradient_step = (
            self.step, self.mini_step, self.gradient_step)
        return state

    @torch.no_grad()
    def load(self, whole: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Copy whole tensors (`whole["masters"]`, `["mu"]`, `["nu"]`,
        `["acc"]` by name: a checkpoint's or a one-process state's) into
        this state; on a mesh each rank copies its parts."""
        for part in ("masters", "mu", "nu", "acc"):
            for n, t in getattr(self, part).items():
                src = whole[part][n]
                t.copy_(shard_of(src, self.params[n])
                        if self.mesh is not None else src)

    @torch.no_grad()
    def write_back(self) -> None:
        """Round the masters into the model's parameters (on a mesh, into
        this rank's parts; the units kept gathered gather again)."""
        with _sharded(self.model, self.mesh):
            params = self.params or dict(self.model.named_parameters())
            for n, w in self.masters.items():
                local_part(params[n]).copy_(w)


@contextlib.contextmanager
def _sharded(model: nn.Module, mesh):
    """With `mesh`, the block sees the model's sharded parameters: the
    units that `apply_shardings` keeps gathered are sharded for it and
    gathered again after."""
    if mesh is None:
        yield
        return
    for m in gathered_units(model):
        m.reshard()
    try:
        yield
    finally:
        regather(model)


def draw_step_noise(generator: torch.Generator, cfg: GDinoConfig,
                    targets: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Every random draw of one det step: the CDN noise and one set of
    mask points per decoder layer."""
    B, N = targets["labels"].shape
    dev = targets["labels"].device
    noise: Dict[str, object] = {
        "points": [draw_mask_points(generator, B, N, cfg, dev)
                   for _ in range(cfg.decoder_layers)]}
    if cfg.dn_number > 0:
        noise["cdn"] = draw_cdn_noise(generator, B, N, cfg.dn_number, dev)
    return noise


def det_loss(model: nn.Module, batch: Dict[str, object],
             tid: SpecialTokenIds, noise: Dict[str, object],
             choices: Optional[Dict[str, object]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                        Dict[str, object]]:
    """The det step's loss: LM cross entropy + Hungarian-matched det losses
    of every decoder layer and the encoder + the dn losses of every layer.
    Returns (loss, metrics, choices); metrics has loss, lm_loss, det_loss
    and the last layer's terms, as the JAX step reports them. `choices`
    holds the step's discrete decisions (the two-stage top-k proposals,
    the matchings, the chosen mask points); passed back in, they are
    repeated instead of decided again, so two runs that differ by
    rounding compare on the same decisions."""
    gcfg = model.cfg.gdino
    choices = choices or {}
    out = model.forward_det(batch, tid, dn_noise=noise.get("cdn"),
                            topk_idx=choices.get("topk_idx"))
    det = out["det"]
    det_total, detail, made = detection_loss_with_aux(
        det, batch["targets"], cfg=gcfg,
        points=choices.get("points", noise["points"]),
        matches=choices.get("matches"))
    made["topk_idx"] = det["topk_idx"]
    if det.get("dn_targets") is not None:
        n_lvl = det["dn_all_logits"].shape[0]
        for lvl in range(n_lvl):
            d = dn_loss(det["dn_all_logits"][lvl], det["dn_all_boxes"][lvl],
                        det["dn_targets"], cfg=gcfg,
                        text_mask=det["text_mask"])
            suffix = "" if lvl == n_lvl - 1 else f"_aux{lvl}"
            for k, v in d.items():
                detail[k + suffix] = v
                det_total = det_total + v
    loss = out["lm_loss"] + det_total
    metrics = {"loss": loss, "lm_loss": out["lm_loss"], "det_loss": det_total}
    metrics.update({k: v for k, v in detail.items()
                    if not ("aux" in k or "enc" in k)})
    return loss, metrics, made


def draw_pose_noise(generator: torch.Generator, cfg,
                    targets: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Every random draw of one pose step (`cfg` a `UniPoseConfig`): the
    CDN noise."""
    if cfg.dn_number <= 0:
        return {}
    B, N = targets["labels"].shape
    return {"cdn": draw_cdn_noise(generator, B, N, cfg.dn_number,
                                  targets["labels"].device)}


def pose_loss(model: nn.Module, batch: Dict[str, object],
              tid: SpecialTokenIds, num_obj_patches: int,
              noise: Dict[str, object],
              choices: Optional[Dict[str, object]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                         Dict[str, object]]:
    """The pose step's loss: LM cross entropy + the Hungarian-matched pose
    losses of every UniPose decoder layer and the encoder + the dn losses
    of every layer. Returns (loss, metrics, choices): metrics as the JAX
    step reports them (the terms without `aux`), choices the two top-k
    selections and the matchings."""
    pcfg = model.cfg.unipose
    choices = choices or {}
    out = model.forward_pose(batch, tid, num_obj_patches,
                             dn_noise=noise.get("cdn"),
                             topk_idx=choices.get("topk_idx"),
                             group_idx=choices.get("group_idx"))
    pose = out["pose"]
    total, detail, matches = pose_loss_with_aux(
        pose, batch["targets"], cfg=pcfg, matches=choices.get("matches"))
    for lvl, (dl, db) in enumerate(zip(pose.get("dn_logits", ()),
                                       pose.get("dn_boxes", ()))):
        for k, v in dn_loss(dl, db, pose["dn_targets"], cfg=pcfg).items():
            detail[f"{k}_l{lvl}"] = v
            total = total + v
    loss = out["lm_loss"] + total
    metrics = {"loss": loss, "lm_loss": out["lm_loss"], "pose_loss": total}
    metrics.update({k: v for k, v in detail.items() if "aux" not in k})
    return loss, metrics, {"topk_idx": pose["topk_idx"],
                           "group_idx": pose["group_idx"],
                           "matches": matches}


def draw_gen_noise(generator: torch.Generator, model: nn.Module,
                   batch: Dict[str, object], edit: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """Every random draw of one [GEN] (or, `edit`, [EDIT]) step: the
    head's `draw_noise` on the batch's output images."""
    head = model.ip2p if edit else model.sd
    return head.draw_noise(generator, batch["output_images"])


def gen_loss(model: nn.Module, batch: Dict[str, object],
             tid: SpecialTokenIds, noise: Dict[str, torch.Tensor],
             edit: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                        Dict[str, object]]:
    """The [GEN] / [EDIT] step's loss: LM cross entropy + the head's
    epsilon-prediction loss (it makes no discrete choice)."""
    if edit:
        out = model.forward_edit(batch, tid, noise=noise)
    else:
        out = model.forward_gen(batch, tid, noise=noise)
    head = out["ip2p" if edit else "sd"]
    metrics = {"loss": out["loss"], "lm_loss": out["lm_loss"],
               "image_loss": head["image_loss"]}
    if "caption_loss" in head:
        metrics["caption_loss"] = head["caption_loss"]
    return out["loss"], metrics, {}


@torch.no_grad()
def accumulate(grads: Dict[str, torch.Tensor], state: TrainState
               ) -> Dict[str, torch.Tensor]:
    """Fold one micro-step's gradients into `state.acc`, optax
    MultiSteps' running mean `acc + (g - acc) / (mini_step + 1)` in fp32;
    returns the accumulator."""
    for n, a in state.acc.items():
        a.add_((grads[n].float() - a) / (state.mini_step + 1))
    return state.acc


def _own_rows(tree, shards: int, rank: int):
    """Rank `rank`'s equal share of the leading dim of every tensor in
    `tree` (the draws of a step: each is per sample)."""
    if isinstance(tree, dict):
        return {k: _own_rows(v, shards, rank) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_own_rows(v, shards, rank) for v in tree)
    n = tree.shape[0] // shards
    return tree[rank * n:(rank + 1) * n]


def _mesh_gradients(model: nn.Module, state: TrainState
                    ) -> Dict[str, torch.Tensor]:
    """This rank's part of the global gradient of each trainable
    parameter after a backward on the mesh: FSDP2 has summed the sharded
    ones over "data" into their shards; the ones it leaves whole are
    summed here."""
    registered = dict(model.named_parameters())
    stale = [n for n, p in state.params.items() if registered[n] is not p]
    if stale:
        raise RuntimeError(
            f"FSDP2 did not reduce the gradients of {stale[:3]}: the "
            "backward reached no unit's forward output")
    shards = state.mesh["data"].size()
    grads = {}
    for n, p in state.params.items():
        g = local_part(p.grad) if p.grad is not None else None
        if g is None:
            g = torch.zeros_like(local_part(p))
        elif shards > 1 and not hasattr(p, "to_local"):
            dist.all_reduce(g, group=state.mesh["data"].get_group())
        grads[n] = g
    return grads


def _sum_metrics(metrics: Dict[str, torch.Tensor], mesh
                 ) -> Dict[str, torch.Tensor]:
    """Each rank's part of the global batch's loss terms, summed over the
    data ranks."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals, group=mesh["data"].get_group())
    return dict(zip(keys, vals.unbind()))


def _make_step(model: nn.Module, tx: AdamW, frozen: Frozen, loss_fn,
               draw):
    """step(state, batch, generator=None, noise=None) -> (state, metrics)
    from loss_fn(batch, noise) -> (loss, metrics, choices) and
    draw(generator, batch) -> noise: the backward over the trainable
    parameters, then (every `grad_accum_steps`-th micro-step, see the
    module docstring) the AdamW update and the masters written back;
    `grad_norm` in the metrics. `frozen` must be the predicate the state
    was created with. On a mesh (`state.mesh`) `batch` is this rank's
    rows of the global batch and `noise`, which a mesh of more than one
    data rank needs given, the global batch's draws (`step.draw(
    generator, global_batch)`): the step keeps this rank's rows."""
    split_frozen(model, frozen)
    every = tx.cfg.grad_accum_steps

    def step(state: TrainState, batch, generator=None, noise=None):
        mesh = state.mesh
        shards = 1 if mesh is None else mesh["data"].size()
        if noise is None:
            if shards > 1:
                raise ValueError("a step over several data ranks takes the "
                                 "global batch's draws as noise= "
                                 "(step.draw)")
            noise = draw(generator, batch)
        if shards > 1:
            noise = _own_rows(noise, shards, mesh["data"].get_local_rank())
        trainable = state.params or {n: p for n, p in
                                     model.named_parameters()
                                     if n in state.masters}
        for p in trainable.values():
            p.grad = None
        with split_over(mesh):
            loss, metrics, _ = loss_fn(batch, noise)
        loss.backward()
        if mesh is None:
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in trainable.items()}
        else:
            grads = _mesh_gradients(model, state)
            if shards > 1:
                metrics = _sum_metrics(metrics, mesh)
        if every > 1:
            grads = accumulate(grads, state)
        if state.mini_step == every - 1:
            metrics["grad_norm"] = tx.update(grads, state)
            state.gradient_step += 1
            for a in state.acc.values():
                a.zero_()
            state.write_back()
        else:
            metrics["grad_norm"] = _global_norm(
                [t.float() for t in grads.values()], state.copies)
            if mesh is not None:
                regather(model)
        state.mini_step = (state.mini_step + 1) % every
        state.step += 1
        for p in trainable.values():
            p.grad = None
        return state, {k: v.detach() for k, v in metrics.items()}

    step.draw = draw
    return step


def shard_train_step(step_fn, mesh, state: TrainState, batch,
                     rules=None):
    """The counterpart of the JAX `shard_train_step`: shard `state.model`
    over `mesh` by `rules` in place (`apply_shardings`; FSDP/TP rules by
    default), the state's masters, moments and running mean to this
    rank's parts (the ZeRO-style layout of JAX's `opt_sh`), and `batch`
    to this rank's rows (`shard_batch`). Returns (step_fn, the state on
    the mesh, this rank's batch); `step_fn` (any `make_*_train_step` of
    the model) runs on the mesh because the state carries it."""
    apply_shardings(state.model, mesh, rules)
    return step_fn, state.on_mesh(mesh), shard_batch(batch, mesh)


def chat_loss(model: nn.Module, batch: Dict[str, object],
              tid: SpecialTokenIds
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                         Dict[str, object]]:
    """The chat step's loss: the LM cross entropy of `forward_chat` (it
    draws nothing and makes no discrete choice); the JAX step reports
    `loss` alone."""
    out = model.forward_chat(batch, tid)
    return out["loss"], {"loss": out["loss"]}, {}


def make_chat_train_step(model: nn.Module, tx: AdamW, tid: SpecialTokenIds,
                         frozen: Frozen = None):
    """The chat group's step (chat, VQA, caption and region batches;
    `batch["regions"]` feeds the region encoder): `chat_loss`, no draws."""
    return _make_step(model, tx, frozen,
                      lambda batch, noise: chat_loss(model, batch, tid),
                      lambda g, batch: {})


def make_det_train_step(model: nn.Module, tx: AdamW, tid: SpecialTokenIds,
                        frozen: Frozen = None):
    """Returns step(state, batch, generator=None, noise=None) ->
    (state, metrics) for det / grd / seg batches. The draws come from
    `generator` unless `noise` (`draw_step_noise`'s layout) is given.
    `frozen` must be the predicate the state was created with."""
    return _make_step(
        model, tx, frozen,
        lambda batch, noise: det_loss(model, batch, tid, noise),
        lambda g, batch: draw_step_noise(g, model.cfg.gdino,
                                         batch["targets"]))


def make_pose_train_step(model: nn.Module, tx: AdamW, tid: SpecialTokenIds,
                         num_obj_patches: int, frozen: Frozen = None):
    """The pose group's step (`pose_loss`; the draws of
    `draw_pose_noise`); `num_obj_patches` splits the [EMB] text queries
    into object and keypoint queries."""
    return _make_step(
        model, tx, frozen,
        lambda batch, noise: pose_loss(model, batch, tid, num_obj_patches,
                                       noise),
        lambda g, batch: draw_pose_noise(g, model.cfg.unipose,
                                         batch["targets"]))


def make_gen_train_step(model: nn.Module, tx: AdamW, tid: SpecialTokenIds,
                        edit: bool = False, frozen: Frozen = None):
    """The [GEN] (or, `edit`, [EDIT]) group's step (`gen_loss`; the draws
    of `draw_gen_noise`)."""
    return _make_step(
        model, tx, frozen,
        lambda batch, noise: gen_loss(model, batch, tid, noise, edit),
        lambda g, batch: draw_gen_noise(g, model, batch, edit))
