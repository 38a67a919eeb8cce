"""Multi-process scenarios of the port's parallel layer, run on the CPU.

`run(scenario, world, workdir)` spawns `world` processes (one thread
each) that join a gloo group through a `file://` store in `workdir`,
read `workdir/inputs.pt` (written by the caller with `torch.save`), run
the scenario and write each rank's result to `workdir/result{rank}.pt`;
it returns the results in rank order and removes those files. A
scenario that raises fails the call with the rank's traceback. `start`
spawns the ranks and returns the call that waits for them, so the
caller can work meanwhile.

This module imports nothing of JAX or the JAX package: the tests that
use it compute the JAX side in their own process and pass arrays in and
out.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def run(scenario: str, world: int, workdir: str,
        timeout_s: float = 300.0) -> List[Any]:
    return start(scenario, world, workdir, timeout_s)()


def start(scenario: str, world: int, workdir: str,
          timeout_s: float = 300.0) -> Callable[[], List[Any]]:
    """`run` without waiting: the ranks start, and the returned call
    waits for them and returns their results. The ranks fork from a
    fresh server process that imported torch and the port once (the
    caller's process may run JAX's threads, which a fork must not
    copy)."""
    multiprocessing.set_forkserver_preload(
        ["torch", "visionllm_tpu_torch.models.composite",
         "visionllm_tpu_torch.train.runner", __name__])
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(world, str(workdir), scenario), nprocs=world,
        join=False, start_method="forkserver")
    deadline = time.monotonic() + timeout_s

    def results() -> List[Any]:
        while not ctx.join(timeout=0.2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{scenario}: ranks did not finish in "
                                   f"{timeout_s} s")
        paths = [os.path.join(workdir, f"result{r}.pt") for r in range(world)]
        out = [torch.load(p, weights_only=False) for p in paths]
        # the inputs and results hold whole models' trees: gone once read
        for p in paths + [os.path.join(workdir, "inputs.pt")]:
            os.remove(p)
        return out
    return results


def _entry(rank: int, world: int, workdir: str, scenario: str) -> None:
    from visionllm_tpu_torch.parallel.mesh import init_process_group_for

    torch.set_num_threads(1)
    init_process_group_for("cpu", init_method=f"file://{workdir}/store",
                           world_size=world, rank=rank, timeout_s=240)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            weights_only=False)
        out = SCENARIOS[scenario](rank, world, inputs)
        torch.save(out, os.path.join(workdir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _placement(p) -> tuple:
    return type(p).__name__, getattr(p, "dim", None)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- scenarios

def multihost(rank: int, world: int, inputs: Dict) -> Dict:
    from visionllm_tpu_torch.parallel.multihost import (all_gather_objects,
                                                        shard_indices)
    idx = shard_indices(7)
    local = [{"host": rank, "i": i, "blob": "x" * (10 + 90 * rank)}
             for i in idx]
    return {"idx": idx, "merged": all_gather_objects(local)}


def ring(rank: int, world: int, inputs: Dict) -> Dict:
    """Every case of `inputs["ring"]` through `ring_attention_spmd` on a
    (data 1, context world) mesh, and the same on a (data 2, context
    world / 2) mesh."""
    from visionllm_tpu_torch.ops.ring_attention import ring_attention_spmd
    from visionllm_tpu_torch.parallel.mesh import build_mesh

    out = {}
    meshes = {"context": build_mesh(n_data=1, n_context=world),
              "data_context": build_mesh(n_data=2, n_context=world // 2)}
    for name, case in inputs["ring"].items():
        q, k, v = (_t(case[x]) for x in "qkv")
        for mname, mesh in meshes.items():
            got = ring_attention_spmd(q, k, v, mesh, causal=case["causal"])
            out[f"{name}/{mname}"] = got.numpy()
    return out


def _llama(cfg_kw: Dict, params) -> torch.nn.Module:
    from visionllm_tpu_torch.config import LLMConfig
    from visionllm_tpu_torch.models.llama import LlamaModel
    from visionllm_tpu_torch.utils.convert import load_jax_params

    llm = LlamaModel(LLMConfig(**cfg_kw))
    load_jax_params(llm, params)
    return llm


def pipeline(rank: int, world: int, inputs: Dict) -> Dict:
    """GPipe forward for each (n_layers, n_stages, n_micro) case, the
    backward of the 4-stage case with its gradients gathered to rank 0,
    and the indivisible cases' errors."""
    from torch.distributed.device_mesh import init_device_mesh

    from visionllm_tpu_torch.parallel.multihost import all_gather_objects
    from visionllm_tpu_torch.parallel.pipeline import pipeline_llm_forward

    meshes = {S: init_device_mesh("cpu", (world // S, S),
                                  mesh_dim_names=("rep", "pipe"))
              for S in (2, 4)}
    embeds, pos = _t(inputs["embeds"]), _t(inputs["pos"])
    out: Dict[str, Any] = {}
    for (n_layers, S, M), params in inputs["cases"].items():
        llm = _llama(dict(inputs["cfg"], num_layers=n_layers), params)
        with torch.no_grad():
            got = pipeline_llm_forward(llm.cfg, llm, embeds, pos, meshes[S],
                                       n_microbatch=M)
        out[(n_layers, S, M)] = got.numpy()
    llm = _llama(dict(inputs["cfg"], num_layers=4), inputs["cases"][4, 4, 2])
    logits = pipeline_llm_forward(llm.cfg, llm, embeds, pos, meshes[4],
                                  n_microbatch=2)
    (logits.square().sum() / logits.numel()).backward()
    grads = all_gather_objects([{n: p.grad.numpy() for n, p in
                                 llm.named_parameters()
                                 if p.grad is not None}])
    out["grads"] = {n: g for part in grads for n, g in part.items()}
    errors = []
    for kw, M in (({"num_layers": 6}, 2), ({"num_layers": 4}, 3)):
        llm6 = _llama(dict(inputs["cfg"], **kw), inputs["odd"][kw["num_layers"]])
        try:
            pipeline_llm_forward(llm6.cfg, llm6, embeds, pos, meshes[4],
                                 n_microbatch=M)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def constrain(rank: int, world: int, inputs: Dict) -> Dict:
    """`constrain_seq`'s no-op cases (each must return `x` itself), its
    placements and values on a DTensor under a (data 2, context 2) mesh,
    and a LLaMA prefill under that mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from visionllm_tpu_torch.parallel.mesh import build_mesh
    from visionllm_tpu_torch.parallel.sequence import constrain_seq, set_mesh

    x = _t(inputs["x"])
    mesh = build_mesh(n_data=2, n_context=world // 2)
    flat = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    same = {"no_mesh": constrain_seq(x) is x}
    with set_mesh(flat):
        same["no_context_axis"] = constrain_seq(x) is x
    with set_mesh(mesh):
        y, z = torch.zeros(1, 9, 4), torch.zeros(1, 1, 4)
        same["indivisible"] = constrain_seq(y) is y
        same["decode"] = constrain_seq(z) is z
        same["plain_tensor"] = constrain_seq(x) is x
        dx = distribute_tensor(x, mesh, [Replicate()] * 3)
        cx = constrain_seq(dx * 1.5)
    with set_mesh(build_mesh(n_data=world, n_context=1)):
        same["context_of_one"] = constrain_seq(x) is x
    llm = _llama(inputs["cfg"], inputs["params"])
    embeds, pos = _t(inputs["embeds"]), _t(inputs["pos"])
    with torch.no_grad():
        want = llm(embeds, pos)[1]
        with set_mesh(mesh):
            got = llm(embeds, pos)[1]
    return {"same": same, "placements": [_placement(p) for p in cx.placements],
            "full": cx.full_tensor().numpy(), "logits_plain": want.numpy(),
            "logits_mesh": got.numpy()}


def tp(rank: int, world: int, inputs: Dict) -> Dict:
    """The tiny composite on a (data 2, model 2) mesh: greedy generate,
    a [DET]-forced generate, slot streams with staggered arrivals and
    `infer_det`, each after `apply_shardings`; also the placements
    applied and a refusal of heads the model axis does not divide."""
    from visionllm_tpu_torch.config import tiny_test_config
    from visionllm_tpu_torch.generation import build_generate_fn
    from visionllm_tpu_torch.models.composite import build_model
    from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
    from visionllm_tpu_torch.parallel.mesh import apply_shardings, build_mesh
    from visionllm_tpu_torch.utils.convert import load_jax_params

    tid = SpecialTokenIds.synthetic()
    model = build_model(tiny_test_config(use_unipose=False, unipose=None),
                        device="cpu", dtype=torch.float32)
    load_jax_params(model, inputs["params"])
    mesh = build_mesh(n_data=2, n_model=world // 2)
    apply_shardings(model, mesh)
    # a sharded model loads the tree again: each DTensor takes its shard
    load_jax_params(model, inputs["params"])
    out: Dict[str, Any] = {"placements": {
        n: [_placement(q) for q in getattr(p, "placements", ())]
        for n, p in model.named_parameters()}}
    gen = build_generate_fn(model.core, tid, max_new_tokens=inputs["max_new"],
                            max_len=inputs["max_len"])
    ids, images = _t(inputs["ids"]).long(), _t(inputs["images"])
    res = gen(ids, images)
    out["tokens"] = res["out_tokens"].numpy()
    out["hidden"] = res["out_hidden"].numpy()
    res = gen(ids, images, first_token=torch.tensor([tid.det]))
    out["tokens_det"] = res["out_tokens"].numpy()
    out["streams"] = _slot_streams(model.core, tid, inputs)
    with torch.no_grad():
        det = model.infer_det(_t(inputs["det_ids"]).long(),
                              _t(inputs["det_images"]), _t(inputs["det_aug"]),
                              tid)
    out["det"] = {k: v.numpy() for k, v in det.items()}
    # after a forward: the layer units sharded again, the root gathered
    out["placements_after"] = {
        n: [_placement(q) for q in getattr(p, "placements", ())]
        for n, p in model.named_parameters()}
    return out


def _slot_streams(core, tid, inputs) -> List[List[int]]:
    """Admit request i at decode step arrivals[i] into the lowest free of
    3 slots and run every request to completion or `max_new` tokens (the
    JAX `tests/test_slots.py:_drive`)."""
    from visionllm_tpu_torch import slots

    n_slots, max_new, L_pad = 3, inputs["max_new"], inputs["slot_len"]
    init_state, prefill, insert, step = slots.build_slot_fns(
        core, tid, n_slots=n_slots, max_len=inputs["max_len"])
    state, valid = init_state()
    prompts, images = inputs["prompts"], inputs["slot_images"]
    arrivals = inputs["arrivals"]
    streams: Dict[int, List[int]] = {}
    active: Dict[int, int] = {}
    pending = sorted(range(len(prompts)), key=lambda i: arrivals[i])
    t = 0
    while pending or active:
        while pending and arrivals[pending[0]] <= t:
            i = pending.pop(0)
            free = next(s for s in range(n_slots) if s not in active)
            ids = torch.zeros(1, L_pad, dtype=torch.long)
            mask = torch.zeros(1, L_pad, dtype=torch.bool)
            ids[0, L_pad - len(prompts[i]):] = torch.tensor(prompts[i])
            mask[0, L_pad - len(prompts[i]):] = True
            pre = prefill(ids, _t(images[i:i + 1]), mask)
            state, valid = insert(state, free, pre["first"], pre["embed"],
                                  pre["cache"], pre["valid"], valid)
            streams[i] = [int(pre["first"])]
            active[free] = i
            if streams[i][0] == 2 or len(streams[i]) >= max_new:
                del active[free]
        t += 1
        if not active:
            continue
        res = step(state, valid)
        for s in list(active):
            i = active[s]
            streams[i].append(int(res["token"][s]))
            if res["finished"][s] or len(streams[i]) >= max_new:
                del active[s]
    return [streams[i] for i in range(len(prompts))]


def tp_refusals(rank: int, world: int, inputs: Dict) -> Dict:
    """`apply_shardings` on LLMs the model axis cannot split: heads it
    does not divide, int4 and LoRA layers; and on a data-only mesh, where
    it applies FSDP2 alone (no tensor parallelism over a "model" axis of
    1): the placements, the logits against the unwrapped model's."""
    import dataclasses

    from visionllm_tpu_torch.config import LLMConfig
    from visionllm_tpu_torch.models.llama import LlamaModel
    from visionllm_tpu_torch.parallel.mesh import apply_shardings, build_mesh

    mesh = build_mesh(n_data=1, n_model=world)
    base = LLMConfig(vocab_size=64, hidden_size=48, intermediate_size=96,
                     num_layers=1, num_heads=3, num_kv_heads=1,
                     max_position_embeddings=32)
    errors = {}
    for name, cfg in (("heads", base),
                      ("int4", dataclasses.replace(base, num_heads=4,
                                                   num_kv_heads=4, quant="int4",
                                                   hidden_size=128,
                                                   intermediate_size=256)),
                      ("lora", dataclasses.replace(base, num_heads=4,
                                                   num_kv_heads=4, lora_r=4))):
        try:
            apply_shardings(LlamaModel(cfg), mesh)
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    torch.manual_seed(0)
    llm = LlamaModel(dataclasses.replace(base, num_heads=4, num_kv_heads=2))
    embeds = torch.randn(2, 8, base.hidden_size)
    pos = torch.arange(8).expand(2, 8)
    with torch.no_grad():
        want = llm(embeds, pos)[1]
        apply_shardings(llm, build_mesh(n_data=world))
        got = llm(embeds, pos)[1]
    data_only = {"tp_size": llm.tp_size, "equal": bool(torch.equal(got, want)),
                 "placements": {
                     n: [_placement(q) for q in getattr(p, "placements", ())]
                     for n, p in llm.named_parameters()}}
    return {"errors": errors, "data_only": data_only}


def mesh_train(rank: int, world: int, inputs: Dict) -> Dict:
    """Each case of `inputs["cases"]`: the model of `cfg` loaded from the
    flax tree `params`, its group's train step and a fresh state put on a
    (data world / n_model, model n_model) mesh by `shard_train_step`, then
    one step for each global batch with its global draws (`noise`), each
    rank on its rows. Returns every rank's metrics, the trainable
    parameters the mesh left whole (plain tensors, not FSDP2's shards)
    and, on rank 0, the state gathered whole (masters, moments,
    running mean)."""
    from visionllm_tpu_torch.config import OptimizerConfig
    from visionllm_tpu_torch.models.composite import build_model
    from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
    from visionllm_tpu_torch.parallel.mesh import (build_mesh, full_of,
                                                   shard_batch)
    from visionllm_tpu_torch.train import train_step as ts
    from visionllm_tpu_torch.train.runner import (TrainConfig,
                                                  frozen_predicate, to_device)
    from visionllm_tpu_torch.utils.convert import load_jax_params

    tid = SpecialTokenIds.synthetic()
    out = {}
    for name, case in inputs["cases"].items():
        cfg = case["cfg"]
        model = build_model(cfg, device="cpu", dtype=torch.float32)
        load_jax_params(model, case["params"])
        frozen = frozen_predicate(TrainConfig(**case["tc"]), cfg)
        tx = ts.build_optimizer(OptimizerConfig(**case["opt"]), model, frozen)
        state = ts.TrainState.create(model, tx, frozen)
        group = case["group"]
        if group == "gdino":
            step = ts.make_det_train_step(model, tx, tid, frozen)
        elif group == "unipose":
            step = ts.make_pose_train_step(model, tx, tid, 1, frozen)
        elif group == "vlm":
            step = ts.make_chat_train_step(model, tx, tid, frozen)
        else:
            step = ts.make_gen_train_step(model, tx, tid,
                                          edit=group == "ip2p", frozen=frozen)
        mesh = build_mesh(n_model=case["n_model"])
        batches = [to_device(b, torch.device("cpu"), torch.float32)
                   for b in case["batches"]]
        step, state, local = ts.shard_train_step(step, mesh, state,
                                                 batches[0])
        rows = local["input_ids"].shape[0]
        metrics = []
        for i, (batch, noise) in enumerate(zip(batches, case["noises"])):
            if i:
                local = shard_batch(batch, mesh)
            if noise is None:         # a group that draws nothing
                noise = step.draw(None, batch)
            state, m = step(state, local, noise=noise)
            metrics.append({k: float(v) for k, v in m.items()})
        full = {part: {n: full_of(t, state.params[n]).numpy()
                       for n, t in getattr(state, part).items()}
                for part in ("masters", "mu", "nu", "acc")}
        out[name] = {"metrics": metrics, "rows": rows,
                     "whole": sorted(n for n, p in state.params.items()
                                     if not hasattr(p, "to_local")),
                     "state": full if rank == 0 else None,
                     "steps": (state.step, state.gradient_step)}
    return out


def trainer_refusals(rank: int, world: int, inputs: Dict) -> Dict:
    """`Trainer(n_model=world)` on a LoRA and on an int4 LLM: the error
    of each (raised where the model is sharded)."""
    from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
    from visionllm_tpu_torch.train.runner import TrainConfig, Trainer

    errors = {}
    for name, cfg in inputs["cfgs"].items():
        tc = TrainConfig(output_dir=os.path.join(inputs["out"], name),
                         n_model=world, batch_size=2)
        try:
            Trainer(cfg, tc, SpecialTokenIds.synthetic(), device="cpu",
                    dtype=torch.float32).init_state()
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    return errors


def trainer_runs(rank: int, world: int, inputs: Dict) -> Dict:
    """`Trainer.train` on the mesh over the world for each run of
    `inputs["runs"]` in turn: (output dir, max steps); a run whose
    directory holds a checkpoint resumes from it."""
    from visionllm_tpu_torch.config import OptimizerConfig
    from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
    from visionllm_tpu_torch.train.runner import TrainConfig, Trainer
    from visionllm_tpu_torch.utils.simple_tokenizer import HashedWordTokenizer

    torch.use_deterministic_algorithms(True)
    out = []
    for out_dir, steps in inputs["runs"]:
        tc = TrainConfig(output_dir=out_dir, optimizer=OptimizerConfig(
            **inputs["opt"]), **inputs["tc"])
        trainer = Trainer(inputs["cfg"], tc, SpecialTokenIds.synthetic(),
                          device="cpu", dtype=torch.float32)
        state = trainer.train(inputs["ds_cfgs"], HashedWordTokenizer(),
                              max_steps=steps)
        out.append({"step": state.step,
                    "groups": [h["group"] for h in trainer.history]})
    return out


SCENARIOS = {f.__name__: f for f in (multihost, ring, pipeline, constrain, tp,
                                     tp_refusals, mesh_train,
                                     trainer_refusals, trainer_runs)}
