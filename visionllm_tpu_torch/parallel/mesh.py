"""Process groups, the device mesh and the sharding rules (counterpart of
`visionllm_tpu/parallel/mesh.py`).

JAX lays one `Mesh` with the axes ("data", "context", "model") over its
devices and lets XLA place every parameter from a regex table of
`PartitionSpec`s. The port does the same work explicitly:

* `init_process_group_for(device, ...)` joins the processes: NCCL on
  `cuda:{local rank}`, gloo when the caller names the CPU. The backend
  follows the device and never falls back; a failed NCCL init raises.
* `build_mesh` lays a `DeviceMesh` with the same three axes over the
  initialized group.
* `MeshRules.fsdp_tp()` is JAX's table over the port's dotted names.
  `spec_for` gives, for every parameter, the mesh axis of each dim
  (None: not split) in the torch layout: it rebuilds the flax leaf
  (a Linear weight [out, in] is a flax kernel [in, out]; a module inside
  a `ModuleList` is a row of a scanned stack with a leading layer axis)
  and runs JAX's `_fit_spec` on it, so every parameter gets JAX's axis
  on the same logical dim.
* `apply_shardings` applies them: tensor parallelism over "model" on the
  LLM when that axis is larger than 1 (`apply_tensor_parallel`:
  q/k/v/gate/up column-parallel, o/down row-parallel, the embedding's
  vocabulary split, `lm_head` split with a replicated output) and FSDP2
  (`fully_shard`) over "data", each parameter split on JAX's data dim.
  A "model" axis of 1 splits nothing, so it adds no DTensor dispatch.
* `shard_batch` takes this rank's slice of a batch's leading dim.
* `local_part`, `shard_of`, `full_of` and `holders` move a state tensor
  between its whole and the parts the ranks hold (the Trainer's sharded
  optimizer state and gathered checkpoints).

Deliberate differences from JAX (`ROADMAP.md` §C.3): `apply_shardings`
needs "model" to divide both head counts (XLA splits inside a head;
local attention cannot); FSDP2 splits every parameter of a unit, so a
parameter JAX leaves whole is split on dim 0, and a non-contiguous one
(a channels_last conv weight) stays whole; the root unit and the fp32
modules' units are gathered once when the mesh is applied and stay
gathered, because the entry points call methods other than `forward` on
them (the layer units gather on use and free after; a train step's
backward frees them all, and the step gathers them again, `regather`);
sizes that do not divide the world raise `ValueError` where JAX asserts.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from visionllm_tpu_torch.utils.convert import flax_leaf

AXES = ("data", "context", "model")
Spec = Tuple[Optional[str], ...]


# ---------------------------------------------------------------- processes

def init_process_group_for(device: Optional[Union[str, torch.device]] = None,
                           *, init_method: str, world_size: int, rank: int,
                           timeout_s: float = 600.0) -> torch.device:
    """Join the default process group and return this rank's device.

    `device` None means `cuda:{LOCAL_RANK}` (0 when unset). A CUDA device
    gets NCCL, the CPU gets gloo; nothing falls back to the other.
    `init_method` is a `file://` or `tcp://` store, or "host:port" (a
    coordinator address, taken as tcp://)."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = torch.device(device)
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    kw = dict(init_method=init_method, world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{dev}: no CUDA device is available; name "
                               "device='cpu' for a gloo group on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", **kw)
    else:
        raise ValueError(f"{dev}: a process group runs on cuda or cpu")
    return dev


def build_mesh(n_data: Optional[int] = None, n_model: int = 1,
               n_context: int = 1, *, device: Optional[str] = None):
    """A `DeviceMesh` with ("data", "context", "model") axes over the
    initialized process group; `n_data` defaults to the world over the
    other two. `device` ("cuda" / "cpu") defaults to the group's: NCCL
    lays a CUDA mesh, gloo a CPU one."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized process group: "
                           "call parallel.mesh.init_process_group_for first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_model * n_context)
    if n_data * n_context * n_model != world:
        raise ValueError(f"mesh (data {n_data}, context {n_context}, model "
                         f"{n_model}) does not cover the world of {world}")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (n_data, n_context, n_model),
                            mesh_dim_names=AXES)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a `DeviceMesh`, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------- rules

@dataclasses.dataclass(frozen=True)
class Layout:
    """How a port parameter sits in the flax tree: its flax leaf name,
    `axes[j]` the torch dim of flax dim j (None: the same order; both from
    `utils.convert.flax_leaf`, the map `load_jax_params` inverts), and the
    sizes of the scanned stacks above it (the ModuleLists it sits in)."""

    leaf: str
    axes: Optional[Tuple[int, ...]] = None
    stack: Tuple[int, ...] = ()


def param_layouts(model: nn.Module) -> Dict[str, Layout]:
    """The `Layout` of every parameter of `model`, by dotted name."""
    out: Dict[str, Layout] = {}

    def walk(mod: nn.Module, prefix: str, stack: Tuple[int, ...]):
        for name, p in mod._parameters.items():
            if p is not None:
                leaf, axes = flax_leaf(mod, name)
                out[prefix + name] = Layout(leaf, axes, stack)
        for name, child in mod._modules.items():
            if child is None:
                continue
            inner = stack + ((len(child),) if isinstance(child, nn.ModuleList)
                             else ())
            walk(child, f"{prefix}{name}.", inner)

    walk(model, "", ())
    return out


def fit_spec(spec: Spec, shape: Tuple[int, ...],
             sizes: Mapping[str, int]) -> Spec:
    """JAX's `_fit_spec`: trim leading entries of a spec longer than the
    rank, pad a shorter one with None on the right, and drop an axis
    that does not divide its dim."""
    parts = list(spec)
    if len(parts) > len(shape):
        parts = parts[len(parts) - len(shape):]
    parts += [None] * (len(shape) - len(parts))
    return tuple(ax if ax is not None and dim % sizes[ax] == 0
                 and dim >= sizes[ax] else None
                 for dim, ax in zip(shape, parts))


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Regex -> spec table, first hit wins. A regex matches the port's
    dotted name with its last part replaced by the flax leaf name
    ("core.llm.layers.3.q_proj.kernel"); a spec is written over the flax
    leaf's dims, a scanned stack's layer axis first, as in JAX."""

    rules: Tuple[Tuple[str, Spec], ...]

    @classmethod
    def fsdp_tp(cls) -> "MeshRules":
        """JAX's table (`visionllm_tpu/parallel/mesh.py:64-78`): the LLM's
        projections tensor-parallel over "model", every kernel and
        embedding FSDP-split over "data"."""
        return cls(rules=(
            (r"llm\..*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.kernel",
             (None, "data", "model")),
            (r"llm\..*(o_proj|down_proj)\.kernel", (None, "model", "data")),
            (r"llm\..*embed_tokens\.embedding", ("model", "data")),
            (r"llm\..*lm_head\.kernel", ("data", "model")),
            (r"vis_encoder\..*(kernel|embedding)$", (None, "data")),
            (r".*\.(kernel|embedding)$", (None, "data")),
        ))

    def match(self, name: str, shape: Tuple[int, ...],
              sizes: Mapping[str, int], layout: Optional[Layout] = None
              ) -> Tuple[int, Spec]:
        """(index of the rule that placed the parameter, -1 for none;
        its spec over the torch dims)."""
        layout = layout or Layout(name.rsplit(".", 1)[-1])
        head = name.rsplit(".", 1)[0] + "." if "." in name else ""
        path = head + layout.leaf
        axes = layout.axes or tuple(range(len(shape)))
        flax_shape = layout.stack + tuple(shape[a] for a in axes)
        for i, (pat, spec) in enumerate(self.rules):
            if re.search(pat, path):
                fitted = fit_spec(spec, flax_shape, sizes)[len(layout.stack):]
                out: list = [None] * len(shape)
                for j, ax in enumerate(fitted):
                    out[axes[j]] = ax
                return i, tuple(out)
        return -1, (None,) * len(shape)

    def spec_for(self, name: str, shape: Tuple[int, ...],
                 sizes: Mapping[str, int], layout: Optional[Layout] = None
                 ) -> Spec:
        """The mesh axis of each torch dim of parameter `name` (None: not
        split); `sizes` maps each axis to its size."""
        return self.match(name, shape, sizes, layout)[1]


def shard_params(model: nn.Module, mesh, rules: Optional[MeshRules] = None
                 ) -> Dict[str, Spec]:
    """{parameter name: spec} for every parameter of `model` on `mesh` (a
    `DeviceMesh` or a mapping of axis sizes)."""
    rules = rules or MeshRules.fsdp_tp()
    sizes = axis_sizes(mesh)
    layouts = param_layouts(model)
    return {name: rules.spec_for(name, tuple(p.shape), sizes, layouts[name])
            for name, p in model.named_parameters()}


# ---------------------------------------------------------------- apply

_COLWISE = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROWWISE = ("o_proj", "down_proj")
A84 = "ROADMAP.md A.8.4"


def _fsdp_layer_types():
    from visionllm_tpu_torch.models.clip_vit import ClipEncoderLayer
    from visionllm_tpu_torch.models.intern_vit import InternVitLayer
    from visionllm_tpu_torch.models.llama import LlamaDecoderLayer
    from visionllm_tpu_torch.models.swin import SwinBlock
    return (LlamaDecoderLayer, ClipEncoderLayer, InternVitLayer, SwinBlock)


def _llms(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    from visionllm_tpu_torch.models.llama import LlamaModel
    for name, mod in model.named_modules():
        if isinstance(mod, LlamaModel):
            yield (name + "." if name else ""), mod


def apply_tensor_parallel(model: nn.Module, mesh,
                          rules: Optional[MeshRules] = None) -> None:
    """Tensor parallelism over `mesh["model"]` on every dense LLaMA of
    `model`, in place: q/k/v/gate/up `ColwiseParallel`, o/down
    `RowwiseParallel`, the embedding's vocabulary and `lm_head` (with a
    replicated output) split where `rules` split them. `apply_shardings`
    calls it when "model" is larger than 1; at 1 it changes no value and
    runs the DTensor path on one device. Heads that "model" does not
    divide raise `ValueError`; quantized or LoRA layers over more than
    one rank `NotImplementedError`."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    specs = shard_params(model, mesh, rules)
    n_model = mesh["model"].size()
    for prefix, llm in _llms(model):
        cfg = llm.cfg
        dense = not cfg.quant and not cfg.lora_r
        if n_model > 1 and not dense:
            raise NotImplementedError(
                f"{prefix or 'llm'}: quantized or LoRA layers under tensor "
                f"parallelism are not ported ({A84})")
        if n_model > 1 and (cfg.num_heads % n_model
                            or cfg.num_kv_heads % n_model):
            raise ValueError(
                f"model axis {n_model} must divide the LLM's {cfg.num_heads} "
                f"heads and {cfg.num_kv_heads} kv heads")
        if not dense:
            continue
        for i, layer in enumerate(llm.layers):
            plan = {}
            for proj in _COLWISE + _ROWWISE:
                spec = specs[f"{prefix}layers.{i}.{proj}.weight"]
                want = 0 if proj in _COLWISE else 1
                if spec[want] != "model":
                    raise ValueError(
                        f"{prefix}layers.{i}.{proj}: the model axis "
                        f"{n_model} does not divide {spec} of its weight")
                plan[proj] = (ColwiseParallel() if proj in _COLWISE
                              else RowwiseParallel())
            parallelize_module(layer, mesh["model"], plan)
        top = {}
        if specs[prefix + "embed_tokens.weight"][0] == "model":
            top["embed_tokens"] = RowwiseParallel(input_layouts=Replicate())
        if specs[prefix + "lm_head.weight"][0] == "model":
            top["lm_head"] = ColwiseParallel(output_layouts=Replicate())
        if top:
            parallelize_module(llm, mesh["model"], top)
        llm.tp_size = n_model


def apply_shardings(model: nn.Module, mesh,
                    rules: Optional[MeshRules] = None) -> None:
    """Shard `model` (on its mesh device) in place by `rules`
    (`shard_params`). Tensor parallelism over "model" first when that
    axis is larger than 1 (`apply_tensor_parallel`), then `fully_shard`
    over "data" bottom-up: the fp32 modules (FSDP2 gathers one dtype a
    unit), the LLaMA / CLIP / InternViT / Swin layers, the root. The root
    and fp32 units are gathered here and stay gathered; a layer gathers
    for its forward and frees after."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = shard_params(model, mesh, rules)
    if mesh["model"].size() > 1:
        apply_tensor_parallel(model, mesh, rules)
    place = {id(p): Shard(specs[n].index("data"))
             for n, p in model.named_parameters() if "data" in specs[n]}

    def placement(p):
        return place.get(id(p))         # None: FSDP's default, Shard(0)

    # FSDP2 takes contiguous parameters only: the channels_last conv
    # weights (the SD heads' UNet and VAE on CUDA) stay whole on each rank
    kw = dict(mesh=mesh["data"], shard_placement_fn=placement,
              ignored_params={p for p in model.parameters()
                              if not p.is_contiguous()})
    fp32 = list(model.fp32_modules()) if hasattr(model, "fp32_modules") \
        else []
    layers = [m for m in model.modules()
              if isinstance(m, _fsdp_layer_types())]
    for mod in fp32:
        if any(True for _ in mod.parameters()):
            fully_shard(mod, reshard_after_forward=False, **kw)
    for mod in layers:
        fully_shard(mod, **kw)
    fully_shard(model, reshard_after_forward=False, **kw)
    # the root's state must be the first to initialize, so that the layer
    # units become its children and free their parameters after forward.
    # FSDP2 has no public call that orders this (`_lazy_init` is private):
    # what it must keep, a layer unit sharded again after a forward and
    # the root still gathered, is asserted on the CPU by
    # tests/test_torch_parallel_tp.py::test_tp_units_after_forward
    model._get_fsdp_state()._lazy_init()
    regather(model)


def gathered_units(model: nn.Module):
    """The FSDP2 units that `apply_shardings` keeps gathered: the fp32
    modules' and the root."""
    fp32 = list(model.fp32_modules()) if hasattr(model, "fp32_modules") \
        else []
    return [m for m in fp32 if hasattr(m, "unshard")] + [model]


def regather(model: nn.Module) -> None:
    """Gather the units of `gathered_units` again (a backward frees them
    with every other unit; nothing calls their `forward`, which would)."""
    for mod in gathered_units(model):
        mod.unshard()


# ---------------------------------------------------------------- shards

def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a DTensor (a plain tensor is whole here)."""
    return t.to_local() if hasattr(t, "to_local") else t


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of `full`, laid out as the DTensor `like` (its
    mesh and placements; `full` itself for a plain tensor), on `like`'s
    device, without communication."""
    if not hasattr(like, "to_local"):
        return full.to(like.device)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def full_of(local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of the parts `local` that every rank holds,
    laid out as the DTensor `like` (a collective over its mesh; `local`
    itself for a plain tensor)."""
    if not hasattr(like, "to_local"):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride()).full_tensor()


def holders(t: torch.Tensor) -> int:
    """The ranks of the world that hold the same part of `t` as this one:
    the world over the shards of a DTensor, the world for a plain tensor
    (whole on every rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not hasattr(t, "to_local"):
        return world
    shards = 1
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            shards *= t.device_mesh.size(i)
    return world // shards


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's part of `batch` (nested dicts / lists / tuples of
    tensors and arrays): the leading dim split over "data" where the data
    size divides it, else whole, as JAX's `shard_batch` places it.
    Scalars and other leaves pass through."""
    n = mesh["data"].size()
    r = mesh["data"].get_local_rank()

    def part(x):
        if isinstance(x, Mapping):
            return type(x)((k, part(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(part(v) for v in x)
        shape = getattr(x, "shape", ())
        if not isinstance(x, torch.Tensor) and not hasattr(x, "__array__"):
            return x
        if len(shape) == 0 or shape[0] % n or shape[0] < n:
            return x
        step = shape[0] // n
        return x[r * step:(r + 1) * step]

    return part(batch)
