"""Reference-checkpoint -> port state-dict conversion (counterpart of
`visionllm_tpu/utils/torch_convert.py`).

The released VisionLLMv2 checkpoint is one flat PyTorch state dict. The
converters take such a mapping of the reference's key names to tensors
and return the port's own flat state dict, keyed as `model.state_dict()`
is (`llm.layers.3.q_proj.weight`). The port keeps the reference's torch
layouts (a Linear weight [out, in], a Conv2d weight OIHW), so most
entries are renames of the stored tensor: no transpose, no cast, no
copy. Only the splits (`nn.MultiheadAttention`'s `in_proj_weight`,
InternLM2's packed `wqkv`, the vendored Swin's `qkv`) and the reshapes
(`class_embedding`) make new tensors, in the stored dtype. A bf16
checkpoint stays bf16 until `load_converted` puts each tensor into a
model laid out on the meta device, in that parameter's dtype
(`composite.build_model(cfg, state_dict=...)`).

The port's parameter names are the JAX package's flax names (see
`utils/convert.py`): flax `kernel`, LayerNorm / GroupNorm `scale` and
Embed `embedding` are `weight`, and an `nn.scan` stack `layers/layer`
is the ModuleList `layers.{i}`. So each converter here follows its JAX
counterpart entry for entry; JAX's `_stack` is `_stack` below, one
subtree a layer.

A converter ignores the keys it does not read, as JAX's do. Wrap the
state dict in `ReadRecorder` to learn which keys were left unread:
`unread()` gives those outside `allowlisted`, the keys the JAX package
documents as deliberately dropped.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
from typing import Callable, Dict, Iterator, List, Mapping, Optional

import torch
import torch.nn as nn

Tensor = torch.Tensor


def _t(w: Tensor) -> Tensor:
    """A Linear weight: the reference's [out, in] is the port's."""
    if w.dim() != 2:
        raise ValueError(f"a Linear weight is 2-D, got {tuple(w.shape)}")
    return w


def _conv(w: Tensor) -> Tensor:
    """A Conv2d weight: the reference's OIHW is the port's."""
    if w.dim() != 4:
        raise ValueError(f"a Conv2d weight is 4-D, got {tuple(w.shape)}")
    return w


def _stack(n: int, layer: Callable[[int], Dict]) -> Dict:
    """The `n` layers of a ModuleList, each under its index (JAX stacks
    them on axis 0 for `nn.scan`)."""
    return {str(i): layer(i) for i in range(n)}


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, Tensor]:
    """A nested dict of tensors as one state dict, keys joined by dots."""
    out: Dict[str, Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def _norm(sd: Mapping[str, Tensor], name: str) -> Dict[str, Tensor]:
    """A LayerNorm's weight and bias (flax `scale` and `bias`)."""
    return {"weight": sd[name + ".weight"], "bias": sd[name + ".bias"]}


def _lin(sd: Mapping[str, Tensor], name: str) -> Dict[str, Tensor]:
    """A Linear's weight, and its bias where the checkpoint has one."""
    out = {"weight": _t(sd[name + ".weight"])}
    if name + ".bias" in sd:
        out["bias"] = sd[name + ".bias"]
    return out


def _conv2d(sd: Mapping[str, Tensor], name: str,
            with_bias: bool = True) -> Dict[str, Tensor]:
    """A Conv2d's weight, and its bias where the checkpoint has one."""
    out = {"weight": _conv(sd[name + ".weight"])}
    if with_bias and name + ".bias" in sd:
        out["bias"] = sd[name + ".bias"]
    return out


def consume_tied_duplicates(sd: Mapping[str, Tensor], canonical: str,
                            alias_bases) -> None:
    """Read (and equality-check) tied-weight duplicate keys.

    With the share flags on (the reference defaults,
    configuration_grounding_dino.py:288 decoder_bbox_embed_share=True),
    a prediction head is ONE module referenced from every ModuleList slot
    and from submodule attribute aliases, so torch's `state_dict()`
    serializes the same tensors under many key paths. The port keeps one
    copy; this reads every alias and raises `ValueError` when one differs
    from the kept copy, so a checkpoint trained with share=False is not
    silently collapsed. A checkpoint saved without the aliases has none
    to read.

    canonical: full prefix of the kept copy (e.g. "gdino.bbox_embed.0").
    alias_bases: prefixes whose ".<idx>" children are tied copies
    (e.g. ["gdino.bbox_embed", "gdino.model.decoder.bbox_embed"]).
    """
    keys = list(sd.keys())
    sufs = [k[len(canonical):] for k in keys
            if k.startswith(canonical + ".")]
    for base in alias_bases:
        pref = base + "."
        idxs = sorted({k[len(pref):].split(".", 1)[0]
                       for k in keys if k.startswith(pref)
                       and k[len(pref):].split(".", 1)[0].isdigit()})
        for i in idxs:
            full = f"{base}.{i}"
            if full == canonical:
                continue
            for s in sufs:
                if full + s not in sd:
                    continue
                dup, ref = sd[full + s], sd[canonical + s]
                # meta tensors (key-set checks) carry no values
                if (dup.shape != ref.shape or dup.dtype != ref.dtype
                        or not (dup.is_meta or torch.equal(dup, ref))):
                    raise ValueError(
                        f"{full + s} should be a tied copy of "
                        f"{canonical + s} (decoder_*_embed_share) but "
                        f"differs: the checkpoint was trained with "
                        f"unshared heads, which the port does not "
                        f"represent")


# ---------------------------------------------------------------------------
# the language models and the vision towers
# ---------------------------------------------------------------------------

_LLAMA_NAMES = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
                "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
                "down_proj": "mlp.down_proj"}


def convert_llama(sd: Mapping[str, Tensor], cfg,
                  prefix: str = "model.") -> Dict[str, Tensor]:
    """HF LlamaForCausalLM state dict -> `LlamaModel` state dict.

    `prefix` is the submodule path holding the decoder ("model." for a
    bare LlamaForCausalLM; "llm.model." inside the composite checkpoint).
    cfg: LLMConfig.
    """
    p = prefix

    def layer(i):
        lp = f"{p}layers.{i}."
        out = {ours: {"weight": _t(sd[lp + theirs + ".weight"])}
               for ours, theirs in _LLAMA_NAMES.items()}
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[norm] = {"weight": sd[lp + norm + ".weight"]}
        return out

    head_prefix = prefix.rsplit("model.", 1)[0]
    return _flat({
        "embed_tokens": {"weight": sd[p + "embed_tokens.weight"]},
        "layers": _stack(cfg.num_layers, layer),
        "norm": {"weight": sd[p + "norm.weight"]},
        "lm_head": {"weight": _t(sd[head_prefix + "lm_head.weight"])},
    })


def convert_clip_vit(sd: Mapping[str, Tensor], cfg,
                     prefix: str = "vision_model.") -> Dict[str, Tensor]:
    """HF CLIPVisionModel state dict -> `ClipVisionTower` state dict.
    cfg: VisionEncoderConfig."""
    p = prefix

    def layer(i):
        lp = f"{p}encoder.layers.{i}."
        return {
            "layer_norm1": _norm(sd, lp + "layer_norm1"),
            "layer_norm2": _norm(sd, lp + "layer_norm2"),
            "q_proj": _lin(sd, lp + "self_attn.q_proj"),
            "k_proj": _lin(sd, lp + "self_attn.k_proj"),
            "v_proj": _lin(sd, lp + "self_attn.v_proj"),
            "out_proj": _lin(sd, lp + "self_attn.out_proj"),
            "fc1": _lin(sd, lp + "mlp.fc1"),
            "fc2": _lin(sd, lp + "mlp.fc2"),
        }

    return _flat({
        "patch_embedding": {"weight": _conv(
            sd[p + "embeddings.patch_embedding.weight"])},
        "class_embedding": sd[p + "embeddings.class_embedding"].reshape(
            1, 1, -1),
        "position_embedding": {"weight": sd[
            p + "embeddings.position_embedding.weight"]},
        "pre_layrnorm": _norm(sd, p + "pre_layrnorm"),
        "layers": _stack(cfg.num_layers, layer),
    })


def convert_swin(sd: Mapping[str, Tensor], cfg,
                 prefix: str = "") -> Dict[str, Tensor]:
    """HF SwinBackbone state dict -> `SwinBackbone` state dict.

    `cfg` is a `models.swin.SwinConfig`; HF stage names are
    stage1..stage4 for 0-based stage indices 0..3.
    """
    p = prefix
    out: Dict = {
        "patch_embed": _conv2d(sd, p + "embeddings.patch_embeddings"
                               ".projection"),
        "patch_norm": _norm(sd, p + "embeddings.norm"),
    }
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            lp = p + f"encoder.layers.{s}.blocks.{b}."
            out[f"stage{s}_block{b}"] = {
                "layernorm_before": _norm(sd, lp + "layernorm_before"),
                "layernorm_after": _norm(sd, lp + "layernorm_after"),
                "query": _lin(sd, lp + "attention.self.query"),
                "key": _lin(sd, lp + "attention.self.key"),
                "value": _lin(sd, lp + "attention.self.value"),
                "proj": _lin(sd, lp + "attention.output.dense"),
                "fc1": _lin(sd, lp + "intermediate.dense"),
                "fc2": _lin(sd, lp + "output.dense"),
                "relative_position_bias_table": sd[
                    lp + "attention.self.relative_position_bias_table"],
            }
        if s < cfg.num_stages - 1:
            dp = p + f"encoder.layers.{s}.downsample."
            out[f"downsample{s}"] = {
                "norm": _norm(sd, dp + "norm"),
                "reduction": {"weight": _t(sd[dp + "reduction.weight"])},
            }
    for s in cfg.out_stages:
        out[f"out_norm{s}"] = _norm(
            sd, p + f"hidden_states_norms.stage{s + 1}")
    return _flat(out)


def convert_internlm2_layer(sd: Mapping[str, Tensor], cfg, i: int,
                            prefix: str = "model.") -> Dict[str, Tensor]:
    """Layer `i` of an InternLM2 decoder -> the state dict of the port's
    `LlamaDecoderLayer` (keys relative to the layer).

    InternLM2 (visionllmv2/model/internlm2/modeling_internlm2.py) packs
    q, k and v into one `wqkv` laid out per kv-head group as
    [q·ratio, k, v] (:344-357); its other names differ from LLaMA's
    (attention_norm / ffn_norm / w1 / w2 / w3 / wo).
    """
    h, h_kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ratio = h // h_kv
    lp = f"{prefix}layers.{i}."
    w = _t(sd[lp + "attention.wqkv.weight"]).reshape(
        h_kv, ratio + 2, d, cfg.hidden_size)
    return _flat({
        "q_proj": {"weight": w[:, :ratio].reshape(h * d, cfg.hidden_size)},
        "k_proj": {"weight": w[:, -2].reshape(h_kv * d, cfg.hidden_size)},
        "v_proj": {"weight": w[:, -1].reshape(h_kv * d, cfg.hidden_size)},
        "o_proj": {"weight": _t(sd[lp + "attention.wo.weight"])},
        "gate_proj": {"weight": _t(sd[lp + "feed_forward.w1.weight"])},
        "up_proj": {"weight": _t(sd[lp + "feed_forward.w3.weight"])},
        "down_proj": {"weight": _t(sd[lp + "feed_forward.w2.weight"])},
        "input_layernorm": {"weight": sd[lp + "attention_norm.weight"]},
        "post_attention_layernorm": {"weight": sd[lp + "ffn_norm.weight"]},
    })


def convert_internlm2(sd: Mapping[str, Tensor], cfg,
                      prefix: str = "model.") -> Dict[str, Tensor]:
    """InternLM2ForCausalLM state dict -> `LlamaModel` state dict (GQA).
    With `cfg.num_layers` 0 it converts the embeddings, the final norm
    and the head alone. cfg: LLMConfig."""
    p = prefix
    head_prefix = prefix.rsplit("model.", 1)[0]
    return _flat({
        "embed_tokens": {"weight": sd[p + "tok_embeddings.weight"]},
        "layers": _stack(cfg.num_layers, lambda i: convert_internlm2_layer(
            sd, cfg, i, prefix)),
        "norm": {"weight": sd[p + "norm.weight"]},
        "lm_head": {"weight": _t(sd[head_prefix + "output.weight"])},
    })


def convert_intern_vit_layer(sd: Mapping[str, Tensor], cfg, i: int,
                             prefix: str = "") -> Dict[str, Tensor]:
    """Layer `i` of an InternVisionModel -> the state dict of the port's
    `InternVitLayer` (keys relative to the layer): RMSNorms, the packed
    qkv (bias when the checkpoint has one), layer scales `ls1` / `ls2`
    and, with `qk_normalization`, `q_norm` / `k_norm`."""
    lp = f"{prefix}encoder.layers.{i}."
    out = {
        "norm1": {"weight": sd[lp + "norm1.weight"]},
        "norm2": {"weight": sd[lp + "norm2.weight"]},
        "qkv": _lin(sd, lp + "attn.qkv"),
        "proj": _lin(sd, lp + "attn.proj"),
        "fc1": _lin(sd, lp + "mlp.fc1"),
        "fc2": _lin(sd, lp + "mlp.fc2"),
        "ls1": sd[lp + "ls1"],
        "ls2": sd[lp + "ls2"],
    }
    if cfg.qk_normalization:
        out["q_norm"] = {"weight": sd[lp + "attn.q_norm.weight"]}
        out["k_norm"] = {"weight": sd[lp + "attn.k_norm.weight"]}
    return _flat(out)


def convert_intern_vit(sd: Mapping[str, Tensor], cfg,
                       prefix: str = "") -> Dict[str, Tensor]:
    """InternVisionModel state dict -> `InternVisionTower` state dict.
    With `cfg.num_layers` 0 it converts the embeddings alone.
    cfg: VisionEncoderConfig."""
    p = prefix
    return _flat({
        "patch_embedding": _conv2d(sd, p + "embeddings.patch_embedding"),
        "class_embedding": sd[p + "embeddings.class_embedding"].reshape(
            1, 1, -1),
        "position_embedding": sd[p + "embeddings.position_embedding"],
        "layers": _stack(cfg.num_layers, lambda i: convert_intern_vit_layer(
            sd, cfg, i, prefix)),
    })


# ---------------------------------------------------------------------------
# composite checkpoint assembly
# ---------------------------------------------------------------------------

def convert_vl_bridge(sd: Mapping[str, Tensor],
                      prefix: str = "vl_bridge.") -> Dict[str, Tensor]:
    """torch Sequential Linear/GELU bridge (and `internvl_mlp`'s leading
    LayerNorm) -> `VLBridge` state dict, modules named by their
    Sequential index."""
    out: Dict = {}
    i = 0
    while f"{prefix}{i}.weight" in sd:
        w = sd[f"{prefix}{i}.weight"]
        entry = {"weight": w if w.dim() == 1 else _t(w)}   # 1-D: LayerNorm
        if f"{prefix}{i}.bias" in sd:
            entry["bias"] = sd[f"{prefix}{i}.bias"]
        out[str(i)] = entry
        i += 1
        while (f"{prefix}{i}.weight" not in sd
               and i < 32):                # skip activation slots
            i += 1
    return _flat(out)


def convert_region_encoder(sd: Mapping[str, Tensor],
                           prefix: str = "region_encoder."
                           ) -> Dict[str, Tensor]:
    """Reference RegionEncoder (region_encoder.py:68-146) -> the port's
    `RegionEncoder` (conv stem indices 0/1/3/4/6 + up_dim)."""
    p = prefix + "mask_embedding."
    return _flat({
        "stem_conv0": _conv2d(sd, p + "0"),
        "stem_norm0": _norm(sd, p + "1"),
        "stem_conv1": _conv2d(sd, p + "3"),
        "stem_norm1": _norm(sd, p + "4"),
        "stem_conv2": _conv2d(sd, p + "6"),
        "up_dim": _lin(sd, prefix + "up_dim"),
    })


def convert_composite_core(sd: Mapping[str, Tensor], cfg
                           ) -> Dict[str, Tensor]:
    """Released VisionLLMv2 checkpoint (flat HF state dict) -> the state
    dict of the `core` (`VisionLLM`). cfg: VisionLLMConfig.

    Key prefixes in the reference checkpoint (modeling_visionllmv2.py
    attribute names): vis_encoder / vl_bridge / llm / emb_embeddings_* /
    region_encoder.
    """
    if cfg.vis_encoder.arch == "intern_vit":
        # InternVisionModel keeps embeddings/encoder at the top level (no
        # .vision_model wrapper like CLIPVisionModel)
        vis = convert_intern_vit(sd, cfg.vis_encoder, prefix="vis_encoder.")
    else:
        vis = convert_clip_vit(sd, cfg.vis_encoder,
                               prefix="vis_encoder.vision_model.")
    if cfg.llm.arch == "internlm2":
        llm = convert_internlm2(sd, cfg.llm, prefix="llm.model.")
    else:
        llm = convert_llama(sd, cfg.llm, prefix="llm.model.")
    out: Dict = {"vis_encoder": vis, "vl_bridge": convert_vl_bridge(sd),
                 "llm": llm}
    for name in ("emb_embeddings_det", "emb_embeddings_pose",
                 "emb_embeddings_gen", "emb_embeddings_edit"):
        key = f"{name}.weight"
        if key in sd:
            out[name] = sd[key]
    if cfg.use_region_encoder and "region_encoder.up_dim.weight" in sd:
        out["region_encoder"] = convert_region_encoder(sd)
    return _flat(out)


def convert_composite(sd: Mapping[str, Tensor], cfg) -> Dict[str, Tensor]:
    """Full released-checkpoint conversion: flat VisionLLMv2 state dict
    -> `VisionLLMWithTools` state dict (core + gdino + unipose + sd +
    ip2p). cfg: VisionLLMConfig."""
    out: Dict = {"core": convert_composite_core(sd, cfg)}
    if cfg.use_gdino and any(k.startswith("gdino.") for k in sd):
        from visionllm_tpu_torch.utils.convert_gdino import convert_gdino
        out["gdino"] = convert_gdino(sd, cfg.gdino, prefix="gdino.")
    if cfg.use_unipose and any(k.startswith("unipose.") for k in sd):
        from visionllm_tpu_torch.utils.convert_unipose import convert_unipose
        out["unipose"] = convert_unipose(sd, cfg.unipose,
                                         prefix="unipose.")
    for tool, c in (("sd", cfg.sd if cfg.use_sd else None),
                    ("ip2p", cfg.ip2p if cfg.use_ip2p else None)):
        if c is None or not any(k.startswith(tool + ".") for k in sd):
            continue
        from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
            unet_cfg_for, vae_cfg_for)
        from visionllm_tpu_torch.utils.convert_sd import (convert_unet,
                                                          convert_vae)
        out[tool] = {
            "unet": convert_unet(sd, unet_cfg_for(
                c.sample_size, c.in_channels, c.cross_attention_dim),
                prefix=f"{tool}.sd_unet."),
            "vae": convert_vae(sd, vae_cfg_for(c.sample_size),
                               prefix=f"{tool}.sd_vae."),
            "mapper": convert_llm2sd_mapper(sd, prefix=f"{tool}."),
        }
    return _flat(out)


def _mha(sd: Mapping[str, Tensor], name: str) -> Dict:
    """torch `nn.MultiheadAttention` -> the port's q/k/v/out projections
    (the packed `in_proj_weight` / `in_proj_bias` split in three)."""
    w, b = sd[name + ".in_proj_weight"], sd[name + ".in_proj_bias"]
    d = w.shape[0] // 3
    return {"q_proj": {"weight": w[:d], "bias": b[:d]},
            "k_proj": {"weight": w[d:2 * d], "bias": b[d:2 * d]},
            "v_proj": {"weight": w[2 * d:], "bias": b[2 * d:]},
            "out_proj": _lin(sd, name + ".out_proj")}


def convert_llm2sd_mapper(sd: Mapping[str, Tensor],
                          prefix: str = "sd.") -> Dict[str, Tensor]:
    """emb_proj + llm2sd_mapper (torch nn.Transformer) -> `LLM2SDMapper`
    state dict (modeling_sd.py:70-84 naming)."""
    p = prefix
    enc = p + "llm2sd_mapper.encoder.layers.0"
    dec = p + "llm2sd_mapper.decoder.layers.0"
    return _flat({
        "emb_proj_0": _lin(sd, p + "emb_proj.0"),
        "emb_proj_2": _lin(sd, p + "emb_proj.2"),
        "mapper_queries": sd[p + "llm2sd_mapper_queries"],
        "encoder_0": {"norm1": _norm(sd, enc + ".norm1"),
                      "self_attn": _mha(sd, enc + ".self_attn"),
                      "norm2": _norm(sd, enc + ".norm2"),
                      "linear1": _lin(sd, enc + ".linear1"),
                      "linear2": _lin(sd, enc + ".linear2")},
        "encoder_norm": _norm(sd, p + "llm2sd_mapper.encoder.norm"),
        "decoder_0": {"norm1": _norm(sd, dec + ".norm1"),
                      "self_attn": _mha(sd, dec + ".self_attn"),
                      "norm_mem": _norm(sd, dec + ".norm2"),
                      "cross_attn": _mha(sd,
                                                  dec + ".multihead_attn"),
                      "norm2": _norm(sd, dec + ".norm3"),
                      "linear1": _lin(sd, dec + ".linear1"),
                      "linear2": _lin(sd, dec + ".linear2")},
        "decoder_norm": _norm(sd, p + "llm2sd_mapper.decoder.norm"),
    })


# ---------------------------------------------------------------------------
# reading checkpoint files, unread keys, filling a model
# ---------------------------------------------------------------------------

# safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2}


def read_safetensors(path: str) -> Dict[str, Tensor]:
    """One `.safetensors` file as CPU tensors over a private memory map
    (nothing is read until a tensor is used; writes to a tensor do not
    reach the file). The format: an 8-byte little-endian header length,
    a JSON header {name: {dtype, shape, data_offsets}}, then the raw
    little-endian bytes, offsets counted from the end of the header."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size else b""
    base = 8 + n
    out: Dict[str, Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = (end - begin) // dtype.itemsize
        if count != torch.Size(shape).numel() or base + end > size:
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do "
                             f"not hold {info['dtype']} {list(shape)}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=base + begin).view(shape)
    return out


def load_state_dict_files(path: str) -> Dict[str, Tensor]:
    """Load a checkpoint directory or file into one flat dict of CPU
    tensors in their stored dtypes: HF sharded safetensors
    (model-*.safetensors, checked against `model.safetensors.index.json`
    where there is one), a single safetensors file, and torch .bin / .pth
    files (`torch.load(weights_only=True, mmap=True)`; a `state_dict`
    entry is unwrapped)."""
    if os.path.isdir(path):
        files = (sorted(glob.glob(os.path.join(path, "*.safetensors")))
                 or sorted(glob.glob(os.path.join(path, "*.bin")))
                 or sorted(glob.glob(os.path.join(path, "*.pth"))))
        if not files:
            raise FileNotFoundError(f"{path}: no .safetensors, .bin or "
                                    ".pth file")
    else:
        files = [path]
    sd: Dict[str, Tensor] = {}
    for f in files:
        if f.endswith(".safetensors"):
            sd.update(read_safetensors(f))
        else:
            raw = torch.load(f, map_location="cpu", weights_only=True,
                             mmap=True)
            sd.update(raw.get("state_dict", raw))
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.isdir(path) and os.path.exists(index):
        with open(index) as f:
            want = set(json.load(f)["weight_map"])
        if want != set(sd):
            raise ValueError(f"{index}: the shards hold "
                             f"{sorted(set(sd) ^ want)[:10]} against the "
                             "index")
    return sd


def allowlisted(key: str) -> bool:
    """Keys of the released checkpoint that no converter reads, each
    safe to drop (the JAX package's documented allowlist,
    `tests/test_convert_composite_fullscale.py`):

    * window-attention index tables, which the port computes from the
      static geometry (it holds no buffer for them);
    * the frozen SD / IP2P CLIP text encoder (`.sd_text_encoder.`), used
      only to embed captions, which the standalone `ClipTextModel`
      (`convert_clip_text`) does;
    * CLIP's `post_layernorm`, which feeds only the pooled projection
      head, never the hidden state the composite reads.
    """
    return (key.endswith("relative_position_index")
            or key.endswith("relative_coords_table")
            or ".sd_text_encoder." in key
            or (key.startswith("vis_encoder.") and ".post_layernorm." in key))


class ReadRecorder(Mapping):
    """A read-only view of a state dict that records the keys read
    through `[]` (`in`, `keys()` and iteration record nothing). Convert
    through it, then `unread()` lists what the converter left."""

    def __init__(self, sd: Mapping[str, Tensor]):
        self._sd = sd
        self.read = set()

    def __getitem__(self, key: str) -> Tensor:
        val = self._sd[key]
        self.read.add(key)
        return val

    def __contains__(self, key) -> bool:
        return key in self._sd

    def __iter__(self) -> Iterator[str]:
        return iter(self._sd)

    def __len__(self) -> int:
        return len(self._sd)

    def keys(self):
        return self._sd.keys()

    def unread(self, allowed: Callable[[str], bool] = allowlisted
               ) -> List[str]:
        """Sorted keys never read, leaving out those `allowed` accepts."""
        return sorted(k for k in self._sd
                      if k not in self.read and not allowed(k))


@torch.no_grad()
def load_converted(model: nn.Module, state: Mapping[str, Tensor],
                   device: Optional[torch.device] = None) -> nn.Module:
    """Fill `model`, laid out on the meta device (shapes, dtypes and
    strides, no storage), from a converted state dict: each tensor goes
    to `device` in its parameter's dtype (the `fp32_modules` get fp32
    from a bf16 checkpoint) and strides (the UNet's channels_last convs),
    with no copy where it already has them, then
    `load_state_dict(strict=True, assign=True)`. Raises before moving
    anything on a missing or unexpected key or a shape mismatch."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    bad = [(k, tuple(state[k].shape), tuple(own[k].shape)) for k in own
           if k in state and state[k].shape != own[k].shape]
    if missing or unexpected or bad:
        raise KeyError(f"the state dict does not fit the model: missing "
                       f"{missing[:10]}, unexpected {unexpected[:10]}, "
                       f"shapes {bad[:10]}")
    device = torch.empty(0, device=device).device    # cuda -> cuda:0
    placed = {}
    for name, p in own.items():
        t = state[name]
        if (t.device != device or t.dtype != p.dtype
                or t.stride() != p.stride()):
            t = torch.empty_strided(p.shape, p.stride(), dtype=p.dtype,
                                    device=device).copy_(t)
        placed[name] = t
    model.load_state_dict(placed, strict=True, assign=True)
    return model
