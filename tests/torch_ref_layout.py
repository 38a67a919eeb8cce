"""Write a port model's weights under the reference checkpoint's key
names: the inverse of `visionllm_tpu_torch/utils/torch_convert.py` and
its tool converters, for tests and `chip_smoke.py`.

Every writer takes a port state dict (keys as `module.state_dict()`
gives them, relative to the module) and returns the reference's flat
state dict as copies, each with storage of its own, contiguous, as a
saved checkpoint holds it: renames are cloned, and q / k / v are packed
back into `in_proj_weight`, InternLM2's per-group `wqkv` and the
vendored Swin's `qkv`. `write_composite` adds what a released
VisionLLMv2 checkpoint also holds: the tied aliases of the shared
prediction heads (copies of the kept head), the window-attention index
buffers, CLIP's `post_layernorm` and the frozen SD-1.5 text encoders
(CLIP-L's text model, as zero-stride zeros: no converter reads them).

The JAX package has no exporter, so this stays with the tests; it
imports neither JAX nor transformers nor another test module
(`chip_smoke.py` loads it by path and runs it on the card) and is held
against the JAX converters on the CPU (`tests/test_torch_convert.py`).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import torch

Tensor = torch.Tensor

_LLAMA = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
          "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
          "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
          "down_proj": "mlp.down_proj",
          "input_layernorm": "input_layernorm",
          "post_attention_layernorm": "post_attention_layernorm"}
_CLIP = {"layer_norm1": "layer_norm1", "layer_norm2": "layer_norm2",
         "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
         "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
         "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
_HF_SWIN = {"layernorm_before": "layernorm_before",
            "layernorm_after": "layernorm_after",
            "query": "attention.self.query", "key": "attention.self.key",
            "value": "attention.self.value",
            "proj": "attention.output.dense", "fc1": "intermediate.dense",
            "fc2": "output.dense"}
_INTERNLM2 = {"o_proj": "attention.wo", "gate_proj": "feed_forward.w1",
              "up_proj": "feed_forward.w3", "down_proj": "feed_forward.w2",
              "input_layernorm": "attention_norm",
              "post_attention_layernorm": "ffn_norm"}
_INTERN_VIT = {"norm1": "norm1", "norm2": "norm2", "qkv": "attn.qkv",
               "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
               "q_norm": "attn.q_norm", "k_norm": "attn.k_norm"}
_FUSION = {"layer_norm_vision": "layer_norm_vision",
           "layer_norm_text": "layer_norm_text",
           **{f"attn.{k}": f"attn.{k}" for k in (
               "vision_proj", "text_proj", "values_vision_proj",
               "values_text_proj", "out_vision_proj", "out_text_proj")}}
_DEFORMABLE = ("sampling_offsets", "attention_weights", "value_proj",
               "output_proj")


def _c(t: Tensor) -> Tensor:
    """A copy with storage of its own, contiguous."""
    return t.clone(memory_format=torch.contiguous_format)


def _sub(state: Mapping[str, Tensor], prefix: str) -> Dict[str, Tensor]:
    """The entries under `prefix`, with it stripped."""
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def _mod(out, state, ours: str, theirs: str):
    """Module `ours`'s weight and bias (where it has one) as `theirs`."""
    out[theirs + ".weight"] = _c(state[ours + ".weight"])
    if ours + ".bias" in state:
        out[theirs + ".bias"] = _c(state[ours + ".bias"])


def _mods(out, state, ours: str, theirs: str, names: Mapping[str, str]):
    for a, b in names.items():
        if f"{ours}{a}.weight" in state:
            _mod(out, state, ours + a, theirs + b)


def _pack(out, state, ours: str, theirs: str, parts=("q_proj", "k_proj",
                                                      "v_proj")):
    """Separate projections packed back along the output rows."""
    out[theirs + "weight"] = torch.cat(
        [state[f"{ours}{p}.weight"] for p in parts], 0)
    out[theirs + "bias"] = torch.cat(
        [state[f"{ours}{p}.bias"] for p in parts], 0)


def _mha(out, state, ours: str, theirs: str):
    """q / k / v / out_proj -> torch `nn.MultiheadAttention`."""
    _pack(out, state, ours + ".", theirs + ".in_proj_")
    _mod(out, state, ours + ".out_proj", theirs + ".out_proj")


def _mlp(out, state, ours: str, theirs: str):
    i = 0
    while f"{ours}.layers_{i}.weight" in state:
        _mod(out, state, f"{ours}.layers_{i}", f"{theirs}.layers.{i}")
        i += 1


def _deformable(out, state, ours: str, theirs: str):
    for k in _DEFORMABLE:
        _mod(out, state, f"{ours}.{k}", f"{theirs}.{k}")


def _index(window: int, dtype=torch.int64) -> Tensor:
    """A window-attention `relative_position_index` buffer's shape; no
    converter reads it."""
    return torch.zeros((), dtype=dtype).expand(window ** 2, window ** 2)


# ---------------------------------------------------------------------------
# the language models and the vision towers
# ---------------------------------------------------------------------------

def write_llama(state, cfg, prefix: str = "model.") -> Dict[str, Tensor]:
    """`LlamaModel` -> HF LlamaForCausalLM (`prefix` holds the decoder)."""
    out = {prefix + "embed_tokens.weight": _c(state["embed_tokens.weight"])}
    for i in range(cfg.num_layers):
        _mods(out, state, f"layers.{i}.", f"{prefix}layers.{i}.", _LLAMA)
    _mod(out, state, "norm", prefix + "norm")
    _mod(out, state, "lm_head", prefix.rsplit("model.", 1)[0] + "lm_head")
    return out


def write_clip_vit(state, cfg, prefix: str = "vision_model."
                   ) -> Dict[str, Tensor]:
    """`ClipVisionTower` -> HF CLIPVisionModel."""
    e = prefix + "embeddings."
    out = {e + "patch_embedding.weight": _c(state["patch_embedding.weight"]),
           e + "class_embedding": _c(state["class_embedding"].reshape(-1)),
           e + "position_embedding.weight": _c(
               state["position_embedding.weight"])}
    _mod(out, state, "pre_layrnorm", prefix + "pre_layrnorm")
    for i in range(cfg.num_layers):
        _mods(out, state, f"layers.{i}.", f"{prefix}encoder.layers.{i}.",
              _CLIP)
    return out


def write_swin(state, cfg, prefix: str = "") -> Dict[str, Tensor]:
    """`SwinBackbone` -> HF SwinBackbone (with its index buffers)."""
    out = {}
    _mod(out, state, "patch_embed",
         prefix + "embeddings.patch_embeddings.projection")
    _mod(out, state, "patch_norm", prefix + "embeddings.norm")
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            ours, lp = f"stage{s}_block{b}.", \
                prefix + f"encoder.layers.{s}.blocks.{b}."
            _mods(out, state, ours, lp, _HF_SWIN)
            out[lp + "attention.self.relative_position_bias_table"] = _c(
                state[ours + "relative_position_bias_table"])
            out[lp + "attention.self.relative_position_index"] = _index(
                cfg.window_size)
        if s < cfg.num_stages - 1:
            dp = prefix + f"encoder.layers.{s}.downsample."
            _mod(out, state, f"downsample{s}.norm", dp + "norm")
            _mod(out, state, f"downsample{s}.reduction", dp + "reduction")
    for s in cfg.out_stages:
        _mod(out, state, f"out_norm{s}",
             prefix + f"hidden_states_norms.stage{s + 1}")
    return out


def write_vendored_swin(state, cfg, prefix: str) -> Dict[str, Tensor]:
    """`SwinBackbone` -> UniPose's vendored SwinTransformer (packed
    qkv, with its index buffers)."""
    out = {}
    _mod(out, state, "patch_embed", prefix + "patch_embed.proj")
    _mod(out, state, "patch_norm", prefix + "patch_embed.norm")
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            ours, lp = f"stage{s}_block{b}.", \
                prefix + f"layers.{s}.blocks.{b}."
            _mods(out, state, ours, lp, {
                "layernorm_before": "norm1", "layernorm_after": "norm2",
                "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"})
            _pack(out, state, ours, lp + "attn.qkv.",
                  ("query", "key", "value"))
            out[lp + "attn.relative_position_bias_table"] = _c(
                state[ours + "relative_position_bias_table"])
            out[lp + "attn.relative_position_index"] = _index(
                cfg.window_size)
        if s < cfg.num_stages - 1:
            dp = prefix + f"layers.{s}.downsample."
            _mod(out, state, f"downsample{s}.norm", dp + "norm")
            _mod(out, state, f"downsample{s}.reduction", dp + "reduction")
    for s in cfg.out_stages:
        _mod(out, state, f"out_norm{s}", prefix + f"norm{s}")
    return out


def write_internlm2_layer(state, cfg, i: int, prefix: str = "model."
                          ) -> Dict[str, Tensor]:
    """One `LlamaDecoderLayer` (keys relative to it) -> InternLM2's
    layer `i`, q / k / v packed per kv-head group as [q·ratio, k, v]."""
    h, h_kv, d, hid = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.hidden_size)
    lp = f"{prefix}layers.{i}."
    out = {lp + "attention.wqkv.weight": torch.cat([
        state["q_proj.weight"].reshape(h_kv, h // h_kv, d, hid),
        state["k_proj.weight"].reshape(h_kv, 1, d, hid),
        state["v_proj.weight"].reshape(h_kv, 1, d, hid)], 1).reshape(-1, hid)}
    _mods(out, state, "", lp, _INTERNLM2)
    return out


def write_internlm2(state, cfg, prefix: str = "model.") -> Dict[str, Tensor]:
    """`LlamaModel` (GQA) -> InternLM2ForCausalLM."""
    out = {prefix + "tok_embeddings.weight": _c(state["embed_tokens.weight"])}
    for i in range(cfg.num_layers):
        out.update(write_internlm2_layer(_sub(state, f"layers.{i}."), cfg, i,
                                         prefix))
    _mod(out, state, "norm", prefix + "norm")
    _mod(out, state, "lm_head", prefix.rsplit("model.", 1)[0] + "output")
    return out


def write_intern_vit_layer(state, cfg, i: int, prefix: str = ""
                           ) -> Dict[str, Tensor]:
    """One `InternVitLayer` (keys relative to it) -> InternVisionModel's
    layer `i`."""
    lp = f"{prefix}encoder.layers.{i}."
    out = {lp + "ls1": _c(state["ls1"]), lp + "ls2": _c(state["ls2"])}
    _mods(out, state, "", lp, _INTERN_VIT)
    return out


def write_intern_vit(state, cfg, prefix: str = "") -> Dict[str, Tensor]:
    """`InternVisionTower` -> InternVisionModel."""
    e = prefix + "embeddings."
    out = {e + "class_embedding": _c(state["class_embedding"]),
           e + "position_embedding": _c(state["position_embedding"])}
    _mod(out, state, "patch_embedding", e + "patch_embedding")
    for i in range(cfg.num_layers):
        out.update(write_intern_vit_layer(_sub(state, f"layers.{i}."), cfg,
                                          i, prefix))
    return out


def write_vl_bridge(state, prefix: str = "vl_bridge.") -> Dict[str, Tensor]:
    """`VLBridge` -> the torch Sequential (its indices are the port's)."""
    return {prefix + k: _c(v) for k, v in state.items()}


def write_region_encoder(state, prefix: str = "region_encoder."
                         ) -> Dict[str, Tensor]:
    out = {}
    for ours, idx in (("stem_conv0", 0), ("stem_norm0", 1),
                      ("stem_conv1", 3), ("stem_norm1", 4),
                      ("stem_conv2", 6)):
        _mod(out, state, ours, f"{prefix}mask_embedding.{idx}")
    _mod(out, state, "up_dim", prefix + "up_dim")
    return out


def write_llm2sd_mapper(state, prefix: str = "sd.") -> Dict[str, Tensor]:
    """`LLM2SDMapper` -> emb_proj + the nn.Transformer mapper."""
    out = {prefix + "llm2sd_mapper_queries": _c(state["mapper_queries"])}
    _mod(out, state, "emb_proj_0", prefix + "emb_proj.0")
    _mod(out, state, "emb_proj_2", prefix + "emb_proj.2")
    m = prefix + "llm2sd_mapper."
    enc, dec = m + "encoder.layers.0.", m + "decoder.layers.0."
    _mods(out, state, "encoder_0.", enc, {
        "norm1": "norm1", "norm2": "norm2", "linear1": "linear1",
        "linear2": "linear2"})
    _mha(out, state, "encoder_0.self_attn", enc + "self_attn")
    _mod(out, state, "encoder_norm", m + "encoder.norm")
    _mods(out, state, "decoder_0.", dec, {
        "norm1": "norm1", "norm_mem": "norm2", "norm2": "norm3",
        "linear1": "linear1", "linear2": "linear2"})
    _mha(out, state, "decoder_0.self_attn", dec + "self_attn")
    _mha(out, state, "decoder_0.cross_attn", dec + "multihead_attn")
    _mod(out, state, "decoder_norm", m + "decoder.norm")
    return out


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def _tied(out, canonical: str, aliases, n: int):
    """Copies of the kept head `canonical` under every slot 0..n-1 of each
    alias base, as torch serializes one module referenced n times."""
    head = {k[len(canonical):]: v for k, v in out.items()
            if k.startswith(canonical + ".")}
    for base in aliases:
        for i in range(n):
            if f"{base}.{i}" != canonical:
                out.update({f"{base}.{i}{s}": _c(v) for s, v in head.items()})


def write_gdino(state, cfg, swin_cfg, prefix: str = ""
                ) -> Dict[str, Tensor]:
    """`GroundingDino` -> OVGroundingDinoForObjectDetection, with the
    shared heads' tied copies (one a decoder layer, in the ModuleList and
    on the decoder)."""
    p, m = prefix, prefix + "model."
    out = write_swin(_sub(state, "backbone."), swin_cfg,
                     m + "backbone.conv_encoder.model.")
    for i in range(4):
        _mod(out, state, f"input_proj_{i}", m + f"input_proj_vision.{i}.0")
        _mod(out, state, f"input_proj_norm_{i}",
             m + f"input_proj_vision.{i}.1")
    for i in range(cfg.encoder_layers):
        ours, lp = f"encoder_layer_{i}.", m + f"encoder.layers.{i}."
        _mods(out, state, ours + "fusion_layer.", lp + "fusion_layer.",
              _FUSION)
        for k in ("vision_param", "text_param"):
            out[lp + "fusion_layer." + k] = _c(
                state[ours + "fusion_layer." + k])
        te, de = ours + "text_enhancer_layer", ours + "deformable_layer"
        _mha(out, state, te + ".self_attn", lp + "text_enhancer_layer"
             ".self_attn")
        _mods(out, state, te + ".", lp + "text_enhancer_layer.", {
            k: k for k in ("layer_norm_before", "layer_norm_after", "fc1",
                           "fc2")})
        _deformable(out, state, de + ".self_attn",
                    lp + "deformable_layer.self_attn")
        _mods(out, state, de + ".", lp + "deformable_layer.", {
            k: k for k in ("self_attn_layer_norm", "fc1", "fc2",
                           "final_layer_norm")})
    for i in range(cfg.decoder_layers):
        ours, lp = f"decoder_layer_{i}.", m + f"decoder.layers.{i}."
        _mha(out, state, ours + "self_attn", lp + "self_attn")
        _mha(out, state, ours + "encoder_attn_text", lp + "encoder_attn_text")
        _deformable(out, state, ours + "encoder_attn", lp + "encoder_attn")
        _mods(out, state, ours, lp, {k: k for k in (
            "self_attn_layer_norm", "encoder_attn_text_layer_norm",
            "encoder_attn_layer_norm", "fc1", "fc2", "final_layer_norm")})
    _mod(out, state, "decoder_layer_norm", m + "decoder.layer_norm")
    _mlp(out, state, "reference_points_head",
         m + "decoder.reference_points_head")
    _mod(out, state, "enc_output", m + "enc_output")
    _mod(out, state, "enc_output_norm", m + "enc_output_norm")
    _mlp(out, state, "encoder_output_bbox_embed",
         m + "encoder_output_bbox_embed")
    out[m + "query_position_embeddings.weight"] = _c(
        state["query_position_embeddings"])
    out[m + "level_embed"] = _c(state["level_embed"])
    _mod(out, state, "lateral_conv", m + "lateral_convs.0")
    _mod(out, state, "lateral_norm", m + "lateral_convs.0.norm")
    _mod(out, state, "output_conv", m + "output_convs.0")
    _mod(out, state, "output_norm", m + "output_convs.0.norm")
    _mod(out, state, "mask_features", m + "mask_features")
    _mlp(out, state, "model_mask_embed", m + "mask_embed")
    _mlp(out, state, "bbox_embed", p + "bbox_embed.0")
    _mlp(out, state, "mask_embed", p + "mask_embed.0")
    _mlp(out, state, "patch2query", p + "patch2query")
    _tied(out, p + "bbox_embed.0", (p + "bbox_embed",
                                    m + "decoder.bbox_embed"),
          cfg.decoder_layers)
    _tied(out, p + "mask_embed.0", (p + "mask_embed",), cfg.decoder_layers)
    return out


def write_unipose(state, cfg, swin_cfg, prefix: str = ""
                  ) -> Dict[str, Tensor]:
    """`UniPose` -> the reference UniPose, with the shared heads' tied
    copies."""
    p, t = prefix, prefix + "transformer."
    out = write_vendored_swin(_sub(state, "backbone."), swin_cfg,
                              p + "backbone.0.")
    for i in range(4):
        _mod(out, state, f"input_proj_{i}", p + f"input_proj.{i}.0")
        _mod(out, state, f"input_proj_norm_{i}", p + f"input_proj.{i}.1")
    _mlp(out, state, "projection_llava", p + "projection_llava")
    _mlp(out, state, "projection_kpt_llava", p + "projection_kpt_llava")
    for i in range(cfg.encoder_layers):
        ours = f"encoder_layer_{i}."
        fl, fo = t + f"encoder.fusion_layers.{i}.", ours + "fusion_layer."
        _mods(out, state, fo, fl, {
            "layer_norm_vision": "layer_norm_v",
            "layer_norm_text": "layer_norm_l",
            "attn.vision_proj": "attn.v_proj",
            "attn.text_proj": "attn.l_proj",
            "attn.values_vision_proj": "attn.values_v_proj",
            "attn.values_text_proj": "attn.values_l_proj",
            "attn.out_vision_proj": "attn.out_v_proj",
            "attn.out_text_proj": "attn.out_l_proj"})
        out[fl + "gam_v"] = _c(state[fo + "vision_param"])
        out[fl + "gam_l"] = _c(state[fo + "text_param"])
        tl, to = t + f"encoder.text_layers.{i}.", ours + "text_layer."
        _mha(out, state, to + "self_attn", tl + "self_attn")
        _mods(out, state, to, tl, {k: k for k in (
            "norm1", "norm2", "linear1", "linear2")})
        lp, do = t + f"encoder.layers.{i}.", ours + "deformable_layer."
        _deformable(out, state, do + "self_attn", lp + "self_attn")
        _mods(out, state, do, lp, {
            "self_attn_layer_norm": "norm1", "fc1": "linear1",
            "fc2": "linear2", "final_layer_norm": "norm2"})
    for i in range(cfg.decoder_layers):
        ours, lp = f"decoder_layer_{i}.", t + f"decoder.layers.{i}."
        _mha(out, state, ours + "self_attn", lp + "self_attn")
        _mha(out, state, ours + "ca_text", lp + "ca_text")
        _deformable(out, state, ours + "cross_attn", lp + "cross_attn")
        _mods(out, state, ours, lp, {k: k for k in (
            "norm1", "norm2", "norm3", "catext_norm", "linear1", "linear2")})
    _mod(out, state, "decoder_norm", t + "decoder.norm")
    _mlp(out, state, "ref_point_head", t + "decoder.ref_point_head")
    out[t + "level_embed"] = _c(state["level_embed"])
    out[t + "tgt_embed.weight"] = _c(state["tgt_embed"])
    _mod(out, state, "enc_output", t + "enc_output")
    _mod(out, state, "enc_output_norm", t + "enc_output_norm")
    _mlp(out, state, "enc_out_bbox_embed", t + "enc_out_bbox_embed")
    for head in ("bbox_embed", "pose_embed", "pose_hw_embed"):
        _mlp(out, state, head, p + head + ".0")
        _tied(out, p + head + ".0", (p + head, t + "decoder." + head),
              cfg.decoder_layers)
    out[t + "decoder.hw.weight"] = _c(state["hw"])
    if "hw_append" in state:
        out[t + "decoder.hw_append.weight"] = _c(state["hw_append"])
    return out


def _resnet(out, state, ours: str, theirs: str):
    _mods(out, state, ours + ".", theirs + ".", {k: k for k in (
        "norm1", "conv1", "time_emb_proj", "norm2", "conv2",
        "conv_shortcut")})


def _attn_block(out, state, ours: str, theirs: str):
    b, tb = ours + ".block_0.", theirs + ".transformer_blocks.0."
    _mods(out, state, ours + ".", theirs + ".", {
        "norm": "norm", "proj_in": "proj_in", "proj_out": "proj_out"})
    _mods(out, state, b, tb, {
        "norm1": "norm1", "norm2": "norm2", "norm3": "norm3",
        "ff_geglu.proj": "ff.net.0.proj", "ff_out": "ff.net.2",
        **{f"{a}.{q}": f"{a}.{q}" for a in ("attn1", "attn2")
           for q in ("to_q", "to_k", "to_v")},
        "attn1.to_out": "attn1.to_out.0", "attn2.to_out": "attn2.to_out.0"})


def write_unet(state, cfg, prefix: str = "") -> Dict[str, Tensor]:
    """`UNet2DCondition` -> diffusers UNet2DConditionModel."""
    p, out = prefix, {}
    _mods(out, state, "", p, {
        "conv_in": "conv_in", "time_dense1": "time_embedding.linear_1",
        "time_dense2": "time_embedding.linear_2",
        "conv_norm_out": "conv_norm_out", "conv_out": "conv_out"})
    n = len(cfg.block_out_channels)
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _resnet(out, state, f"down_{i}_res_{j}",
                    p + f"down_blocks.{i}.resnets.{j}")
            if cfg.cross_attn_blocks[i]:
                _attn_block(out, state, f"down_{i}_attn_{j}",
                            p + f"down_blocks.{i}.attentions.{j}")
        if i < n - 1:
            _mod(out, state, f"down_{i}_downsample",
                 p + f"down_blocks.{i}.downsamplers.0.conv")
    _resnet(out, state, "mid_res_0", p + "mid_block.resnets.0")
    _attn_block(out, state, "mid_attn", p + "mid_block.attentions.0")
    _resnet(out, state, "mid_res_1", p + "mid_block.resnets.1")
    rev = tuple(reversed(cfg.cross_attn_blocks))
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _resnet(out, state, f"up_{i}_res_{j}",
                    p + f"up_blocks.{i}.resnets.{j}")
            if rev[i]:
                _attn_block(out, state, f"up_{i}_attn_{j}",
                            p + f"up_blocks.{i}.attentions.{j}")
        if i < n - 1:
            _mod(out, state, f"up_{i}_upsample",
                 p + f"up_blocks.{i}.upsamplers.0.conv")
    return out


def write_vae(state, cfg, prefix: str = "") -> Dict[str, Tensor]:
    """`AutoencoderKL` -> diffusers AutoencoderKL."""
    p, out = prefix, {}
    n = len(cfg.block_out_channels)
    for part in ("encoder", "decoder"):
        o, t = part + ".", p + part + "."
        _mods(out, state, o, t, {k: k for k in (
            "conv_in", "conv_norm_out", "conv_out")})
        for k in ("mid_res_0", "mid_res_1"):
            _resnet(out, state, o + k, t + "mid_block.resnets." + k[-1])
        _mods(out, state, o + "mid_attn.", t + "mid_block.attentions.0.", {
            "group_norm": "group_norm", "to_q": "to_q", "to_k": "to_k",
            "to_v": "to_v", "to_out": "to_out.0"})
        down = part == "encoder"
        for i in range(n):
            blk = f"{t}{'down' if down else 'up'}_blocks.{i}."
            for j in range(cfg.layers_per_block + (0 if down else 1)):
                _resnet(out, state, f"{o}{'down' if down else 'up'}_{i}_res_"
                        f"{j}", f"{blk}resnets.{j}")
            if i < n - 1:
                sample = "downsample" if down else "upsample"
                _mod(out, state, f"{o}{'down' if down else 'up'}_{i}_{sample}",
                     f"{blk}{sample}rs.0.conv")
    _mod(out, state, "quant_conv", p + "quant_conv")
    _mod(out, state, "post_quant_conv", p + "post_quant_conv")
    return out


def write_clip_text(state, prefix: str = "text_model.") -> Dict[str, Tensor]:
    """`ClipTextModel` -> HF CLIPTextModel."""
    e, out = prefix + "embeddings.", {}
    _mod(out, state, "token_embedding", e + "token_embedding")
    _mod(out, state, "position_embedding", e + "position_embedding")
    _mod(out, state, "final_layer_norm", prefix + "final_layer_norm")
    i = 0
    while f"layer_{i}.layer_norm1.weight" in state:
        _mods(out, state, f"layer_{i}.", f"{prefix}encoder.layers.{i}.",
              _CLIP)
        i += 1
    return out


# ---------------------------------------------------------------------------
# the whole checkpoint
# ---------------------------------------------------------------------------

def write_core(state, cfg) -> Dict[str, Tensor]:
    """The `VisionLLM` core's state -> the released checkpoint's
    vis_encoder / vl_bridge / llm / emb_embeddings_* / region_encoder
    keys, CLIP's `post_layernorm` (ones and zeros) among them."""
    vis = _sub(state, "vis_encoder.")
    if cfg.vis_encoder.arch == "intern_vit":
        out = write_intern_vit(vis, cfg.vis_encoder, "vis_encoder.")
    else:
        out = write_clip_vit(vis, cfg.vis_encoder, "vis_encoder.vision_model.")
        ln = vis["pre_layrnorm.weight"]
        out["vis_encoder.vision_model.post_layernorm.weight"] = \
            torch.ones_like(ln)
        out["vis_encoder.vision_model.post_layernorm.bias"] = \
            torch.zeros_like(ln)
    out.update(write_vl_bridge(_sub(state, "vl_bridge.")))
    llm = _sub(state, "llm.")
    write = write_internlm2 if cfg.llm.arch == "internlm2" else write_llama
    out.update(write(llm, cfg.llm, "llm.model."))
    for name in ("emb_embeddings_det", "emb_embeddings_pose",
                 "emb_embeddings_gen", "emb_embeddings_edit"):
        if name in state:
            out[name + ".weight"] = _c(state[name])
    if any(k.startswith("region_encoder.") for k in state):
        out.update(write_region_encoder(_sub(state, "region_encoder.")))
    return out


def write_composite(state, cfg) -> Dict[str, Tensor]:
    """A `VisionLLMWithTools` state dict -> the released VisionLLMv2
    checkpoint: the core, gdino., unipose., and sd. / ip2p. (sd_unet,
    sd_vae, the mapper), with the tied head aliases, the index buffers,
    CLIP's `post_layernorm` and the SD text encoders' keys. The tools'
    backbones must be Swin (the reference's)."""
    from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
        unet_cfg_for, vae_cfg_for)
    from visionllm_tpu_torch.utils.convert_gdino import swin_preset

    out = write_core(_sub(state, "core."), cfg)
    if cfg.use_gdino:
        swin = swin_preset(cfg.gdino.backbone, (0, 1, 2, 3),
                           cfg.gdino.backbone_overrides)
        out.update(write_gdino(_sub(state, "gdino."), cfg.gdino, swin,
                               "gdino."))
    if cfg.use_unipose:
        swin = swin_preset(cfg.unipose.backbone, (1, 2, 3))
        out.update(write_unipose(_sub(state, "unipose."), cfg.unipose, swin,
                                 "unipose."))
    for tool, c in (("sd", cfg.sd if cfg.use_sd else None),
                    ("ip2p", cfg.ip2p if cfg.use_ip2p else None)):
        if c is None:
            continue
        head = _sub(state, tool + ".")
        out.update(write_unet(_sub(head, "unet."), unet_cfg_for(
            c.sample_size, c.in_channels, c.cross_attention_dim),
            f"{tool}.sd_unet."))
        out.update(write_vae(_sub(head, "vae."), vae_cfg_for(c.sample_size),
                             f"{tool}.sd_vae."))
        out.update(write_llm2sd_mapper(_sub(head, "mapper."), tool + "."))
        zero = torch.zeros((), dtype=head["mapper.mapper_queries"].dtype,
                           device=head["mapper.mapper_queries"].device)
        for k, shape in sd_text_encoder_keys().items():
            out[f"{tool}.sd_text_encoder.{k}"] = zero.expand(shape)
    return out


def sd_text_encoder_keys() -> Dict[str, tuple]:
    """The SD-1.5 text encoder's keys and shapes (HF CLIPTextModel of
    CLIP-L, `text_model.` ...): the port's `ClipTextModel` on the meta
    device, written out."""
    from visionllm_tpu_torch.models.stable_diffusion.clip_text import (
        ClipTextConfig, ClipTextModel)
    with torch.device("meta"):
        model = ClipTextModel(ClipTextConfig())
    return {k: tuple(v.shape) for k, v in
            write_clip_text(model.state_dict()).items()}


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

_ST_DTYPES = {torch.float64: "F64", torch.float32: "F32",
              torch.float16: "F16", torch.bfloat16: "BF16",
              torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
              torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def save_safetensors(sd: Mapping[str, Tensor], path: str) -> None:
    """Write `sd` in the safetensors format: an 8-byte little-endian
    header length, the JSON header (padded with spaces to 8 bytes), then
    each tensor's contiguous little-endian bytes in header order."""
    header, offset, blobs = {}, 0, []
    for name, t in sd.items():
        raw = t.detach().to("cpu").contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
