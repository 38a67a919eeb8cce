"""Stable-Diffusion-1.5 checkpoint converter (counterpart of
`visionllm_tpu/utils/convert_sd.py`): the diffusers key layout -> the
port's UNet, VAE and CLIP-text state dicts.

The reference loads "runwayml/stable-diffusion-v1-5" /
"timbrooks/instruct-pix2pix" through diffusers (modeling_sd.py:88-102);
this maps those state-dict names (down_blocks.N.resnets.M..., mid_block
..., up_blocks..., time_embedding, the VAE's encoder / decoder,
text_model.encoder.layers...) onto models/stable_diffusion/*. A
transformer block's `proj_in` / `proj_out` is a 1x1 conv in the port; a
checkpoint with `use_linear_projection` stores a Linear weight, which
becomes that conv's [out, in, 1, 1].
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from visionllm_tpu_torch.utils.torch_convert import _conv2d as _c
from visionllm_tpu_torch.utils.torch_convert import _flat, _lin, _norm, _t

Tensor = torch.Tensor


def _proj(sd, name):
    """A 1x1 conv, stored as a conv or (linear projection) as a Linear."""
    if sd[name + ".weight"].dim() == 4:
        return _c(sd, name)
    return {"weight": _t(sd[name + ".weight"])[:, :, None, None],
            "bias": sd[name + ".bias"]}


def _resnet(sd, p):
    out = {
        "norm1": _norm(sd, p + ".norm1"),
        "conv1": _c(sd, p + ".conv1"),
        "time_emb_proj": _lin(sd, p + ".time_emb_proj"),
        "norm2": _norm(sd, p + ".norm2"),
        "conv2": _c(sd, p + ".conv2"),
    }
    if p + ".conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _c(sd, p + ".conv_shortcut")
    return out


def _attn_block(sd, p):
    """diffusers Transformer2DModel (one BasicTransformerBlock)."""
    b = p + ".transformer_blocks.0"

    def xattn(q):
        return {
            "to_q": {"weight": _t(sd[f"{b}.{q}.to_q.weight"])},
            "to_k": {"weight": _t(sd[f"{b}.{q}.to_k.weight"])},
            "to_v": {"weight": _t(sd[f"{b}.{q}.to_v.weight"])},
            "to_out": _lin(sd, f"{b}.{q}.to_out.0"),
        }

    return {
        "norm": _norm(sd, p + ".norm"),
        "proj_in": _proj(sd, p + ".proj_in"),
        "block_0": {
            "norm1": _norm(sd, b + ".norm1"),
            "attn1": xattn("attn1"),
            "norm2": _norm(sd, b + ".norm2"),
            "attn2": xattn("attn2"),
            "norm3": _norm(sd, b + ".norm3"),
            "ff_geglu": {"proj": _lin(sd, b + ".ff.net.0.proj")},
            "ff_out": _lin(sd, b + ".ff.net.2"),
        },
        "proj_out": _proj(sd, p + ".proj_out"),
    }


def convert_unet(sd: Mapping[str, Tensor], cfg,
                 prefix: str = "") -> Dict[str, Tensor]:
    """diffusers UNet2DConditionModel -> the port's `UNet2DCondition`.
    cfg: UNetConfig."""
    p = prefix
    out: Dict = {
        "conv_in": _c(sd, p + "conv_in"),
        "time_dense1": _lin(sd, p + "time_embedding.linear_1"),
        "time_dense2": _lin(sd, p + "time_embedding.linear_2"),
        "conv_norm_out": _norm(sd, p + "conv_norm_out"),
        "conv_out": _c(sd, p + "conv_out"),
    }
    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            out[f"down_{i}_res_{j}"] = _resnet(
                sd, p + f"down_blocks.{i}.resnets.{j}")
            if cfg.cross_attn_blocks[i]:
                out[f"down_{i}_attn_{j}"] = _attn_block(
                    sd, p + f"down_blocks.{i}.attentions.{j}")
        if i < n_blocks - 1:
            out[f"down_{i}_downsample"] = _c(
                sd, p + f"down_blocks.{i}.downsamplers.0.conv")
    out["mid_res_0"] = _resnet(sd, p + "mid_block.resnets.0")
    out["mid_attn"] = _attn_block(sd, p + "mid_block.attentions.0")
    out["mid_res_1"] = _resnet(sd, p + "mid_block.resnets.1")
    rev_cross = tuple(reversed(cfg.cross_attn_blocks))
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block + 1):
            out[f"up_{i}_res_{j}"] = _resnet(
                sd, p + f"up_blocks.{i}.resnets.{j}")
            if rev_cross[i]:
                out[f"up_{i}_attn_{j}"] = _attn_block(
                    sd, p + f"up_blocks.{i}.attentions.{j}")
        if i < n_blocks - 1:
            out[f"up_{i}_upsample"] = _c(
                sd, p + f"up_blocks.{i}.upsamplers.0.conv")
    return _flat(out)


def _vae_resnet(sd, p):
    out = {
        "norm1": _norm(sd, p + ".norm1"),
        "conv1": _c(sd, p + ".conv1"),
        "norm2": _norm(sd, p + ".norm2"),
        "conv2": _c(sd, p + ".conv2"),
    }
    if p + ".conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _c(sd, p + ".conv_shortcut")
    return out


def _vae_attn(sd, p):
    return {
        "group_norm": _norm(sd, p + ".group_norm"),
        "to_q": _lin(sd, p + ".to_q"),
        "to_k": _lin(sd, p + ".to_k"),
        "to_v": _lin(sd, p + ".to_v"),
        "to_out": _lin(sd, p + ".to_out.0"),
    }


def convert_vae(sd: Mapping[str, Tensor], cfg,
                prefix: str = "") -> Dict[str, Tensor]:
    """diffusers AutoencoderKL -> the port's `AutoencoderKL`.
    cfg: VAEConfig."""
    p = prefix
    n = len(cfg.block_out_channels)
    enc: Dict = {"conv_in": _c(sd, p + "encoder.conv_in"),
                 "conv_norm_out": _norm(sd, p + "encoder.conv_norm_out"),
                 "conv_out": _c(sd, p + "encoder.conv_out")}
    for i in range(n):
        for j in range(cfg.layers_per_block):
            enc[f"down_{i}_res_{j}"] = _vae_resnet(
                sd, p + f"encoder.down_blocks.{i}.resnets.{j}")
        if i < n - 1:
            enc[f"down_{i}_downsample"] = _c(
                sd, p + f"encoder.down_blocks.{i}.downsamplers.0.conv")
    enc["mid_res_0"] = _vae_resnet(sd, p + "encoder.mid_block.resnets.0")
    enc["mid_attn"] = _vae_attn(sd, p + "encoder.mid_block.attentions.0")
    enc["mid_res_1"] = _vae_resnet(sd, p + "encoder.mid_block.resnets.1")

    dec: Dict = {"conv_in": _c(sd, p + "decoder.conv_in"),
                 "conv_norm_out": _norm(sd, p + "decoder.conv_norm_out"),
                 "conv_out": _c(sd, p + "decoder.conv_out")}
    dec["mid_res_0"] = _vae_resnet(sd, p + "decoder.mid_block.resnets.0")
    dec["mid_attn"] = _vae_attn(sd, p + "decoder.mid_block.attentions.0")
    dec["mid_res_1"] = _vae_resnet(sd, p + "decoder.mid_block.resnets.1")
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            dec[f"up_{i}_res_{j}"] = _vae_resnet(
                sd, p + f"decoder.up_blocks.{i}.resnets.{j}")
        if i < n - 1:
            dec[f"up_{i}_upsample"] = _c(
                sd, p + f"decoder.up_blocks.{i}.upsamplers.0.conv")
    return _flat({
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _c(sd, p + "quant_conv"),
        "post_quant_conv": _c(sd, p + "post_quant_conv"),
    })


def convert_clip_text(sd: Mapping[str, Tensor],
                      prefix: str = "text_model.") -> Dict[str, Tensor]:
    """HF CLIPTextModel -> the port's `ClipTextModel`
    (models/stable_diffusion/clip_text.py), as many layers as the
    checkpoint holds."""
    p = prefix
    out: Dict = {
        "token_embedding": {"weight": sd[
            p + "embeddings.token_embedding.weight"]},
        "position_embedding": {"weight": sd[
            p + "embeddings.position_embedding.weight"]},
        "final_layer_norm": _norm(sd, p + "final_layer_norm"),
    }
    i = 0
    while p + f"encoder.layers.{i}.layer_norm1.weight" in sd:
        lp = p + f"encoder.layers.{i}."
        out[f"layer_{i}"] = {
            "layer_norm1": _norm(sd, lp + "layer_norm1"),
            "layer_norm2": _norm(sd, lp + "layer_norm2"),
            "q_proj": _lin(sd, lp + "self_attn.q_proj"),
            "k_proj": _lin(sd, lp + "self_attn.k_proj"),
            "v_proj": _lin(sd, lp + "self_attn.v_proj"),
            "out_proj": _lin(sd, lp + "self_attn.out_proj"),
            "fc1": _lin(sd, lp + "mlp.fc1"),
            "fc2": _lin(sd, lp + "mlp.fc2"),
        }
        i += 1
    return _flat(out)
