"""Released-checkpoint converter for the UniPose tool (counterpart of
`visionllm_tpu/utils/convert_unipose.py`).

Maps the reference UniPose state dict (visionllmv2/model/unipose/
modeling_unipose.py: a vendored SwinTransformer with a packed attn.qkv,
a DeformableTransformer whose encoder holds {layers, text_layers,
fusion_layers}, decoder layers named cross_attn / ca_text / self_attn /
norm1..3 / linear1..2, and the decoder-held hw / hw_append embeddings
:2943-2946) onto the port's `UniPose` state dict
(models/unipose/model.py). Composite checkpoint prefix: "unipose.". Like
`convert_gdino`, it raises for an InternImage backbone.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from visionllm_tpu_torch.utils.convert_gdino import (_conv2d, _deformable,
                                                     _gn, _lin, _ln, _mha,
                                                     _mlp, swin_preset)
from visionllm_tpu_torch.utils.torch_convert import (_flat, _t,
                                                     consume_tied_duplicates)

Tensor = torch.Tensor


def convert_vendored_swin(sd: Mapping[str, Tensor], cfg,
                          prefix: str) -> Dict[str, Tensor]:
    """Vendored SwinTransformer (modeling_unipose.py:1535-1860, packed
    qkv) -> the port's `SwinBackbone` state dict."""
    p = prefix
    out: Dict = {
        "patch_embed": _conv2d(sd, p + "patch_embed.proj"),
        "patch_norm": _ln(sd, p + "patch_embed.norm"),
    }
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            lp = p + f"layers.{s}.blocks.{b}."
            qkv_w = _t(sd[lp + "attn.qkv.weight"])
            qkv_b = sd[lp + "attn.qkv.bias"]
            d = qkv_w.shape[0] // 3
            out[f"stage{s}_block{b}"] = {
                "layernorm_before": _ln(sd, lp + "norm1"),
                "layernorm_after": _ln(sd, lp + "norm2"),
                "query": {"weight": qkv_w[:d], "bias": qkv_b[:d]},
                "key": {"weight": qkv_w[d:2 * d], "bias": qkv_b[d:2 * d]},
                "value": {"weight": qkv_w[2 * d:], "bias": qkv_b[2 * d:]},
                "proj": _lin(sd, lp + "attn.proj"),
                "fc1": _lin(sd, lp + "mlp.fc1"),
                "fc2": _lin(sd, lp + "mlp.fc2"),
                "relative_position_bias_table": sd[
                    lp + "attn.relative_position_bias_table"],
            }
        if s < cfg.num_stages - 1:
            dp = p + f"layers.{s}.downsample."
            out[f"downsample{s}"] = {
                "norm": _ln(sd, dp + "norm"),
                "reduction": {"weight": _t(sd[dp + "reduction.weight"])},
            }
    for s in cfg.out_stages:
        out[f"out_norm{s}"] = _ln(sd, p + f"norm{s}")
    return _flat(out)


def convert_unipose(sd: Mapping[str, Tensor], cfg,
                    prefix: str = "") -> Dict[str, Tensor]:
    """cfg: UniPoseConfig -> the state dict of the port's `UniPose`."""
    p = prefix
    t = p + "transformer."
    out: Dict = {}

    out["backbone"] = convert_vendored_swin(
        sd, swin_preset(cfg.backbone, (1, 2, 3)), p + "backbone.0.")

    for i in range(4):
        out[f"input_proj_{i}"] = _conv2d(sd, p + f"input_proj.{i}.0")
        out[f"input_proj_norm_{i}"] = _gn(sd, p + f"input_proj.{i}.1")

    out["projection_llava"] = _mlp(sd, p + "projection_llava", 3)
    out["projection_kpt_llava"] = _mlp(sd, p + "projection_kpt_llava", 3)

    for i in range(cfg.encoder_layers):
        lp = t + f"encoder.layers.{i}."
        fl = t + f"encoder.fusion_layers.{i}."
        tl = t + f"encoder.text_layers.{i}."
        out[f"encoder_layer_{i}"] = {
            "fusion_layer": {
                "layer_norm_vision": _ln(sd, fl + "layer_norm_v"),
                "layer_norm_text": _ln(sd, fl + "layer_norm_l"),
                # unipose names the layer-scale params gam_v/gam_l
                # (modeling_unipose.py:2194-2195), unlike gdino's
                # vision_param/text_param
                "vision_param": sd[fl + "gam_v"],
                "text_param": sd[fl + "gam_l"],
                "attn": {
                    "vision_proj": _lin(sd, fl + "attn.v_proj"),
                    "text_proj": _lin(sd, fl + "attn.l_proj"),
                    "values_vision_proj": _lin(sd, fl + "attn.values_v_proj"),
                    "values_text_proj": _lin(sd, fl + "attn.values_l_proj"),
                    "out_vision_proj": _lin(sd, fl + "attn.out_v_proj"),
                    "out_text_proj": _lin(sd, fl + "attn.out_l_proj"),
                },
            },
            "text_layer": {
                "self_attn": _mha(sd, tl + "self_attn"),
                "norm1": _ln(sd, tl + "norm1"),
                "norm2": _ln(sd, tl + "norm2"),
                "linear1": _lin(sd, tl + "linear1"),
                "linear2": _lin(sd, tl + "linear2"),
            },
            "deformable_layer": {
                "self_attn": _deformable(sd, lp + "self_attn"),
                "self_attn_layer_norm": _ln(sd, lp + "norm1"),
                "fc1": _lin(sd, lp + "linear1"),
                "fc2": _lin(sd, lp + "linear2"),
                "final_layer_norm": _ln(sd, lp + "norm2"),
            },
        }

    for i in range(cfg.decoder_layers):
        lp = t + f"decoder.layers.{i}."
        out[f"decoder_layer_{i}"] = {
            "self_attn": _mha(sd, lp + "self_attn"),
            "norm2": _ln(sd, lp + "norm2"),
            "ca_text": _mha(sd, lp + "ca_text"),
            "catext_norm": _ln(sd, lp + "catext_norm"),
            "cross_attn": _deformable(sd, lp + "cross_attn"),
            "norm1": _ln(sd, lp + "norm1"),
            "linear1": _lin(sd, lp + "linear1"),
            "linear2": _lin(sd, lp + "linear2"),
            "norm3": _ln(sd, lp + "norm3"),
        }

    out["decoder_norm"] = _ln(sd, t + "decoder.norm")
    out["ref_point_head"] = _mlp(sd, t + "decoder.ref_point_head", 2)
    out["level_embed"] = sd[t + "level_embed"]
    out["tgt_embed"] = sd[t + "tgt_embed.weight"]
    out["enc_output"] = _lin(sd, t + "enc_output")
    out["enc_output_norm"] = _ln(sd, t + "enc_output_norm")
    out["enc_out_bbox_embed"] = _mlp(sd, t + "enc_out_bbox_embed", 3)

    out["bbox_embed"] = _mlp(sd, p + "bbox_embed.0", 3)
    out["pose_embed"] = _mlp(sd, p + "pose_embed.0", 3)
    out["pose_hw_embed"] = _mlp(sd, p + "pose_hw_embed.0", 3)
    # tied per-slot + decoder-attribute aliases of the shared heads
    for head in ("bbox_embed", "pose_embed", "pose_hw_embed"):
        consume_tied_duplicates(
            sd, p + head + ".0", [p + head, t + "decoder." + head])
    out["hw"] = sd[t + "decoder.hw.weight"]
    if t + "decoder.hw_append.weight" in sd:
        out["hw_append"] = sd[t + "decoder.hw_append.weight"]
    return _flat(out)
