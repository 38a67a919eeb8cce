"""Released-checkpoint converter for the Grounding-DINO tool (counterpart
of `visionllm_tpu/utils/convert_gdino.py`).

Maps the reference OVGroundingDinoForObjectDetection state dict
(modeling_ov_grounding_dino_mask_dn.py, attribute paths cited inline)
onto the port's `GroundingDino` state dict
(models/grounding_dino/model.py). The released VisionLLMv2 checkpoint
prefixes these keys with "gdino."; pass `prefix="gdino."` when
converting the composite dict. Layouts are the reference's own, so the
helpers rename; `_mha` splits the packed attention projection.

The reference's backbone is HF's Swin (`convert_swin`). The port also
runs Grounding-DINO on InternImage, for which neither the reference nor
the JAX package has a converter: `convert_gdino` raises naming the
backbone (`ROADMAP.md` §C.2).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from visionllm_tpu_torch.models.swin import (swin_large_config,
                                             swin_tiny_config)
from visionllm_tpu_torch.utils.torch_convert import (
    _conv2d, _flat, _lin, _mha, _norm, consume_tied_duplicates, convert_swin)

Tensor = torch.Tensor

_SWIN_PRESETS = {"swin_tiny": swin_tiny_config,
                 "swin_large": swin_large_config}


def swin_preset(backbone: str, out_stages, overrides=None):
    """The Swin config a tool's converter reads its backbone with; raises
    for any other backbone (InternImage: no reference converter)."""
    if backbone not in _SWIN_PRESETS:
        raise ValueError(
            f"no checkpoint converter for the {backbone!r} backbone: the "
            f"reference's and the JAX package's converters read Swin only "
            f"({sorted(_SWIN_PRESETS)})")
    return _SWIN_PRESETS[backbone](out_stages=tuple(out_stages),
                                   **dict(overrides or {}))


_ln = _gn = _norm


def _mlp(sd, name, n=3):
    """GroundingDinoMLPPredictionHead / MLP with .layers.{i}."""
    return {f"layers_{i}": _lin(sd, f"{name}.layers.{i}") for i in range(n)}


def _deformable(sd, name):
    """GroundingDinoMultiscaleDeformableAttention (:647-786)."""
    return {k: _lin(sd, f"{name}.{k}") for k in (
        "sampling_offsets", "attention_weights", "value_proj",
        "output_proj")}


def _fusion(sd, name):
    """GroundingDinoFusionLayer (:1045-1104)."""
    a = name + ".attn"
    return {
        "layer_norm_vision": _ln(sd, name + ".layer_norm_vision"),
        "layer_norm_text": _ln(sd, name + ".layer_norm_text"),
        "vision_param": sd[name + ".vision_param"],
        "text_param": sd[name + ".text_param"],
        "attn": {k: _lin(sd, f"{a}.{k}") for k in (
            "vision_proj", "text_proj", "values_vision_proj",
            "values_text_proj", "out_vision_proj", "out_text_proj")},
    }


def convert_gdino(sd: Mapping[str, Tensor], cfg,
                  prefix: str = "") -> Dict[str, Tensor]:
    """cfg: GDinoConfig. Returns the state dict of the port's
    `GroundingDino`."""
    p = prefix
    m = p + "model."
    out: Dict = {}

    # Swin backbone via HF AutoBackbone (:2078, GroundingDinoConvEncoder)
    swin_cfg = swin_preset(cfg.backbone, (0, 1, 2, 3),
                           cfg.backbone_overrides)
    out["backbone"] = convert_swin(
        sd, swin_cfg, prefix=m + "backbone.conv_encoder.model.")

    # input projections (:2084-2103): ModuleList of [conv, GroupNorm]
    for i in range(4):
        out[f"input_proj_{i}"] = _conv2d(sd, m + f"input_proj_vision.{i}.0")
        out[f"input_proj_norm_{i}"] = _gn(sd, m + f"input_proj_vision.{i}.1")

    # encoder layers (:1217-1289)
    for i in range(cfg.encoder_layers):
        lp = m + f"encoder.layers.{i}."
        te = lp + "text_enhancer_layer"
        de = lp + "deformable_layer"
        out[f"encoder_layer_{i}"] = {
            "fusion_layer": _fusion(sd, lp + "fusion_layer"),
            "text_enhancer_layer": {
                "self_attn": _mha(sd, te + ".self_attn"),
                "layer_norm_before": _ln(sd, te + ".layer_norm_before"),
                "layer_norm_after": _ln(sd, te + ".layer_norm_after"),
                "fc1": _lin(sd, te + ".fc1"),
                "fc2": _lin(sd, te + ".fc2"),
            },
            "deformable_layer": {
                "self_attn": _deformable(sd, de + ".self_attn"),
                "self_attn_layer_norm": _ln(sd, de + ".self_attn_layer_norm"),
                "fc1": _lin(sd, de + ".fc1"),
                "fc2": _lin(sd, de + ".fc2"),
                "final_layer_norm": _ln(sd, de + ".final_layer_norm"),
            },
        }

    # decoder layers (:1292-1407)
    for i in range(cfg.decoder_layers):
        lp = m + f"decoder.layers.{i}."
        out[f"decoder_layer_{i}"] = {
            "self_attn": _mha(sd, lp + "self_attn"),
            "self_attn_layer_norm": _ln(sd, lp + "self_attn_layer_norm"),
            "encoder_attn_text": _mha(sd, lp + "encoder_attn_text"),
            "encoder_attn_text_layer_norm": _ln(
                sd, lp + "encoder_attn_text_layer_norm"),
            "encoder_attn": _deformable(sd, lp + "encoder_attn"),
            "encoder_attn_layer_norm": _ln(sd, lp + "encoder_attn_layer_norm"),
            "fc1": _lin(sd, lp + "fc1"),
            "fc2": _lin(sd, lp + "fc2"),
            "final_layer_norm": _ln(sd, lp + "final_layer_norm"),
        }
    out["decoder_layer_norm"] = _ln(sd, m + "decoder.layer_norm")
    out["reference_points_head"] = _mlp(
        sd, m + "decoder.reference_points_head", 2)

    # two-stage machinery (:2167-2180)
    out["enc_output"] = _lin(sd, m + "enc_output")
    out["enc_output_norm"] = _ln(sd, m + "enc_output_norm")
    out["encoder_output_bbox_embed"] = _mlp(
        sd, m + "encoder_output_bbox_embed", 3)
    out["query_position_embeddings"] = sd[
        m + "query_position_embeddings.weight"]
    out["level_embed"] = sd[m + "level_embed"]

    # mask FPN (:2116-2152; detectron2 Conv2d carries .norm)
    out["lateral_conv"] = _conv2d(sd, m + "lateral_convs.0", with_bias=False)
    out["lateral_norm"] = _gn(sd, m + "lateral_convs.0.norm")
    out["output_conv"] = _conv2d(sd, m + "output_convs.0", with_bias=False)
    out["output_norm"] = _gn(sd, m + "output_convs.0.norm")
    out["mask_features"] = _conv2d(sd, m + "mask_features")
    out["model_mask_embed"] = _mlp(sd, m + "mask_embed", 3)

    # heads (shared across layers: decoder_bbox_embed_share, :2626-2640)
    out["bbox_embed"] = _mlp(sd, p + "bbox_embed.0", 3)
    out["mask_embed"] = _mlp(sd, p + "mask_embed.0", 3)
    out["patch2query"] = _mlp(sd, p + "patch2query", 3)
    # per-slot + decoder-attribute aliases of the shared heads: read them
    # (torch serializes each tied reference) and verify the tie
    consume_tied_duplicates(sd, p + "bbox_embed.0",
                            [p + "bbox_embed", m + "decoder.bbox_embed"])
    consume_tied_duplicates(sd, p + "mask_embed.0", [p + "mask_embed"])
    return _flat(out)
