"""Open-vocabulary Grounding-DINO decoder (counterpart of
`visionllm_tpu/models/grounding_dino/model.py`), for inference and for
the det training step.

Text queries come from the LLM's [EMB] hidden states; classification is
a contrastive dot product against them. Images are NHWC at the public
functions; convolutions and group norms permute to NCHW internally.
Inference heads the last decoder layer only. With `all_layers=True` every
decoder layer is headed (`all_logits`, `all_boxes`, `all_masks`, the
stacks the losses read), and with `targets` and `dn_noise` contrastive
denoising queries are placed in front of the matching queries, the
decoder self-attention is masked between their groups, and the dn slice
is split off the outputs (JAX `model.py:299-487`). Masks are computed for
the matching queries only: the losses read no dn mask. The two-stage
intermediate mask, which no loss reads, is not computed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.config import GDinoConfig
from visionllm_tpu_torch.models.common import FLAX_LN_EPS, MLP
from visionllm_tpu_torch.models.grounding_dino.layers import (
    NEG_INF, DeformableAttention, DeformableEncoderLayer,
    FusionLayer, TextEnhancerLayer, TorchMHA, encoder_reference_points,
    get_sine_pos_embed, sine_position_embedding)
from visionllm_tpu_torch.models.intern_image import (
    InternImage, intern_image_h_config, intern_image_tiny_config)
from visionllm_tpu_torch.models.swin import SwinBackbone, swin_tiny_config
from visionllm_tpu_torch.ops.box_ops import inverse_sigmoid
from visionllm_tpu_torch.train.cdn import build_cdn_queries


def generate_masks_with_text_query_masks(text_query_masks: torch.Tensor
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal text self-attention mask (True = allowed) and
    position ids: valid tokens attend to all valid tokens, padding only
    to itself."""
    B, P = text_query_masks.shape
    valid = text_query_masks.bool()
    block = valid[:, :, None] & valid[:, None, :]
    eye = torch.eye(P, dtype=torch.bool, device=valid.device)[None]
    position_ids = torch.where(valid, torch.cumsum(valid.long(), 1) - 1,
                               torch.zeros_like(valid, dtype=torch.long))
    return block | eye, position_ids


def contrastive_logits(vision_hidden, text_hidden, text_token_mask,
                       max_text_len: int) -> torch.Tensor:
    """Queries · text embeddings (fp32), masked and padded to
    max_text_len with the fp32 minimum."""
    logits = torch.matmul(vision_hidden.float(),
                          text_hidden.float().transpose(1, 2))
    logits = logits.masked_fill(~text_token_mask[:, None, :], NEG_INF)
    pad = max_text_len - logits.shape[-1]
    if pad > 0:
        logits = F.pad(logits, (0, pad), value=NEG_INF)
    return logits[..., :max_text_len]


def build_backbone(cfg: GDinoConfig):
    """(backbone module, its config) for `cfg.backbone`: Swin-T (with
    `backbone_overrides` on its preset dims), InternImage-H, or the JAX
    package's test InternImage (depths (1, 1, 1, 1), groups (2, 2, 4, 4);
    JAX `grounding_dino/model.py:166-175`). Each returns four NHWC maps at
    strides 4-32, whose widths `stage_dim(0..3)` the projections take."""
    if cfg.backbone == "swin_tiny":
        bb_cfg = swin_tiny_config(out_stages=(0, 1, 2, 3),
                                  **dict(cfg.backbone_overrides or {}))
        return SwinBackbone(bb_cfg), bb_cfg
    if cfg.backbone == "intern_image_h":
        bb_cfg = intern_image_h_config()
    elif cfg.backbone == "intern_image_tiny":
        bb_cfg = intern_image_tiny_config(depths=(1, 1, 1, 1),
                                          groups=(2, 2, 4, 4))
    else:
        raise NotImplementedError(f"backbone {cfg.backbone!r} not ported")
    return InternImage(bb_cfg), bb_cfg


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` that, like flax's, normalizes a group of one value
    (zero variance: the output is the bias), which `F.group_norm`
    refuses; a 1 x 1 level of a B1 batch has such groups when a group is
    one channel, as at the tiny test config's width."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps, torch.backends.cudnn.enabled)


def _nchw(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a conv or group norm to an NHWC tensor."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """[B, H, W] bool -> [B, 2] (w_ratio, h_ratio)."""
    B, H, W = mask.shape
    vh = mask[:, :, 0].float().sum(1) / H
    vw = mask[:, 0, :].float().sum(1) / W
    return torch.stack([vw, vh], dim=-1)


def _downsample_mask(pixel_mask: torch.Tensor, hw) -> torch.Tensor:
    """Half-pixel nearest downsample of the validity mask (the JAX
    `jax.image.resize(..., "nearest")`)."""
    m = F.interpolate(pixel_mask.float()[:, None], size=tuple(hw),
                      mode="nearest-exact")
    return m[:, 0] > 0.5


def encoder_proposals(enc_output: torch.Tensor, valid_mask: torch.Tensor,
                      spatial_shapes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor-like proposals per encoder token, shared by Grounding-DINO
    and UniPose: (enc_output with the tokens that are padding or whose
    anchor leaves (0.01, 0.99) zeroed, proposal logits [B, S, 4] fp32,
    +inf at those tokens)."""
    B = enc_output.shape[0]
    dev = enc_output.device
    props = []
    pos = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        m = valid_mask[:, pos:pos + h * w].reshape(B, h, w)
        valid_h = m[:, :, 0].sum(1).float()
        valid_w = m[:, 0, :].sum(1).float()
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None]
        scale = torch.stack([valid_w, valid_h], dim=-1).reshape(B, 1, 1, 2)
        grid = (grid + 0.5) / scale
        wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
        props.append(torch.cat([grid, wh], -1).reshape(B, -1, 4))
        pos += h * w
    proposals = torch.cat(props, dim=1)
    prop_valid = ((proposals > 0.01) & (proposals < 0.99)).all(
        -1, keepdim=True)
    proposals = torch.log(proposals / (1 - proposals))
    bad = (~valid_mask[..., None]) | (~prop_valid)
    return (enc_output.masked_fill(bad, 0.0),
            proposals.masked_fill(bad, float("inf")))


class GDinoEncoderLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        self.fusion_layer = FusionLayer(cfg.d_model, cfg.ffn_dim // 2,
                                        cfg.num_heads // 2)
        self.text_enhancer_layer = TextEnhancerLayer(
            cfg.d_model, cfg.ffn_dim // 2, cfg.num_heads // 2)
        self.deformable_layer = DeformableEncoderLayer(
            cfg.d_model, cfg.ffn_dim, cfg.num_heads, cfg.num_feature_levels,
            cfg.num_points)

    def forward(self, vision, text, *, vision_pos, spatial_shapes,
                reference_points, vision_pad_mask, text_pad_mask,
                text_self_attn_mask, text_pos):
        vision, text = self.fusion_layer(vision, text,
                                         vision_pad_mask=vision_pad_mask,
                                         text_pad_mask=text_pad_mask)
        text = self.text_enhancer_layer(text, attn_mask=~text_self_attn_mask,
                                        position_embeddings=text_pos)
        vision = self.deformable_layer(
            vision, position_embeddings=vision_pos,
            reference_points=reference_points, spatial_shapes=spatial_shapes,
            value_mask=None if vision_pad_mask is None else ~vision_pad_mask)
        return vision, text


class GDinoDecoderLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = TorchMHA(d, cfg.num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.encoder_attn_text = TorchMHA(d, cfg.num_heads)
        self.encoder_attn_text_layer_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.encoder_attn = DeformableAttention(
            d, cfg.num_heads, cfg.num_feature_levels, cfg.num_points)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)

    def forward(self, hidden, *, query_pos, reference_points, spatial_shapes,
                vision, vision_valid_mask, text, text_pad_mask,
                self_attn_mask=None):
        """self_attn_mask: bool [B, Q, Q], True = blocked (dn groups)."""
        q = hidden + query_pos
        attn = self.self_attn(q, q, hidden, attn_mask=self_attn_mask)
        hidden = self.self_attn_layer_norm(hidden + attn)
        attn = self.encoder_attn_text(hidden + query_pos, text, text,
                                      key_padding_mask=text_pad_mask)
        hidden = self.encoder_attn_text_layer_norm(hidden + attn)
        attn = self.encoder_attn(hidden, vision, position_embeddings=query_pos,
                                 reference_points=reference_points,
                                 spatial_shapes=spatial_shapes,
                                 value_mask=vision_valid_mask)
        hidden = self.encoder_attn_layer_norm(hidden + attn)
        x = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + x)


class GroundingDino(nn.Module):
    """forward(pixel_values NHWC, text_query [B, P, num_embs, text_dim],
    text_query_masks [B, P], pixel_mask?, targets?, dn_noise?,
    all_layers?) -> dict(logits [B, Q, max_text_len], pred_boxes
    [B, Q, 4] cxcywh normalized, pred_masks [B, Q, H/4, W/4], enc_logits,
    enc_boxes, topk_idx, mask_features, text_features; with all_layers
    also all_logits, all_boxes, all_masks [n_layers, ...]; with dn
    queries also dn_all_logits, dn_all_boxes, dn_targets)."""

    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.backbone, bb_cfg = build_backbone(cfg)
        # input projections: 1x1 conv + GN for backbone strides 8/16/32,
        # an extra 3x3 stride-2 conv from the stride-32 feature
        for i in range(3):
            self.add_module(f"input_proj_{i}",
                            nn.Conv2d(bb_cfg.stage_dim(i + 1), d, 1))
            self.add_module(f"input_proj_norm_{i}",
                            GroupNorm(32, d, eps=FLAX_LN_EPS))
        self.input_proj_3 = nn.Conv2d(bb_cfg.stage_dim(3), d, 3, stride=2,
                                      padding=1)
        self.input_proj_norm_3 = GroupNorm(32, d, eps=FLAX_LN_EPS)
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, d))
        for i in range(cfg.encoder_layers):
            self.add_module(f"encoder_layer_{i}", GDinoEncoderLayer(cfg))
        for i in range(cfg.decoder_layers):
            self.add_module(f"decoder_layer_{i}", GDinoDecoderLayer(cfg))
        self.decoder_layer_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.reference_points_head = MLP(2 * d, d, d, 2)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.encoder_output_bbox_embed = MLP(d, d, 4, 3)
        self.query_position_embeddings = nn.Parameter(
            torch.zeros(cfg.num_queries, d))
        # mask FPN (stride-4 path)
        self.lateral_conv = nn.Conv2d(bb_cfg.stage_dim(0), d, 1, bias=False)
        self.lateral_norm = GroupNorm(32, d, eps=FLAX_LN_EPS)
        self.output_conv = nn.Conv2d(d, d, 3, padding=1, bias=False)
        self.output_norm = GroupNorm(32, d, eps=FLAX_LN_EPS)
        self.mask_features = nn.Conv2d(d, cfg.mask_dim, 1)
        self.model_mask_embed = MLP(d, d, cfg.mask_dim, 3)
        self.bbox_embed = MLP(d, d, 4, 3)
        self.mask_embed = MLP(d, d, cfg.mask_dim, 3)
        self.patch2query = MLP(cfg.text_dim, d, d, 3)

    def gen_proposals(self, enc_output, valid_mask, spatial_shapes):
        """(object_query [B, S, C], proposal logits [B, S, 4] fp32)."""
        oq, proposals = encoder_proposals(enc_output, valid_mask,
                                          spatial_shapes)
        return self.enc_output_norm(self.enc_output(oq)), proposals

    def forward(self, pixel_values: torch.Tensor, text_query: torch.Tensor,
                text_query_masks: torch.Tensor,
                pixel_mask: Optional[torch.Tensor] = None,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                dn_noise: Optional[Dict[str, torch.Tensor]] = None,
                all_layers: bool = False,
                topk_idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """`targets` (labels [B, N], boxes [B, N, 4], valid [B, N]) with
        `dn_noise` (`train.cdn.draw_cdn_noise`) build the CDN queries;
        `topk_idx` [B, num_queries] replaces the two-stage top-k
        selection (to repeat another run's choice)."""
        cfg = self.cfg
        dt = self.level_embed.dtype
        B, H, W, _ = pixel_values.shape
        if pixel_mask is None:
            pixel_mask = torch.ones(B, H, W, dtype=torch.bool,
                                    device=pixel_values.device)
        pixel_values = pixel_values.to(dt)

        tq = self.patch2query(text_query.to(dt)).mean(dim=-2)   # [B, P, d]
        dn = dn_targets = None
        if targets is not None and dn_noise is not None and cfg.dn_number > 0:
            dn, dn_targets = build_cdn_queries(
                dn_noise, targets, tq, text_query_masks,
                dn_number=cfg.dn_number,
                label_noise_ratio=cfg.label_noise_ratio,
                box_noise_scale=cfg.box_noise_scale,
                num_queries=cfg.num_queries)
        text_token_mask = text_query_masks.bool()
        text_self_attn_mask, text_position_ids = (
            generate_masks_with_text_query_masks(text_query_masks))
        text_pos = get_sine_pos_embed(
            text_position_ids[..., None].float(), num_pos_feats=cfg.d_model,
            exchange_xy=False).to(dt)

        feats = self.backbone(pixel_values)
        sources, masks_l = [], []
        for i in range(3):
            x = _nchw(getattr(self, f"input_proj_norm_{i}"),
                      _nchw(getattr(self, f"input_proj_{i}"), feats[i + 1]))
            sources.append(x)
        sources.append(_nchw(self.input_proj_norm_3,
                             _nchw(self.input_proj_3, feats[-1])))
        pos_l = []
        for x in sources:
            m = _downsample_mask(pixel_mask, x.shape[1:3])
            masks_l.append(m)
            pos_l.append(sine_position_embedding(m, cfg.d_model))

        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in sources)
        src_flat = torch.cat([s.reshape(B, -1, cfg.d_model) for s in sources], 1)
        mask_flat = torch.cat([m.reshape(B, -1) for m in masks_l], 1)
        pos_flat = torch.cat(
            [(p + self.level_embed[i].float()).reshape(B, -1, cfg.d_model)
             for i, p in enumerate(pos_l)], 1).to(dt)
        valid_ratios = torch.stack([_valid_ratio(m) for m in masks_l], 1)

        ref_pts = encoder_reference_points(spatial_shapes, valid_ratios)
        vision, text = src_flat, tq
        vision_pad, text_pad = ~mask_flat, ~text_token_mask
        for i in range(cfg.encoder_layers):
            vision, text = getattr(self, f"encoder_layer_{i}")(
                vision, text, vision_pos=pos_flat,
                spatial_shapes=spatial_shapes, reference_points=ref_pts,
                vision_pad_mask=vision_pad, text_pad_mask=text_pad,
                text_self_attn_mask=text_self_attn_mask, text_pos=text_pos)

        # mask features FPN (stride 4)
        h0, w0 = spatial_shapes[0]
        enc_lvl0 = vision[:, :h0 * w0].reshape(B, h0, w0, cfg.d_model)
        lat = _nchw(self.lateral_norm, _nchw(self.lateral_conv, feats[0]))
        up = F.interpolate(enc_lvl0.float().permute(0, 3, 1, 2),
                           size=tuple(lat.shape[1:3]), mode="bilinear",
                           align_corners=False, antialias=False)
        up = up.permute(0, 2, 3, 1).to(lat.dtype)
        fpn = F.relu(_nchw(self.output_norm, _nchw(self.output_conv, lat + up)))
        mask_features = _nchw(self.mask_features, fpn)     # [B, h4, w4, m]

        # two-stage proposals -> top-k queries
        oq, proposals = self.gen_proposals(vision, mask_flat, spatial_shapes)
        enc_class = contrastive_logits(oq, text, text_token_mask,
                                       cfg.max_text_len)
        enc_coord_logits = self.encoder_output_bbox_embed(oq).float() + proposals
        if topk_idx is None:
            topk_idx = torch.topk(enc_class.amax(-1), cfg.num_queries,
                                  dim=1).indices
        topk_coords = torch.gather(enc_coord_logits, 1,
                                   topk_idx[..., None].expand(-1, -1, 4))
        # the decoder starts from the proposals without their gradient
        reference_points = torch.sigmoid(topk_coords.detach())

        hidden = self.query_position_embeddings[None].expand(B, -1, -1)
        self_attn_mask, pad = None, 0
        if dn is not None:
            hidden = torch.cat([dn["query_label"].to(hidden.dtype), hidden], 1)
            reference_points = torch.cat(
                [torch.sigmoid(dn["query_bbox"]), reference_points], 1)
            self_attn_mask, pad = dn["attn_mask"], dn["pad_size"]
        init_reference_points = reference_points

        vr2 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
        hiddens, new_refs = [], []
        for i in range(cfg.decoder_layers):
            ref_input = reference_points[:, :, None] * vr2
            query_sine = get_sine_pos_embed(ref_input[:, :, 0, :],
                                            num_pos_feats=cfg.d_model // 2,
                                            temperature=10000,
                                            exchange_xy=True)
            query_pos = self.reference_points_head(query_sine.to(dt))
            hidden = getattr(self, f"decoder_layer_{i}")(
                hidden, query_pos=query_pos, reference_points=ref_input,
                spatial_shapes=spatial_shapes, vision=vision,
                vision_valid_mask=mask_flat, text=text,
                text_pad_mask=text_pad, self_attn_mask=self_attn_mask)
            delta = self.bbox_embed(hidden)
            new_ref = torch.sigmoid(delta.float()
                                    + inverse_sigmoid(reference_points))
            # iterative refinement: the next layer starts without the
            # gradient, the heads below keep it
            reference_points = new_ref.detach()
            hiddens.append(hidden)
            new_refs.append(new_ref)

        def head(lvl):
            hs = self.decoder_layer_norm(hiddens[lvl])
            ref = inverse_sigmoid(init_reference_points if lvl == 0
                                  else new_refs[lvl - 1])
            masks = torch.einsum("bqc,bhwc->bqhw",
                                 self.mask_embed(hs[:, pad:]), mask_features)
            return (contrastive_logits(hs, text, text_token_mask,
                                       cfg.max_text_len),
                    torch.sigmoid(self.bbox_embed(hs).float() + ref),
                    masks.float())

        levels = range(cfg.decoder_layers) if all_layers \
            else [cfg.decoder_layers - 1]
        classes, coords, masks = zip(*[head(lvl) for lvl in levels])
        out = {
            "logits": classes[-1][:, pad:],
            "pred_boxes": coords[-1][:, pad:],
            "pred_masks": masks[-1],
            # the two-stage loss supervises the selected proposals, with
            # their gradient (unlike the decoder's start above)
            "enc_logits": torch.gather(
                enc_class, 1,
                topk_idx[..., None].expand(-1, -1, enc_class.shape[-1])),
            "enc_boxes": torch.sigmoid(topk_coords),
            "topk_idx": topk_idx,
            "mask_features": mask_features,
            "text_features": text,
        }
        if all_layers:
            out["all_logits"] = torch.stack([c[:, pad:] for c in classes])
            out["all_boxes"] = torch.stack([c[:, pad:] for c in coords])
            out["all_masks"] = torch.stack(masks)
        if dn is not None:
            out["dn_all_logits"] = torch.stack([c[:, :pad] for c in classes])
            out["dn_all_boxes"] = torch.stack([c[:, :pad] for c in coords])
            out["dn_targets"] = dn_targets
        return out
