"""UniPose keypoint decoder, the pose tool (counterpart of
`visionllm_tpu/models/unipose/model.py`): the inference forward and the
training forward with contrastive denoising (CDN) queries.

A Swin-T, Swin-L or InternImage backbone (`models/backbone.py`;
strides 8/16/32 plus an extra stride-64 level) -> a
4-level deformable encoder with GLIP-style vision <-> text fusion, the
text being the LLM's object queries -> two-stage top-`num_queries` box
queries -> `num_box_decoder_layers` box-decoder layers -> the top
`num_groups` boxes, each expanded into a group of one box query and
`num_body_points` keypoint queries whose content is the LLM's projected
keypoint embeddings -> pose-decoder layers that refine boxes and
keypoints separately. Every encoder and decoder layer samples the
encoder memory through the port's MSDA kernel; after the expansion the
decoder's references are 4-d (boxes), one per query of every group.

After the expansion the decoder self-attention is group-isolated: the
queries are reshaped from [B, G * g, C] to [B * G, g, C] and attend
within their group under a per-group validity mask (slots attend only to
slots of the same validity), as in JAX. In training, the CDN queries
(`train/cdn.py`) lead the box queries; they ride ahead of the groups
after the expansion, refine box-style, and attend within their CDN group
and to every pose query through a second call of the same
self-attention, while the pose queries never see them. Images are NHWC
at the public functions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.config import UniPoseConfig
from visionllm_tpu_torch.models.backbone import build_backbone
from visionllm_tpu_torch.models.common import FLAX_LN_EPS, MLP
from visionllm_tpu_torch.models.grounding_dino.layers import (
    DeformableAttention, DeformableEncoderLayer, FusionLayer,
    TorchMHA, encoder_reference_points, get_sine_pos_embed,
    sine_position_embedding)
from visionllm_tpu_torch.models.grounding_dino.model import (
    GroupNorm, _downsample_mask, _nchw, _valid_ratio, contrastive_logits,
    encoder_proposals, generate_masks_with_text_query_masks)
from visionllm_tpu_torch.ops.box_ops import inverse_sigmoid
from visionllm_tpu_torch.train.cdn import build_cdn_queries


def contrastive_assign(x: torch.Tensor, text: torch.Tensor,
                       text_token_mask: torch.Tensor) -> torch.Tensor:
    """Queries . text embeddings (fp32) with the fp32 minimum at padded
    text positions; one column per text token (not padded)."""
    return contrastive_logits(x, text, text_token_mask, text.shape[1])


class TextEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer over the text queries. It takes
    the self-attention mask but, as the JAX layer, no key-padding mask."""

    def __init__(self, d_model: int, ffn_dim: int, num_heads: int):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, text, *, attn_mask, pos):
        q = text + pos
        attn = self.self_attn(q, q, text, attn_mask=attn_mask)
        text = self.norm1(text + attn)
        x = self.linear2(F.relu(self.linear1(text)))
        return self.norm2(text + x)


class UniPoseEncoderLayer(nn.Module):
    def __init__(self, cfg: UniPoseConfig):
        super().__init__()
        self.fusion_layer = FusionLayer(cfg.d_model, cfg.ffn_dim // 2,
                                        cfg.num_heads // 2)
        self.text_layer = TextEncoderLayer(cfg.d_model, cfg.ffn_dim // 2,
                                           cfg.num_heads // 2)
        self.deformable_layer = DeformableEncoderLayer(
            cfg.d_model, cfg.ffn_dim, cfg.num_heads, cfg.num_feature_levels,
            cfg.num_points)

    def forward(self, vision, text, *, vision_pos, spatial_shapes,
                reference_points, vision_pad_mask, text_pad_mask,
                text_self_attn_mask, text_pos):
        vision, text = self.fusion_layer(vision, text,
                                         vision_pad_mask=vision_pad_mask,
                                         text_pad_mask=text_pad_mask)
        text = self.text_layer(text, attn_mask=~text_self_attn_mask,
                               pos=text_pos)
        vision = self.deformable_layer(
            vision, position_embeddings=vision_pos,
            reference_points=reference_points, spatial_shapes=spatial_shapes,
            value_mask=~vision_pad_mask)
        return vision, text


class UniPoseDecoderLayer(nn.Module):
    """Self-attention -> text cross-attention -> deformable
    cross-attention -> FFN, all post-LN."""

    def __init__(self, cfg: UniPoseConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = TorchMHA(d, cfg.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.ca_text = TorchMHA(d, cfg.num_heads)
        self.catext_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.cross_attn = DeformableAttention(
            d, cfg.num_heads, cfg.num_feature_levels, cfg.num_points)
        self.norm1 = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.linear1 = nn.Linear(d, cfg.ffn_dim)
        self.linear2 = nn.Linear(cfg.ffn_dim, d)
        self.norm3 = nn.LayerNorm(d, eps=FLAX_LN_EPS)

    def forward(self, hidden, *, query_pos, reference_points, spatial_shapes,
                vision, vision_valid_mask, text, text_pad_mask,
                self_attn_mask=None, groups=None, group_mask=None, n_dn=0,
                dn_attn_mask=None):
        """Before the expansion all queries attend to each other under
        `self_attn_mask` [B, N, N] (True = blocked: the CDN groups) or
        none. After it, `groups` is the number of isolated groups G with
        `group_mask` [B, g, g] (True = blocked) shared by every group of a
        sample, and the `n_dn` leading dn queries attend to the whole
        sequence under `dn_attn_mask` [B, n_dn, N]."""
        B, N, C = hidden.shape
        q = hidden + query_pos
        if groups is None:
            attn = self.self_attn(q, q, hidden, attn_mask=self_attn_mask)
        else:
            g = (N - n_dn) // groups
            qg = q[:, n_dn:].reshape(B * groups, g, C)
            gm = group_mask.repeat_interleave(groups, dim=0)
            attn = self.self_attn(
                qg, qg, hidden[:, n_dn:].reshape(B * groups, g, C),
                attn_mask=gm).reshape(B, N - n_dn, C)
            if n_dn:
                dn_attn = self.self_attn(q[:, :n_dn], q, hidden,
                                         attn_mask=dn_attn_mask)
                attn = torch.cat([dn_attn, attn], 1)
        hidden = self.norm2(hidden + attn)
        attn = self.ca_text(hidden + query_pos, text, text,
                            key_padding_mask=text_pad_mask)
        hidden = self.catext_norm(hidden + attn)
        attn = self.cross_attn(hidden, vision, position_embeddings=query_pos,
                               reference_points=reference_points,
                               spatial_shapes=spatial_shapes,
                               value_mask=vision_valid_mask)
        hidden = self.norm1(hidden + attn)
        x = self.linear2(F.relu(self.linear1(hidden)))
        return self.norm3(hidden + x)


class UniPose(nn.Module):
    """forward(pixel_values NHWC, obj_querys [B, P_obj, num_embs,
    text_dim], obj_query_masks [B, P_obj], kpt_querys [B, P_kpt,
    num_embs, text_dim], kpt_query_masks [B, P_kpt], pixel_mask?) ->
    dict(pred_logits, pred_boxes cxcywh, pred_keypoints (x, y pairs then
    visibilities, in [0, 1]) of the last decoder layer: [B, G, .] when it
    is a pose layer, [B, num_queries, .] with zero keypoints when the
    expansion comes at or after it; enc_logits, enc_boxes of the
    two-stage selection; topk_idx [B, num_queries], group_idx [B, G]).
    `topk_idx` and `group_idx` given to forward replace the two top-k
    selections (to repeat another run's choice)."""

    def __init__(self, cfg: UniPoseConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.backbone, bb_cfg = build_backbone(cfg.backbone, (1, 2, 3))
        self.projection_llava = MLP(cfg.text_dim, d, d, 3)
        self.projection_kpt_llava = MLP(cfg.text_dim, d, d, 3)
        # 1x1 conv + GN for backbone strides 8/16/32, an extra 3x3
        # stride-2 conv from the stride-32 feature (Grounding-DINO's GN:
        # a sample's 1 x 1 level of one-channel groups, at the tiny
        # config's width, is flax's bias, not `F.group_norm`'s refusal)
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
            self.add_module(f"encoder_layer_{i}", UniPoseEncoderLayer(cfg))
        for i in range(cfg.decoder_layers):
            self.add_module(f"decoder_layer_{i}", UniPoseDecoderLayer(cfg))
        self.decoder_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.ref_point_head = MLP(2 * d, d, d, 2)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=FLAX_LN_EPS)
        self.enc_out_bbox_embed = MLP(d, d, 4, 3)
        self.tgt_embed = nn.Parameter(torch.zeros(cfg.num_queries, d))
        self.bbox_embed = MLP(d, d, 4, 3)
        self.pose_embed = MLP(d, d, 2, 3)
        # keypoint extents are refined by the pose layers only (JAX makes
        # no parameter for an unused head)
        self.pose_hw_embed = (MLP(d, d, 2, 3) if cfg.decoder_layers
                              > cfg.num_box_decoder_layers else None)
        # learned keypoint wh priors: the 17 COCO ones, then one per
        # keypoint past 17 (a parameter only when there are any)
        self.hw = nn.Parameter(torch.zeros(min(17, cfg.num_body_points), 2))
        n_extra = max(0, cfg.num_body_points - 17)
        self.hw_append = (nn.Parameter(torch.zeros(n_extra, 2)) if n_extra
                          else None)

    def _head(self, lid, hs, ref, n_dn, text, text_token_mask):
        """The output heads of decoder layer `lid`: its normed output hs
        and input references ref (the first `n_dn` rows dn queries) ->
        (logits, boxes, keypoints) of the matching queries and (logits,
        boxes) of the dn queries. A box layer heads every query, with zero
        keypoints; a pose layer heads each group's box query and its
        keypoint queries."""
        B = hs.shape[0]
        G, nb = self.cfg.num_groups, self.cfg.num_body_points
        if lid < self.cfg.num_box_decoder_layers:
            coord = torch.sigmoid(self.bbox_embed(hs).float()
                                  + inverse_sigmoid(ref))
            cls = contrastive_assign(hs, text, text_token_mask)
            dn = (cls[:, :n_dn], coord[:, :n_dn])
            cls, coord = cls[:, n_dn:], coord[:, n_dn:]
            kp = torch.zeros(B, cls.shape[1], nb * 3, device=hs.device)
            return cls, coord, kp, dn
        dn_h = hs[:, :n_dn]
        dn = (contrastive_assign(dn_h, text, text_token_mask),
              torch.sigmoid(self.bbox_embed(dn_h).float()
                            + inverse_sigmoid(ref[:, :n_dn])))
        hg = hs[:, n_dn:].reshape(B, G, nb + 1, -1)
        rg = inverse_sigmoid(ref[:, n_dn:].reshape(B, G, nb + 1, 4))
        coord = torch.sigmoid(self.bbox_embed(hg[:, :, 0]).float()
                              + rg[:, :, 0])
        cls = contrastive_assign(hg[:, :, 0], text, text_token_mask)
        xy = torch.sigmoid(rg[:, :, 1:, :2]
                           + self.pose_embed(hg[:, :, 1:]).float())
        v = torch.sigmoid(torch.ones(B, G, nb, device=hs.device))
        kp = torch.cat([xy.reshape(B, G, nb * 2), v], -1)
        return cls, coord, kp, dn

    def forward(self, pixel_values: torch.Tensor, obj_querys: torch.Tensor,
                obj_query_masks: torch.Tensor, kpt_querys: torch.Tensor,
                kpt_query_masks: torch.Tensor,
                pixel_mask: Optional[torch.Tensor] = None,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                dn_noise: Optional[Dict[str, torch.Tensor]] = None,
                all_layers: bool = False,
                topk_idx: Optional[torch.Tensor] = None,
                group_idx: Optional[torch.Tensor] = None
                ) -> Dict[str, object]:
        """`targets` (labels [B, N], boxes [B, N, 4], valid [B, N]) with
        `dn_noise` (`train.cdn.draw_cdn_noise`) build the CDN queries from
        the projected object queries. With `all_layers=True` every decoder
        layer is headed: all_logits, all_boxes, all_keypoints (lists, one
        entry a layer), and with CDN queries dn_logits and dn_boxes (one
        entry a layer) and dn_targets."""
        cfg = self.cfg
        d, nb, G = cfg.d_model, cfg.num_body_points, cfg.num_groups
        dt = self.level_embed.dtype
        B, H, W, _ = pixel_values.shape
        dev = pixel_values.device
        if pixel_mask is None:
            pixel_mask = torch.ones(B, H, W, dtype=torch.bool, device=dev)
        pixel_values = pixel_values.to(dt)

        # text queries: object classes, and keypoint embeddings zeroed at
        # invalid slots, cropped or padded to num_body_points
        encoded_text = self.projection_llava(obj_querys.to(dt)).mean(dim=-2)
        kpt_valid = kpt_query_masks.bool()
        kpt_embed = self.projection_kpt_llava(kpt_querys.to(dt)).mean(dim=-2)
        kpt_embed = kpt_embed.masked_fill(~kpt_valid[..., None], 0.0)[:, :nb]
        kpt_vis = kpt_valid[:, :nb]
        if kpt_embed.shape[1] < nb:
            kpt_embed = F.pad(kpt_embed, (0, 0, 0, nb - kpt_embed.shape[1]))
            kpt_vis = F.pad(kpt_vis, (0, nb - kpt_vis.shape[1]))
        kpt_mask = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=dev),
                              kpt_vis], 1)                      # [B, 1+nb]

        text_token_mask = obj_query_masks.bool()
        text_self_attn_mask, text_position_ids = (
            generate_masks_with_text_query_masks(obj_query_masks))
        text_pos = get_sine_pos_embed(
            text_position_ids[..., None].float(), num_pos_feats=d,
            exchange_xy=False).to(dt)

        feats = self.backbone(pixel_values)
        sources = [_nchw(getattr(self, f"input_proj_norm_{i}"),
                         _nchw(getattr(self, f"input_proj_{i}"), feats[i]))
                   for i in range(3)]
        sources.append(_nchw(self.input_proj_norm_3,
                             _nchw(self.input_proj_3, feats[-1])))
        masks_l, pos_l = [], []
        for x in sources:
            m = _downsample_mask(pixel_mask, x.shape[1:3])
            masks_l.append(m)
            pos_l.append(sine_position_embedding(
                m, d, temperature=cfg.pe_temperature))
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in sources)
        src_flat = torch.cat([s.reshape(B, -1, d) for s in sources], 1)
        mask_flat = torch.cat([m.reshape(B, -1) for m in masks_l], 1)
        pos_flat = torch.cat(
            [(p + self.level_embed[i].float()).reshape(B, -1, d)
             for i, p in enumerate(pos_l)], 1).to(dt)
        valid_ratios = torch.stack([_valid_ratio(m) for m in masks_l], 1)

        ref_pts = encoder_reference_points(spatial_shapes, valid_ratios)
        vision, text = src_flat, encoded_text
        vision_pad, text_pad = ~mask_flat, ~text_token_mask
        for i in range(cfg.encoder_layers):
            vision, text = getattr(self, f"encoder_layer_{i}")(
                vision, text, vision_pos=pos_flat,
                spatial_shapes=spatial_shapes, reference_points=ref_pts,
                vision_pad_mask=vision_pad, text_pad_mask=text_pad,
                text_self_attn_mask=text_self_attn_mask, text_pos=text_pos)

        # two-stage: top proposals as references, learned target content
        oq, proposals = encoder_proposals(vision, mask_flat, spatial_shapes)
        oq = self.enc_output_norm(self.enc_output(oq))
        enc_class = contrastive_assign(oq, text, text_token_mask)
        enc_coord = self.enc_out_bbox_embed(oq).float() + proposals
        if topk_idx is None:
            topk_idx = torch.topk(enc_class.amax(-1), cfg.num_queries,
                                  dim=1).indices
        ref_logit = torch.gather(enc_coord, 1,
                                 topk_idx[..., None].expand(-1, -1, 4))
        # the decoder starts from the proposals without their gradient
        reference_points = torch.sigmoid(ref_logit.detach())
        hidden = self.tgt_embed[None].expand(B, -1, -1)
        self_attn_mask = dn_attn_mask = dn_targets = None
        n_dn = 0
        if targets is not None and dn_noise is not None and cfg.dn_number > 0:
            dn, dn_targets = build_cdn_queries(
                dn_noise, targets, encoded_text, obj_query_masks,
                dn_number=cfg.dn_number, num_queries=cfg.num_queries)
            n_dn = dn["pad_size"]
            hidden = torch.cat([dn["query_label"].to(hidden.dtype), hidden], 1)
            reference_points = torch.cat(
                [torch.sigmoid(dn["query_bbox"]), reference_points], 1)
            self_attn_mask = dn["attn_mask"]
            # after the expansion: the CDN groups over the dn block, every
            # pose query visible
            dn_attn_mask = F.pad(self_attn_mask[:, :n_dn, :n_dn],
                                 (0, G * (nb + 1)))
        # post-expansion self-attention: slots attend only to slots of the
        # same validity within their group
        group_mask = kpt_mask[:, :, None] != kpt_mask[:, None, :]

        vr2 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
        # each layer's normed output and input references: the heads keep
        # the references' gradient, the next layer starts without it
        hiddens, refs = [], [reference_points]
        expanded = False
        for lid in range(cfg.decoder_layers):
            ref_input = reference_points[:, :, None] * vr2
            sine = get_sine_pos_embed(ref_input[:, :, 0, :],
                                      num_pos_feats=d // 2, exchange_xy=True)
            query_pos = self.ref_point_head(sine.to(dt))
            hidden = getattr(self, f"decoder_layer_{lid}")(
                hidden, query_pos=query_pos, reference_points=ref_input,
                spatial_shapes=spatial_shapes, vision=vision,
                vision_valid_mask=mask_flat, text=text,
                text_pad_mask=text_pad,
                self_attn_mask=None if expanded else self_attn_mask,
                groups=G if expanded else None,
                group_mask=group_mask if expanded else None,
                n_dn=n_dn if expanded else 0,
                dn_attn_mask=dn_attn_mask if expanded else None)
            if all_layers or lid == cfg.decoder_layers - 1:
                hiddens.append((lid, self.decoder_norm(hidden)))

            if lid < cfg.num_box_decoder_layers:
                new_ref = torch.sigmoid(self.bbox_embed(hidden).float()
                                        + inverse_sigmoid(reference_points))
            if lid == cfg.num_box_decoder_layers - 1:
                # box -> keypoint expansion of the top G boxes; the dn
                # queries ride ahead of the groups
                if group_idx is None:
                    match_cls = contrastive_assign(hidden[:, n_dn:], text,
                                                   text_token_mask)
                    group_idx = torch.topk(match_cls.amax(-1), G,
                                           dim=1).indices
                box_ref = torch.gather(new_ref[:, n_dn:], 1,
                                       group_idx[..., None].expand(-1, -1, 4))
                box_out = torch.gather(hidden[:, n_dn:], 1,
                                       group_idx[..., None].expand(-1, -1, d))
                kpt_out = kpt_embed[:, None].expand(B, G, nb, d)
                kpt_xy = torch.sigmoid(
                    inverse_sigmoid(box_ref[..., None, :2])
                    + self.pose_embed(kpt_out).float())
                hw = self.hw if self.hw_append is None else torch.cat(
                    [self.hw, self.hw_append])
                kpt_wh = torch.sigmoid(hw.float())[None, None] \
                    * box_ref[..., None, 2:]
                exp_ref = torch.cat(
                    [box_ref[:, :, None], torch.cat([kpt_xy, kpt_wh], -1)],
                    2).reshape(B, G * (nb + 1), 4)
                new_ref = torch.cat([new_ref[:, :n_dn], exp_ref], 1)
                hidden = torch.cat(
                    [hidden[:, :n_dn],
                     torch.cat([box_out[:, :, None], kpt_out],
                               2).reshape(B, G * (nb + 1), d)], 1)
                expanded = True
            elif lid >= cfg.num_box_decoder_layers:
                # separate box / keypoint refinement; dn queries box-style
                hg = hidden[:, n_dn:].reshape(B, G, nb + 1, d)
                rg = inverse_sigmoid(
                    reference_points[:, n_dn:].reshape(B, G, nb + 1, 4))
                box_new = torch.sigmoid(self.bbox_embed(hg[:, :, 0]).float()
                                        + rg[:, :, 0])
                kpt_new = torch.sigmoid(torch.cat(
                    [rg[:, :, 1:, :2] + self.pose_embed(hg[:, :, 1:]).float(),
                     rg[:, :, 1:, 2:]
                     + self.pose_hw_embed(hg[:, :, 1:]).float()], -1))
                new_ref = torch.cat([box_new[:, :, None], kpt_new],
                                    2).reshape(B, G * (nb + 1), 4)
                if n_dn:
                    dn_new = torch.sigmoid(
                        self.bbox_embed(hidden[:, :n_dn]).float()
                        + inverse_sigmoid(reference_points[:, :n_dn]))
                    new_ref = torch.cat([dn_new, new_ref], 1)
            reference_points = new_ref.detach()
            refs.append(new_ref)

        heads = [self._head(lid, hs, refs[lid], n_dn, text, text_token_mask)
                 for lid, hs in hiddens]
        cls, coord, kp, _ = heads[-1]
        out = {
            "pred_logits": cls,
            "pred_boxes": coord,
            "pred_keypoints": kp,
            # the two-stage loss supervises the selected proposals, with
            # their gradient
            "enc_logits": torch.gather(
                enc_class, 1,
                topk_idx[..., None].expand(-1, -1, enc_class.shape[-1])),
            "enc_boxes": torch.sigmoid(ref_logit),
            "topk_idx": topk_idx,
            "group_idx": group_idx,
        }
        if all_layers:
            out["all_logits"] = [h[0] for h in heads]
            out["all_boxes"] = [h[1] for h in heads]
            out["all_keypoints"] = [h[2] for h in heads]
        if dn_targets is not None:
            out["dn_logits"] = [h[3][0] for h in heads]
            out["dn_boxes"] = [h[3][1] for h in heads]
            out["dn_targets"] = dn_targets
        return out
