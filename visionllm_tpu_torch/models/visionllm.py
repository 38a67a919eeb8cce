"""The composite VisionLLM core: vision encoder -> VL bridge -> LLM, with
super-link routing of [EMB] hidden states to the tool decoders.

Counterpart of `visionllm_tpu/models/visionllm.py` for the det, chat and
generation paths: the vision tower (CLIP-ViT, or InternViT with pixel shuffle
before the bridge), token embeddings, the [EMB]-table splice, the <im_patch>
image-feature scatter (flattened for [N, H, W, 3] images, per sample for
[B, T, H, W, 3] tile stacks), the region encoder's <region> rows
(`encode_regions`, from the last three ViT levels of the same vision
pass), the LLM prefill with an optional KV cache,
the decode step `llm_step`, the cached extend window `llm_window`,
`new_cache` (an int8 one under `kv_quant="int8"`), `extract_text_query`
and `extract_gen_embs`. Every step is a
fixed-shape tensor op, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.config import VisionLLMConfig
from visionllm_tpu_torch.models.clip_vit import ClipVisionTower
from visionllm_tpu_torch.models.intern_vit import InternVisionTower
from visionllm_tpu_torch.models.llama import KVCache, LlamaModel
from visionllm_tpu_torch.models.region_encoder import (LayerNorm2d,
                                                       RegionEncoder)
from visionllm_tpu_torch.models.vl_bridge import VLBridge, pixel_shuffle
from visionllm_tpu_torch.parallel.global_batch import data_group, global_sum


@dataclasses.dataclass(frozen=True)
class SpecialTokenIds:
    """Token ids of the routing vocabulary."""

    pad: int
    img: int
    imp: int
    reg: int
    emb: int          # [EMB]; [EMB2..8] are emb+1..emb+7 (contiguous)
    det: int
    grd: int
    seg: int
    pose: int
    gen: int
    edit: int

    @classmethod
    def from_tokenizer(cls, tok) -> "SpecialTokenIds":
        t = C.DEFAULT_TOKENS
        get = lambda k: tok.convert_tokens_to_ids(t[k])  # noqa: E731
        ids = cls(pad=tok.pad_token_id, img=get("img"), imp=get("imp"),
                  reg=get("reg"), emb=get("emb"), det=get("det"),
                  grd=get("grd"), seg=get("seg"), pose=get("pose"),
                  gen=get("gen"), edit=get("edit"))
        # the [EMB]..[EMB8] block must be contiguous (routing relies on it)
        if get("emb8") != ids.emb + 7:
            raise ValueError("the tokenizer's [EMB] ids are not contiguous")
        return ids

    @classmethod
    def synthetic(cls, base: int = 32000) -> "SpecialTokenIds":
        """Id layout matching the reference's token-addition order."""
        order = ["img", "imp", "reg", "boi", "eoi", "sor", "eor", "sod",
                 "eod", "sog", "eog", "det", "grd", "seg", "pose", "gen",
                 "edit", "emb", "emb2", "emb3", "emb4", "emb5", "emb6",
                 "emb7", "emb8"]
        ids = {k: base + i for i, k in enumerate(order)}
        return cls(pad=0, img=ids["img"], imp=ids["imp"], reg=ids["reg"],
                   emb=ids["emb"], det=ids["det"], grd=ids["grd"],
                   seg=ids["seg"], pose=ids["pose"], gen=ids["gen"],
                   edit=ids["edit"])


def tool_context(input_ids: torch.Tensor, tid: SpecialTokenIds
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position (tool_code, last_tool_position): the code and position
    of the last tool token at or before each position, (0, 0) where there
    is none (the JAX inclusive "last non-zero" scan)."""
    code = torch.zeros_like(input_ids)
    for ids, c in (((tid.det, tid.seg, tid.grd), C.TOOL_DET),
                   ((tid.pose,), C.TOOL_POSE),
                   ((tid.gen,), C.TOOL_GEN),
                   ((tid.edit,), C.TOOL_EDIT)):
        for t in ids:
            code = torch.where(input_ids == t, torch.full_like(code, c), code)
    L = input_ids.shape[-1]
    pos = torch.arange(L, device=input_ids.device).expand_as(input_ids)
    last = torch.where(code != 0, pos, torch.full_like(pos, -1))
    last = torch.cummax(last, dim=-1).values
    found = last >= 0
    last = last.clamp(min=0)
    ctx = torch.where(found, torch.gather(code, -1, last),
                      torch.zeros_like(code))
    return ctx, last


def compact_masked_rows(x: torch.Tensor, mask: torch.Tensor, out_len: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather rows where mask is True, in order, into [B, out_len, C];
    second return is the valid-slot mask [B, out_len]."""
    B, L, Cdim = x.shape
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    if out_len > L:       # surplus slots read row 0 and are masked off
        order = torch.cat([order, order.new_zeros(B, out_len - L)], dim=1)
    idx = order[:, :out_len]
    rows = torch.gather(x, 1, idx[..., None].expand(-1, -1, Cdim))
    counts = mask.sum(1)
    valid = (torch.arange(out_len, device=x.device)[None, :]
             < counts[:, None])
    return torch.where(valid[..., None], rows, torch.zeros_like(rows)), valid


class VisionLLM(nn.Module):
    def __init__(self, cfg: VisionLLMConfig):
        super().__init__()
        self.cfg = cfg
        hid = cfg.llm.hidden_size
        tower = (InternVisionTower if cfg.vis_encoder.arch == "intern_vit"
                 else ClipVisionTower)
        self.vis_encoder = tower(cfg.vis_encoder)
        # pixel shuffle folds 2x2 patches into one token of 4x the width
        width = cfg.vis_encoder.hidden_size * (4 if cfg.use_pixelshuffle
                                               else 1)
        self.vl_bridge = VLBridge(cfg.vl_bridge_type, width, hid)
        self.llm = LlamaModel(cfg.llm)
        self.emb_embeddings_det = nn.Parameter(torch.zeros(cfg.num_embs, hid))
        self.emb_embeddings_pose = nn.Parameter(torch.zeros(cfg.num_embs, hid))
        self.emb_embeddings_gen = nn.Parameter(
            torch.zeros(cfg.num_embs_gen, hid))
        self.emb_embeddings_edit = nn.Parameter(
            torch.zeros(cfg.num_embs_gen, hid))
        self.region_encoder = (RegionEncoder(cfg.region_encoder)
                               if cfg.use_region_encoder else None)

    def fp32_modules(self):
        """The modules that keep fp32 parameters under a bf16 core: the
        region encoder's channel LayerNorms (flax creates them fp32)."""
        if self.region_encoder is not None:
            yield from (m for m in self.region_encoder.modules()
                        if isinstance(m, LayerNorm2d))

    def encode_images(self, images: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [N, H, W, 3] NHWC -> (llm-space features [N, P, hid],
        all ViT hidden states [n_layers + 1, N, 1 + P, D]). Tile stacks
        [B, T, H, W, 3] are flattened to [B*T, ...] first. With
        `use_pixelshuffle` the patch grid is shuffled at 0.5 first, so P
        is a quarter of the patches (256 a 448 px tile)."""
        if images.ndim == 5:
            images = images.reshape(-1, *images.shape[2:])
        hs = self.vis_encoder(images)
        feats = hs[self.cfg.vis_encoder.output_layer][:, 1:]   # drop CLS
        if self.cfg.use_pixelshuffle:
            N, P, D = feats.shape
            side = int(P ** 0.5)
            feats = pixel_shuffle(feats.reshape(N, side, side, D), 0.5)
            feats = feats.reshape(N, -1, feats.shape[-1])
        return self.vl_bridge(feats), hs

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.llm.embed(input_ids)

    def encode_regions(self, images: torch.Tensor, region_masks: torch.Tensor,
                       vit_hs: torch.Tensor, image_index: torch.Tensor
                       ) -> torch.Tensor:
        """Region features [n_reg, hid] for <region> tokens: images
        [n_reg, H, W, 3] (each region's image), masks [n_reg, H, W], the
        ViT hidden states `encode_images` returned and, per region, the
        index of its image in them; the last three levels with the CLS
        row dropped (no second ViT pass)."""
        feats = [vit_hs[lvl][image_index, 1:] for lvl in (-3, -2, -1)]
        return self.region_encoder(images, region_masks, feats)

    def new_cache(self, batch: int, max_len: int) -> KVCache:
        """An empty KV cache for this core on its device: int8 with
        scales when `cfg.llm.kv_quant == "int8"`, else the model dtype
        (the cache JAX's generate and slot functions create,
        `generation.py:245-247`)."""
        w = self.llm.norm.weight
        dtype = torch.int8 if self.cfg.llm.kv_quant == "int8" else w.dtype
        return KVCache.create(self.cfg.llm, batch, max_len, dtype, w.device,
                              self.llm.tp_size)

    def splice_emb_embeddings(self, inputs_embeds: torch.Tensor,
                              input_ids: torch.Tensor,
                              tid: SpecialTokenIds) -> torch.Tensor:
        """Replace rows at [EMB]-range positions with the owning tool's
        learnable embeddings."""
        cfg = self.cfg
        ctx, last_pos = tool_context(input_ids, tid)
        L = input_ids.shape[-1]
        pos = torch.arange(L, device=input_ids.device).expand_as(input_ids)
        is_emb = (input_ids >= tid.emb) & (input_ids < tid.emb + cfg.num_embs)
        off_p = (input_ids - tid.emb).clamp(0, cfg.num_embs - 1)
        off_g = (pos - last_pos - 1).clamp(0, cfg.num_embs_gen - 1)
        dt = inputs_embeds.dtype
        out = inputs_embeds
        for code, rows in ((C.TOOL_DET, self.emb_embeddings_det[off_p]),
                           (C.TOOL_POSE, self.emb_embeddings_pose[off_p]),
                           (C.TOOL_GEN, self.emb_embeddings_gen[off_g]),
                           (C.TOOL_EDIT, self.emb_embeddings_edit[off_g])):
            sel = (is_emb & (ctx == code))[..., None]
            out = torch.where(sel, rows.to(dt), out)
        return out

    @staticmethod
    def scatter_image_features(inputs_embeds: torch.Tensor,
                               input_ids: torch.Tensor,
                               image_features: torch.Tensor,
                               imp_token_id: int) -> torch.Tensor:
        """Write image features into the <im_patch> slots in flattened
        batch-major order."""
        B, L, Cdim = inputs_embeds.shape
        flat_sel = (input_ids == imp_token_id).reshape(-1)
        feats = image_features.reshape(-1, Cdim).to(inputs_embeds.dtype)
        src = (torch.cumsum(flat_sel.long(), 0) - 1).clamp(0, feats.shape[0] - 1)
        out = torch.where(flat_sel[:, None], feats[src],
                          inputs_embeds.reshape(-1, Cdim))
        return out.reshape(B, L, Cdim)

    @staticmethod
    def scatter_image_features_per_sample(inputs_embeds: torch.Tensor,
                                          input_ids: torch.Tensor,
                                          image_features: torch.Tensor,
                                          imp_token_id: int) -> torch.Tensor:
        """Per-sample variant for tile stacks: sample b's k-th <im_patch>
        reads image_features[b, k] ([B, F, C])."""
        F = image_features.shape[1]
        sel = input_ids == imp_token_id
        src = (torch.cumsum(sel.long(), dim=1) - 1).clamp(0, F - 1)
        gathered = torch.gather(
            image_features.to(inputs_embeds.dtype), 1,
            src[..., None].expand(-1, -1, image_features.shape[-1]))
        return torch.where(sel[..., None], gathered, inputs_embeds)

    def extract_text_query(self, hidden: torch.Tensor,
                           input_ids: torch.Tensor, tid: SpecialTokenIds,
                           max_patches: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[EMB]-position hidden states -> text_query
        [B, max_patches, num_embs, C] + mask [B, max_patches]."""
        cfg = self.cfg
        max_patches = max_patches or cfg.max_num_patches
        emb_sel = (input_ids >= tid.emb) & (input_ids < tid.emb + cfg.num_embs)
        rows, valid = compact_masked_rows(hidden, emb_sel,
                                          max_patches * cfg.num_embs)
        B, _, Cdim = hidden.shape
        tq = rows.reshape(B, max_patches, cfg.num_embs, Cdim)
        tq_mask = valid.reshape(B, max_patches, cfg.num_embs)[..., 0]
        return tq, tq_mask

    def extract_gen_embs(self, hidden: torch.Tensor,
                         input_ids: torch.Tensor, tid: SpecialTokenIds,
                         tool_code: int) -> torch.Tensor:
        """Hidden states at the num_embs_gen [EMB] rows after [GEN] or
        [EDIT] (`tool_code` C.TOOL_GEN or C.TOOL_EDIT; one trigger a
        sample) -> [B, num_embs_gen, C]."""
        cfg = self.cfg
        ctx, _ = tool_context(input_ids, tid)
        is_emb = (input_ids >= tid.emb) & (input_ids < tid.emb + cfg.num_embs)
        rows, _ = compact_masked_rows(hidden, is_emb & (ctx == tool_code),
                                      cfg.num_embs_gen)
        return rows

    def build_prompt_embeds(self, input_ids: torch.Tensor,
                            images: Optional[torch.Tensor],
                            tid: SpecialTokenIds,
                            regions: Optional[torch.Tensor] = None,
                            region_features: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token embeddings + [EMB] splice + image-feature scatter
        (per sample for [B, T, H, W, 3] tile stacks, as at
        `visionllm.py:405-415` of the JAX package) + region rows. Returns
        (inputs_embeds, ignore_flag): the flag is 1.0 when the
        <im_patch> count does not fit the image features (more than the
        tile stack holds, or not exactly the flat images' count), which
        zeroes the LM loss instead of training on misaligned features
        (JAX `visionllm.py:385-404`), else 0.0.

        `regions` [B, R, H, W] are binary prompt masks on each sample's
        image (the last tile of a stack, its global view): every slot
        runs through the region encoder, the empty ones are compacted
        away, and the valid rows fill the <region> tokens in flattened
        order (JAX `visionllm.py:419-440`). `region_features` [n, hid]
        fill them directly."""
        inputs_embeds = self.embed_tokens(input_ids)
        inputs_embeds = self.splice_emb_embeddings(inputs_embeds, input_ids,
                                                   tid)
        ignore_flag = torch.zeros((), dtype=torch.float32,
                                  device=input_ids.device)
        if regions is not None and (self.region_encoder is None
                                    or images is None):
            raise ValueError("region prompts need a region encoder "
                             "(use_region_encoder=True) and the images "
                             "they refer to")
        if images is not None:
            image_features, vit_hs = self.encode_images(images)
            n_imp = (input_ids == tid.imp).sum()
            expected = image_features.shape[0] * image_features.shape[1]
            if data_group() is not None:
                # the global batch's counts: the flag gates its LM loss
                # as one, as in JAX
                n_imp = global_sum(n_imp)
                expected = global_sum(torch.tensor(expected,
                                                   device=n_imp.device))
            bad = n_imp > expected if images.ndim == 5 else n_imp != expected
            ignore_flag = bad.float()
            if images.ndim == 5:
                B, T = images.shape[:2]
                feats = image_features.reshape(
                    B, T * image_features.shape[1], -1)
                inputs_embeds = self.scatter_image_features_per_sample(
                    inputs_embeds, input_ids, feats, tid.imp)
            else:
                inputs_embeds = self.scatter_image_features(
                    inputs_embeds, input_ids, image_features, tid.imp)
        if regions is not None:
            B, R = regions.shape[:2]
            dev = input_ids.device
            if images.ndim == 5:        # a tile stack: the last tile
                T = images.shape[1]
                base = images[:, -1]
                sample_idx = (torch.arange(B, device=dev) + 1) * T - 1
            else:
                base = images
                sample_idx = torch.arange(B, device=dev)
            masks = regions.reshape(B * R, *regions.shape[2:])
            feats = self.encode_regions(
                base.repeat_interleave(R, dim=0), masks, vit_hs,
                sample_idx.repeat_interleave(R))              # [B*R, hid]
            valid = masks.reshape(B * R, -1).sum(-1) > 0
            rows, _ = compact_masked_rows(feats[None], valid[None], B * R)
            inputs_embeds = self.scatter_image_features(
                inputs_embeds, input_ids, rows[0][:, None, :], tid.reg)
        if region_features is not None:
            inputs_embeds = self.scatter_image_features(
                inputs_embeds, input_ids, region_features[:, None, :],
                tid.reg)
        return inputs_embeds, ignore_flag

    def forward(self, input_ids: torch.Tensor, images: Optional[torch.Tensor],
                tid: SpecialTokenIds, attn_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                compute_logits: bool = True,
                regions: Optional[torch.Tensor] = None,
                region_features: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Returns dict(hidden, logits, ignore_flag): the prefill over the
        assembled prompt (with the region rows of `regions` [B, R, H, W]
        or `region_features`, `build_prompt_embeds`); a given cache is
        filled from its index on."""
        inputs_embeds, ignore_flag = self.build_prompt_embeds(
            input_ids, images, tid, regions=regions,
            region_features=region_features)
        if positions is None:
            B, L = input_ids.shape
            positions = torch.arange(L, device=input_ids.device).expand(B, L)
        hidden, logits = self.llm(inputs_embeds, positions,
                                  attn_mask=attn_mask, cache=cache,
                                  compute_logits=compute_logits)
        return {"hidden": hidden, "logits": logits,
                "ignore_flag": ignore_flag}

    def llm_step(self, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                 cache: KVCache, attn_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """One decode step on pre-built embeddings [B, 1, C]; the cache's
        index may hold one fill level per row."""
        hidden, logits = self.llm(inputs_embeds, positions,
                                  attn_mask=attn_mask, cache=cache)
        return {"hidden": hidden, "logits": logits}

    def llm_window(self, inputs_embeds: torch.Tensor,
                   positions: torch.Tensor, cache: KVCache,
                   attn_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """W tokens [B, W, C] in one cached forward (JAX
        `visionllm.py:319-335`): appended at the cache's index, each
        attending the history and the causal part of the window under the
        buffer-valid mask [B, max_len]. Chunked prefill and session
        extension run on it."""
        hidden, logits = self.llm(inputs_embeds, positions,
                                  attn_mask=attn_mask, cache=cache,
                                  extend=True)
        return {"hidden": hidden, "logits": logits}
