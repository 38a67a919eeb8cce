"""Composite model: VisionLLM core (with the region encoder when the
config turns it on) + Grounding-DINO + UniPose + the [GEN] and [EDIT]
heads in one module tree, with the det-VQA inference entry `infer_det`
(region prompts through `regions`), the pose inference entry
`infer_pose` and the training forwards `forward_chat`, `forward_det`,
`forward_pose`, `forward_gen` and `forward_edit` (counterpart of
`visionllm_tpu/models/composite.py:39-155`, `:156-180`). The heads'
inference entries are their own `generate` methods (`model.sd`,
`model.ip2p`).

`build_model` is the entry point: it builds the model on CUDA unless the
caller names another device, in the requested dtype (bf16 by default, as
the JAX package deploys the whole composite), with weights drawn from a
seeded `torch.Generator`; the heads' mappers and norms and the region
encoder's LayerNorms stay fp32, as flax keeps them (`fp32_modules`).
`build_core` does the same for the `VisionLLM`
core alone (the chat path) and quantizes its LLM when `cfg.llm.quant`
is "int4", "int8" or "w8a8". `build_model(cfg, state_dict=...)` fills
the model from a converted reference checkpoint instead
(`utils.torch_convert.convert_composite`); a JAX-package param tree
loads with `utils.convert.load_jax_params`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.config import VisionLLMConfig
from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.models.common import init_weights
from visionllm_tpu_torch.models.grounding_dino.model import GroundingDino
from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
    InstructPix2PixWithLLMEmb, StableDiffusionWithLLMEmb)
from visionllm_tpu_torch.models.unipose.model import UniPose
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds, VisionLLM
from visionllm_tpu_torch.ops.quant import quantize_serving_params
from visionllm_tpu_torch.train.losses import lm_cross_entropy
from visionllm_tpu_torch.utils.torch_convert import load_converted


class VisionLLMWithTools(nn.Module):
    """The core with the tools `cfg` turns on: `gdino` (`use_gdino`) for
    det, grounding and segmentation, `unipose` (`use_unipose`) for pose,
    `sd` (`use_sd`) for [GEN] and `ip2p` (`use_ip2p`) for [EDIT]; with
    none it trains the chat group alone (`forward_chat`), as the JAX
    composite does. An entry point raises when its tool is missing."""

    def __init__(self, cfg: VisionLLMConfig):
        super().__init__()
        self.cfg = cfg
        self.core = VisionLLM(cfg)
        self.gdino = GroundingDino(cfg.gdino) if cfg.use_gdino else None
        self.unipose = UniPose(cfg.unipose) if cfg.use_unipose else None
        self.sd = StableDiffusionWithLLMEmb(cfg.sd) if cfg.use_sd else None
        self.ip2p = (InstructPix2PixWithLLMEmb(cfg.ip2p) if cfg.use_ip2p
                     else None)

    def fp32_modules(self):
        """The modules that keep fp32 parameters under a bf16 model: the
        region encoder's LayerNorms and the generation heads' mappers,
        GroupNorms and LayerNorms."""
        yield from self.core.fp32_modules()
        for head in (self.sd, self.ip2p):
            if head is not None:
                yield from head.fp32_modules()

    def _tool(self, name: str) -> nn.Module:
        tool = getattr(self, name)
        if tool is None:
            raise ValueError(f"this model has no {name} tool (use_{name}="
                             "False)")
        return tool

    @torch.no_grad()
    def infer_det(self, input_ids: torch.Tensor, images: torch.Tensor,
                  images_aug: torch.Tensor, tid: SpecialTokenIds,
                  pixel_mask: Optional[torch.Tensor] = None,
                  regions: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """Single-image det given a ready prompt: ViT encode -> bridge ->
        LLM prefill -> [EMB] text queries -> Grounding-DINO.

        input_ids [B, L]; images [N, H, W, 3] CLIP pixels (NHWC);
        images_aug [B, H', W', 3] det pixels (NHWC); `regions`
        [B, R, H, W] visual-prompt masks for the prompt's <region>
        tokens."""
        gdino = self._tool("gdino")
        out = self.core(input_ids, images, tid, compute_logits=False,
                        regions=regions)
        tq, tq_mask = self.core.extract_text_query(out["hidden"], input_ids,
                                                   tid)
        return gdino(images_aug, tq, tq_mask, pixel_mask=pixel_mask)

    @torch.no_grad()
    def infer_pose(self, input_ids: torch.Tensor, images: torch.Tensor,
                   images_aug: torch.Tensor, tid: SpecialTokenIds,
                   num_obj_patches: int,
                   pixel_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Pose given a ready prompt that carries [DET][EMB..] blocks for
        the object classes, then one [POSE][EMB..] block per keypoint:
        the first `num_obj_patches` text queries are UniPose's object
        queries, the rest its keypoint queries."""
        unipose = self._tool("unipose")
        out = self.core(input_ids, images, tid, compute_logits=False)
        tq, tq_mask = self.core.extract_text_query(out["hidden"], input_ids,
                                                   tid)
        n = num_obj_patches
        return unipose(images_aug, tq[:, :n], tq_mask[:, :n], tq[:, n:],
                       tq_mask[:, n:], pixel_mask=pixel_mask)

    def forward_chat(self, batch: Dict[str, torch.Tensor],
                     tid: SpecialTokenIds) -> Dict[str, torch.Tensor]:
        """The chat group's training forward (chat, VQA, caption and region
        batches): the LM cross entropy, times (1 - ignore_flag) (JAX
        `composite.py:59-71`); `batch["regions"]` [B, R, H, W], when
        given, feeds the region encoder at the <region> tokens.
        Returns loss, lm_loss (the same), fp32 logits and ignore_flag."""
        out, loss = self._lm(batch, tid, regions=batch.get("regions"))
        return {"loss": loss, "lm_loss": loss, "logits": out["logits"],
                "ignore_flag": out["ignore_flag"]}

    def forward_det(self, batch: Dict[str, torch.Tensor],
                    tid: SpecialTokenIds,
                    dn_noise: Optional[Dict[str, torch.Tensor]] = None,
                    topk_idx: Optional[torch.Tensor] = None
                    ) -> Dict[str, object]:
        """The det training forward: LLM loss (zeroed by the core's
        ignore_flag) + [EMB] text queries + Grounding-DINO with every
        decoder layer headed. With `dn_noise` (`train.cdn.draw_cdn_noise`)
        CDN queries are built from `batch["targets"]`; `topk_idx` repeats
        a given two-stage proposal selection.

        batch: input_ids / labels / attn_mask [B, L], images (CLIP pixels
        NHWC), images_aug (det pixels NHWC), pixel_mask?, targets."""
        out, lm_loss = self._lm(batch, tid)
        tq, tq_mask = self.core.extract_text_query(
            out["hidden"], batch["input_ids"], tid)
        det = self._tool("gdino")(batch["images_aug"], tq, tq_mask,
                         pixel_mask=batch.get("pixel_mask"),
                         targets=batch.get("targets") if dn_noise is not None
                         else None,
                         dn_noise=dn_noise, all_layers=True,
                         topk_idx=topk_idx)
        det["text_mask"] = _text_mask(tq_mask, self.cfg.gdino.max_text_len)
        return {"lm_loss": lm_loss, "det": det,
                "ignore_flag": out["ignore_flag"]}

    def _lm(self, batch: Dict[str, torch.Tensor], tid: SpecialTokenIds,
            regions: Optional[torch.Tensor] = None
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The core's prefill over the batch and its LM loss, zeroed by
        the core's ignore_flag."""
        out = self.core(batch["input_ids"], batch.get("images"), tid,
                        attn_mask=batch.get("attn_mask"), regions=regions)
        lm_loss = (lm_cross_entropy(out["logits"], batch["labels"])
                   * (1.0 - out["ignore_flag"]))
        return out, lm_loss

    def forward_pose(self, batch: Dict[str, torch.Tensor],
                     tid: SpecialTokenIds, num_obj_patches: int,
                     dn_noise: Optional[Dict[str, torch.Tensor]] = None,
                     topk_idx: Optional[torch.Tensor] = None,
                     group_idx: Optional[torch.Tensor] = None
                     ) -> Dict[str, object]:
        """The pose training forward: LLM loss + [EMB] text queries, the
        first `num_obj_patches` UniPose's object queries and the rest its
        keypoint queries + UniPose with every decoder layer headed. With
        `dn_noise` CDN queries are built from `batch["targets"]`;
        `topk_idx` and `group_idx` repeat given selections.

        batch: input_ids / labels / attn_mask, images, images_aug,
        pixel_mask?, targets (labels, boxes, keypoints, area, valid)."""
        out, lm_loss = self._lm(batch, tid)
        tq, tq_mask = self.core.extract_text_query(
            out["hidden"], batch["input_ids"], tid)
        n = num_obj_patches
        pose = self._tool("unipose")(
            batch["images_aug"], tq[:, :n], tq_mask[:, :n], tq[:, n:],
            tq_mask[:, n:], pixel_mask=batch.get("pixel_mask"),
            targets=batch.get("targets") if dn_noise is not None else None,
            dn_noise=dn_noise, all_layers=True, topk_idx=topk_idx,
            group_idx=group_idx)
        return {"lm_loss": lm_loss, "pose": pose,
                "ignore_flag": out["ignore_flag"]}

    def forward_gen(self, batch: Dict[str, torch.Tensor],
                    tid: SpecialTokenIds,
                    generator: Optional[torch.Generator] = None, *,
                    noise: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, object]:
        """[GEN] batches: LM loss + the SD head's epsilon-prediction loss on
        the [GEN] rows (`VisionLLM.extract_gen_embs`) and
        `batch["output_images"]`; the head's draws from `generator` or
        `noise`."""
        out, lm_loss = self._lm(batch, tid)
        embs = self.core.extract_gen_embs(out["hidden"], batch["input_ids"],
                                          tid, C.TOOL_GEN)
        sd = self._tool("sd").train_loss(
            embs, batch["output_images"], generator, noise=noise,
            caption_embeds=batch.get("caption_embeds"))
        return {"lm_loss": lm_loss, "sd": sd, "loss": lm_loss + sd["loss"]}

    def forward_edit(self, batch: Dict[str, torch.Tensor],
                     tid: SpecialTokenIds,
                     generator: Optional[torch.Generator] = None, *,
                     noise: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, object]:
        """[EDIT] batches: LM loss + the IP2P head's epsilon-prediction loss
        on the [EDIT] rows, `batch["input_images"]` and
        `batch["output_images"]`."""
        out, lm_loss = self._lm(batch, tid)
        embs = self.core.extract_gen_embs(out["hidden"], batch["input_ids"],
                                          tid, C.TOOL_EDIT)
        ip = self._tool("ip2p").train_loss(
            embs, batch["input_images"], batch["output_images"], generator,
            noise=noise, caption_embeds=batch.get("caption_embeds"))
        return {"lm_loss": lm_loss, "ip2p": ip, "loss": lm_loss + ip["loss"]}


def _text_mask(tq_mask: torch.Tensor, max_text_len: int) -> torch.Tensor:
    """[B, P] query-slot validity -> [B, max_text_len] logit-column mask."""
    pad = max_text_len - tq_mask.shape[1]
    m = tq_mask.bool()
    return F.pad(m, (0, pad)) if pad > 0 else m[:, :max_text_len]


def build_model(cfg: VisionLLMConfig, *,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16,
                seed: int = 0,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None
                ) -> VisionLLMWithTools:
    """Build `VisionLLMWithTools` directly on `device` (CUDA when None;
    raises when there is none) in `dtype` (`fp32_modules` in fp32), with
    seeded random weights, or with `state_dict`'s (the port's keys, as
    `utils.torch_convert.convert_composite` gives them): the model is
    laid out on the meta device and each tensor assigned in its
    parameter's dtype, so no weight is drawn or held twice."""
    dev = resolve_device(device)
    if state_dict is not None:
        return load_converted(_meta_model(cfg, dtype), state_dict,
                              dev).eval()
    model = _meta_model(cfg, dtype).to_empty(device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


def _meta_model(cfg: VisionLLMConfig, dtype: torch.dtype
                ) -> VisionLLMWithTools:
    """The model laid out on the meta device in `dtype`, `fp32_modules`
    in fp32: shapes and dtypes, no storage."""
    with torch.device("meta"):
        model = VisionLLMWithTools(cfg).to(dtype=dtype)
        for mod in model.fp32_modules():
            mod.float()
    return model


def model_size(cfg: VisionLLMConfig,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """What `build_model(cfg, dtype=dtype)` will hold, counted on the host
    without allocating: {"params", "bytes"} of the parameters (the
    `fp32_modules` at 4 bytes)."""
    params = list(_meta_model(cfg, dtype).parameters())
    return {"params": sum(p.numel() for p in params),
            "bytes": sum(p.numel() * p.element_size() for p in params)}


def build_core(cfg: VisionLLMConfig, *,
               device: Optional[Union[str, torch.device]] = None,
               dtype: torch.dtype = torch.bfloat16,
               seed: int = 0) -> VisionLLM:
    """Build the `VisionLLM` core alone on `device` (CUDA when None;
    raises when there is none) in `dtype` (`fp32_modules` in fp32) with
    seeded random weights.
    With `cfg.llm.quant` set the LLM is drawn in `dtype` and then
    quantized one Linear at a time (`quantize_serving_params`: int4, or
    int8 for "int8" and "w8a8")."""
    dev = resolve_device(device)
    dense_cfg = dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, quant=""))
    with torch.device("meta"):
        core = VisionLLM(dense_cfg).to(dtype=dtype)
        for mod in core.fp32_modules():
            mod.float()
    core = core.to_empty(device=dev)
    init_weights(core, torch.Generator(device=dev).manual_seed(seed))
    if cfg.llm.quant:
        quantize_serving_params(core, bits=4 if cfg.llm.quant == "int4"
                                else 8, act=cfg.llm.quant == "w8a8")
    core.cfg, core.llm.cfg = cfg, cfg.llm
    return core.eval()
