"""The [GEN] and [EDIT] atom tools: LLM embeddings -> diffusion
conditioning -> DDIM with classifier-free guidance -> VAE decode, and
their epsilon-prediction training losses.

Counterpart of `visionllm_tpu/models/stable_diffusion/sd_head.py`:
`LLM2SDMapper`
(emb_proj MLP 4096 -> 768, then 77 learned queries through a one-layer
encoder / one-layer decoder torch-style Transformer, norm_first, in
fp32), `StableDiffusionWithLLMEmb` ([GEN]: 2-way guidance) and
`InstructPix2PixWithLLMEmb` ([EDIT]: the UNet reads the noisy latents
beside the input image's latents; 3-way guidance over text and image).

Where the port draws differently: JAX draws the start latents inside
`generate` with `jax.random.normal(rng, (B, S, S, 4))`; the port draws
them from the caller's `torch.Generator`, or takes them as `latents=`
(the same start gives the same image). `train_loss` likewise takes its
draws (`draw_noise`: the posterior sample's noise, epsilon, the timesteps
and, for [EDIT], the classifier-free-drop uniforms) from the caller's
generator or as tensors. Images are [B, H, W, 3] in [-1, 1] in and out;
latents [B, S, S, 4].

Training: the frozen VAE encodes under `torch.no_grad()` (JAX's
`stop_gradient`); the loss is fp32 mean squared error of the UNet's
epsilon, plus the caption distillation when caption embeddings are
given. [EDIT] conditions on the input image's posterior mean without the
scaling factor, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from visionllm_tpu_torch.config import IP2PConfig, SDConfig
from visionllm_tpu_torch.models.common import FLAX_LN_EPS
from visionllm_tpu_torch.models.grounding_dino.layers import TorchMHA
from visionllm_tpu_torch.models.stable_diffusion.scheduler import (
    DiffusionSchedule, add_noise, ddim_sample_loop)
from visionllm_tpu_torch.models.stable_diffusion.unet import (
    GroupNorm32, LayerNorm, UNet2DCondition, UNetConfig)
from visionllm_tpu_torch.models.stable_diffusion.vae import (AutoencoderKL,
                                                             VAEConfig)
from visionllm_tpu_torch.parallel.global_batch import data_shards


class TorchTransformerLayer(nn.Module):
    """torch nn.TransformerEncoder/DecoderLayer, norm_first=True, relu
    feed-forward, dropout 0; `cross=True` adds the decoder's attention
    over the memory."""

    def __init__(self, d_model: int, num_heads: int = 8,
                 cross: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.self_attn = TorchMHA(d_model, num_heads)
        if cross:
            self.norm_mem = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
            self.cross_attn = TorchMHA(d_model, num_heads)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.linear1 = nn.Linear(d_model, d_model * 4)
        self.linear2 = nn.Linear(d_model * 4, d_model)

    def forward(self, x: torch.Tensor,
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h)
        if memory is not None:
            h = self.norm_mem(x)
            x = x + self.cross_attn(h, memory, memory)
        h = F.relu(self.linear1(self.norm2(x)))
        return x + self.linear2(h)


class LLM2SDMapper(nn.Module):
    """emb_proj + queries + transformer -> [B, num_queries, sd_dim], in
    the dtype of its parameters (fp32: `build_model` keeps them so)."""

    def __init__(self, llm_dim: int, sd_dim: int, num_queries: int,
                 num_encoder_layers: int = 1, num_decoder_layers: int = 1):
        super().__init__()
        self.emb_proj_0 = nn.Linear(llm_dim, sd_dim)
        self.emb_proj_2 = nn.Linear(sd_dim, sd_dim)
        self.mapper_queries = nn.Parameter(torch.zeros(1, num_queries,
                                                       sd_dim))
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_{i}", TorchTransformerLayer(sd_dim))
        self.encoder_norm = nn.LayerNorm(sd_dim, eps=FLAX_LN_EPS)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_{i}",
                            TorchTransformerLayer(sd_dim, cross=True))
        self.decoder_norm = nn.LayerNorm(sd_dim, eps=FLAX_LN_EPS)
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers

    def forward(self, embs: torch.Tensor) -> torch.Tensor:
        """embs: [B, num_embs_gen, llm_dim]."""
        x = self.emb_proj_2(F.gelu(self.emb_proj_0(embs)))
        src = x
        for i in range(self.num_encoder_layers):
            src = getattr(self, f"encoder_{i}")(src)
        src = self.encoder_norm(src)
        tgt = self.mapper_queries.expand(x.shape[0], -1, -1)
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_{i}")(tgt, src)
        return self.decoder_norm(tgt)


def unet_cfg_for(sample_size: int, in_channels: int,
                 cross_attention_dim: int) -> UNetConfig:
    if sample_size <= 16:                # tiny test geometry
        return UNetConfig(
            sample_size=sample_size, in_channels=in_channels,
            out_channels=4, block_out_channels=(32, 64),
            layers_per_block=1, cross_attention_dim=cross_attention_dim,
            attention_head_dim=4, norm_num_groups=8,
            cross_attn_blocks=(True, False))
    return UNetConfig(in_channels=in_channels,
                      cross_attention_dim=cross_attention_dim)


def vae_cfg_for(sample_size: int) -> VAEConfig:
    if sample_size <= 16:
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                         norm_num_groups=8)
    return VAEConfig()


class _DiffusionHead(nn.Module):
    """The mapper, UNet and VAE of one head, sized from its config."""

    def __init__(self, cfg: Union[SDConfig, IP2PConfig],
                 schedule: DiffusionSchedule = DiffusionSchedule()):
        super().__init__()
        self.cfg = cfg
        self.schedule = schedule
        self.mapper = LLM2SDMapper(
            cfg.llm_hidden_size, cfg.sd_hidden_size, cfg.num_queries,
            cfg.num_encoder_layers, cfg.num_decoder_layers)
        self.unet = UNet2DCondition(unet_cfg_for(
            cfg.sample_size, cfg.in_channels, cfg.cross_attention_dim))
        self.vae = AutoencoderKL(vae_cfg_for(cfg.sample_size))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the UNet's and the VAE's."""
        return self.unet.conv_in.weight.dtype

    def fp32_modules(self) -> Iterator[nn.Module]:
        """The modules whose flax counterparts keep fp32 parameters whatever
        the model's dtype: the mapper, every GroupNorm and the UNet's
        LayerNorms."""
        yield self.mapper
        yield from (m for m in self.modules()
                    if isinstance(m, (GroupNorm32, LayerNorm)))

    def map_embeddings(self, embs: torch.Tensor) -> torch.Tensor:
        """[B, num_embs_gen, llm_dim] -> prompt_embeds [B, 77, sd_dim]."""
        return self.mapper(embs.to(self.mapper.emb_proj_0.weight.dtype))

    def start_latents(self, B: int, generator: Optional[torch.Generator],
                      latents: Optional[torch.Tensor], device
                      ) -> torch.Tensor:
        """fp32 start latents [B, S, S, 4]: `latents` when given, else a
        standard normal draw from `generator`."""
        S = self.cfg.sample_size
        if latents is not None:
            if tuple(latents.shape) != (B, S, S, 4):
                raise ValueError(f"latents {tuple(latents.shape)}, want "
                                 f"{(B, S, S, 4)}")
            return latents.float()
        if generator is None:
            raise ValueError("generate needs a torch.Generator or latents=")
        return torch.randn((B, S, S, 4), generator=generator,
                           dtype=torch.float32, device=device)

    def draw_noise(self, generator: torch.Generator, images: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """The draws of one `train_loss` on `images` [B, H, W, 3]: the
        posterior sample's standard normal noise and epsilon at the
        latents' shape ([B, H/8, W/8, 4] for SD-1.5's VAE) fp32 and the
        timesteps [B] in [0, num_train_timesteps)."""
        B, H, W, _ = images.shape
        kw = dict(generator=generator, device=images.device)
        f = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        shape = (B, H // f, W // f, self.vae.cfg.latent_channels)
        return {"posterior": torch.randn(shape, **kw),
                "eps": torch.randn(shape, **kw),
                "t": torch.randint(0, self.schedule.num_train_timesteps,
                                   (B,), **kw)}

    def _eps_loss(self, unet_in: torch.Tensor, cond: torch.Tensor,
                  noise: Dict[str, torch.Tensor],
                  caption_embeds: Optional[torch.Tensor],
                  caption_weight: float) -> Dict[str, torch.Tensor]:
        """fp32 mean squared error of the UNet's epsilon at `unet_in`, plus
        `caption_weight` times the conditioning's distance from the
        caption embeddings when given. Under a data split each is the
        mean over this rank's equal share of the global batch over the
        number of shares (`data_shards`): its part of the global mean."""
        shares = data_shards()
        pred = self.unet(unet_in.to(self.dtype), noise["t"], cond)
        image_loss = (pred.float() - noise["eps"]).square().mean() / shares
        out = {"image_loss": image_loss, "loss": image_loss}
        if caption_embeds is not None:
            out["caption_loss"] = (cond - caption_embeds.to(cond.dtype)
                                   ).square().mean() / shares
            out["loss"] = image_loss + caption_weight * out["caption_loss"]
        return out

    def _noisy_latents(self, images: torch.Tensor,
                       noise: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The frozen VAE's posterior sample of `images` (scaled), noised to
        the drawn timesteps, fp32."""
        with torch.no_grad():
            latents = self.vae.encode(images.to(self.dtype),
                                      noise=noise["posterior"])
        return add_noise(self.schedule, latents.float(), noise["eps"],
                         noise["t"])


class StableDiffusionWithLLMEmb(_DiffusionHead):
    """[GEN] head of an `SDConfig`: `map_embeddings`, `train_loss`,
    `denoise`, `generate`."""

    def train_loss(self, gen_embs: torch.Tensor, output_images: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[Dict[str, torch.Tensor]] = None,
                   caption_embeds: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Epsilon-prediction loss of [GEN] rows [B, num_embs_gen,
        llm_dim] for the images [B, H, W, 3] in [-1, 1]: image_loss, loss
        (+ caption_loss, weighted by caption_distill_weight). The draws
        come from `generator` unless `noise` (`draw_noise`) is given."""
        cond = self.map_embeddings(gen_embs)
        if noise is None:
            noise = self.draw_noise(generator, output_images)
        noisy = self._noisy_latents(output_images, noise)
        return self._eps_loss(noisy, cond, noise, caption_embeds,
                              self.cfg.caption_distill_weight)

    def denoise(self, cond: torch.Tensor, latents: torch.Tensor,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                null_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDIM from fp32 `latents` under 2-way guidance (the unconditional
        and the conditional rows in one UNet batch) -> fp32 latents."""
        if null_cond is None:
            null_cond = torch.zeros_like(cond)
        ctx = torch.cat([null_cond, cond], dim=0)

        def unet_fn(lat, t):
            both = torch.cat([lat, lat], dim=0).to(self.dtype)
            eps = self.unet(both, torch.cat([t, t]), ctx)
            eps_u, eps_c = eps.float().chunk(2, dim=0)
            return eps_u + guidance_scale * (eps_c - eps_u)

        return ddim_sample_loop(unet_fn, self.schedule, latents,
                                num_inference_steps)

    @torch.no_grad()
    def generate(self, gen_embs: torch.Tensor,
                 generator: Optional[torch.Generator],
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 null_cond: Optional[torch.Tensor] = None, *,
                 latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[GEN] rows [B, num_embs_gen, llm_dim] -> image [B, H, W, 3] in
        the compute dtype: the mapper, DDIM from latents drawn from
        `generator` (or the given `latents`), the VAE decode."""
        cond = self.map_embeddings(gen_embs)
        lat = self.start_latents(cond.shape[0], generator, latents,
                                 cond.device)
        final = self.denoise(cond, lat, num_inference_steps, guidance_scale,
                             null_cond)
        return self.vae.decode(final.to(self.dtype))


class InstructPix2PixWithLLMEmb(_DiffusionHead):
    """[EDIT] head of an `IP2PConfig`: `map_embeddings`, `image_latents`,
    `train_loss`, `denoise`, `generate`."""

    # the [EDIT] head's caption distillation weight (the JAX head's
    # constant; `IP2PConfig` carries none)
    CAPTION_WEIGHT = 0.1

    def draw_noise(self, generator: torch.Generator, images: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """The base draws, then the classifier-free-drop uniforms [B]."""
        out = super().draw_noise(generator, images)
        out["drop"] = torch.rand((images.shape[0],), generator=generator,
                                 device=images.device)
        return out

    def train_loss(self, edit_embs: torch.Tensor, input_images: torch.Tensor,
                   output_images: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[Dict[str, torch.Tensor]] = None,
                   null_cond: Optional[torch.Tensor] = None,
                   caption_embeds: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Epsilon-prediction loss of [EDIT] rows for the edit
        `input_images` -> `output_images` ([B, H, W, 3] in [-1, 1]). With
        cfg_drop_prob p, a sample whose drop uniform u is below 2p trains
        on `null_cond` (zeros) for its text, and one with p <= u < 3p on
        zero image latents. The draws come from `generator` unless `noise`
        (`draw_noise`) is given."""
        cond = self.map_embeddings(edit_embs)
        if noise is None:
            noise = self.draw_noise(generator, output_images)
        noisy = self._noisy_latents(output_images, noise)
        with torch.no_grad():
            img_cond = self.image_latents(input_images)
        p = self.cfg.cfg_drop_prob
        if p > 0:
            u = noise["drop"]
            if null_cond is None:
                null_cond = torch.zeros_like(cond)
            cond = torch.where((u < 2 * p)[:, None, None], null_cond, cond)
            keep = 1.0 - ((u >= p) & (u < 3 * p)).to(img_cond.dtype)
            img_cond = img_cond * keep[:, None, None, None]
        unet_in = torch.cat([noisy.to(self.dtype), img_cond.to(self.dtype)],
                            -1)
        return self._eps_loss(unet_in, cond, noise, caption_embeds,
                              self.CAPTION_WEIGHT)

    def image_latents(self, input_images: torch.Tensor) -> torch.Tensor:
        """The conditioning latents: the posterior mean of the input
        images [B, H, W, 3], without the scaling factor, in fp32."""
        lat = self.vae.encode(input_images.to(self.dtype))
        return (lat / self.vae.cfg.scaling_factor).float()

    def denoise(self, cond: torch.Tensor, img_cond: torch.Tensor,
                latents: torch.Tensor, num_inference_steps: int = 50,
                guidance_scale: float = 7.5,
                image_guidance_scale: float = 1.5,
                null_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDIM from fp32 `latents` under 3-way guidance (IP2P §3.2.1):
        the rows (text, image), (none, image), (none, none) in one UNet
        batch -> fp32 latents."""
        if null_cond is None:
            null_cond = torch.zeros_like(cond)
        img3 = torch.cat([img_cond, img_cond, torch.zeros_like(img_cond)])
        ctx3 = torch.cat([cond, null_cond, null_cond], dim=0)

        def unet_fn(lat, t):
            unet_in = torch.cat([torch.cat([lat, lat, lat]), img3],
                                dim=-1).to(self.dtype)
            eps = self.unet(unet_in, torch.cat([t, t, t]), ctx3)
            e_ct, e_ci, e_uu = eps.float().chunk(3, dim=0)
            return (e_uu + guidance_scale * (e_ct - e_ci)
                    + image_guidance_scale * (e_ci - e_uu))

        return ddim_sample_loop(unet_fn, self.schedule, latents,
                                num_inference_steps)

    @torch.no_grad()
    def generate(self, edit_embs: torch.Tensor, input_images: torch.Tensor,
                 generator: Optional[torch.Generator],
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 image_guidance_scale: float = 1.5,
                 null_cond: Optional[torch.Tensor] = None, *,
                 latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[EDIT] rows [B, num_embs_gen, llm_dim] and the images to edit
        [B, H, W, 3] in [-1, 1] -> edited image [B, H, W, 3] in the
        compute dtype."""
        cond = self.map_embeddings(edit_embs)
        img_cond = self.image_latents(input_images)
        lat = self.start_latents(cond.shape[0], generator, latents,
                                 cond.device)
        final = self.denoise(cond, img_cond, lat, num_inference_steps,
                             guidance_scale, image_guidance_scale, null_cond)
        return self.vae.decode(final.to(self.dtype))
