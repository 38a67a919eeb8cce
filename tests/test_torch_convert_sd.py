"""The SD-1.5 / InstructPix2Pix converters at full width with no JAX: the
published diffusers key sets (`tests/sd15_published_keys.py`: the UNet
with 4 and 8 input channels, the VAE, the CLIP-L text model) as meta
tensors at their published shapes go through the port's converters
into the port's modules laid out on the meta device. Every key must be
read, and every parameter filled at its shape. The values are held
against the JAX converters at tiny widths in `test_torch_convert.py`."""

import pytest
import torch

from tests.sd15_published_keys import (sd15_text_keys, sd15_unet_keys,
                                       sd15_vae_keys)
from visionllm_tpu_torch.config import IP2PConfig, SDConfig
from visionllm_tpu_torch.models.stable_diffusion.clip_text import (
    ClipTextConfig, ClipTextModel)
from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
    unet_cfg_for, vae_cfg_for)
from visionllm_tpu_torch.models.stable_diffusion.unet import UNet2DCondition
from visionllm_tpu_torch.models.stable_diffusion.vae import AutoencoderKL
from visionllm_tpu_torch.utils.convert_sd import (convert_clip_text,
                                                  convert_unet, convert_vae)
from visionllm_tpu_torch.utils.torch_convert import ReadRecorder


def _meta(shapes):
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def _fills(got, module):
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    bad = [(k, tuple(got[k].shape), s) for k, s in want.items()
           if tuple(got[k].shape) != s]
    assert not bad, bad[:10]


@pytest.mark.parametrize("head", [SDConfig(), IP2PConfig()],
                         ids=["sd_in4", "ip2p_in8"])
def test_unet_reads_every_published_key(head):
    cfg = unet_cfg_for(head.sample_size, head.in_channels,
                       head.cross_attention_dim)
    rec = ReadRecorder(_meta(sd15_unet_keys(in_channels=head.in_channels)))
    got = convert_unet(rec, cfg)
    assert rec.unread(lambda k: False) == []
    with torch.device("meta"):
        _fills(got, UNet2DCondition(cfg))
    assert tuple(got["conv_in.weight"].shape) == (320, head.in_channels,
                                                  3, 3)
    # SD-1.5's conv projections stay 1x1 convs
    assert got["down_0_attn_0.proj_in.weight"].dim() == 4


def test_vae_reads_every_published_key():
    cfg = vae_cfg_for(SDConfig().sample_size)
    rec = ReadRecorder(_meta(sd15_vae_keys()))
    got = convert_vae(rec, cfg)
    assert rec.unread(lambda k: False) == []
    with torch.device("meta"):
        _fills(got, AutoencoderKL(cfg))


def test_clip_text_reads_every_published_key():
    rec = ReadRecorder(_meta(sd15_text_keys()))
    got = convert_clip_text(rec)
    assert rec.unread(lambda k: False) == []
    with torch.device("meta"):
        model = ClipTextModel(ClipTextConfig())
    _fills(got, model)
    assert sum(v.numel() for v in got.values()) == sum(
        p.numel() for p in model.parameters())


def test_written_text_encoder_keys_are_the_published_ones():
    """The SD text encoders' keys that `torch_ref_layout.write_composite`
    adds to a written checkpoint are the published CLIP-L set."""
    from tests.torch_ref_layout import sd_text_encoder_keys
    assert sd_text_encoder_keys() == sd15_text_keys()
