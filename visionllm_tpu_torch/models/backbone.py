"""The image backbones of Grounding-DINO and UniPose, by name (JAX
`grounding_dino/model.py:155-177`, `unipose/model.py:171-191`)."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

from visionllm_tpu_torch.models.intern_image import (
    InternImage, intern_image_h_config, intern_image_tiny_config)
from visionllm_tpu_torch.models.swin import (SwinBackbone, swin_large_config,
                                             swin_tiny_config)

BACKBONES = ("swin_tiny", "swin_large", "intern_image_h", "intern_image_tiny")


def build_backbone(name: str, out_stages: Tuple[int, ...],
                   overrides: Optional[Mapping[str, Any]] = None):
    """(backbone module, its config) for `name`: Swin-T or Swin-L (their
    presets with `overrides` on top), InternImage-H, or the JAX package's
    test InternImage (depths (1, 1, 1, 1), groups (2, 2, 4, 4)); as in
    JAX, `overrides` reach the Swin presets only. The module maps NHWC
    pixels to the NHWC maps of `out_stages` (stage s at stride 4 * 2^s),
    whose widths are the config's `stage_dim(s)`."""
    if name in ("swin_tiny", "swin_large"):
        preset = swin_tiny_config if name == "swin_tiny" else \
            swin_large_config
        cfg = preset(out_stages=tuple(out_stages), **dict(overrides or {}))
        return SwinBackbone(cfg), cfg
    if name == "intern_image_h":
        cfg = intern_image_h_config(out_indices=tuple(out_stages))
    elif name == "intern_image_tiny":
        cfg = intern_image_tiny_config(depths=(1, 1, 1, 1),
                                       groups=(2, 2, 4, 4),
                                       out_indices=tuple(out_stages))
    else:
        raise ValueError(f"backbone {name!r}: one of {BACKBONES}")
    return InternImage(cfg), cfg
