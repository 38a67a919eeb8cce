"""The training configuration's freezing matrix (counterpart of
`visionllm_tpu/train/runner.py:44-97`: the freeze fields of `TrainConfig`
and `frozen_predicate`, on the port's dotted parameter paths). The
dataset loop, its other settings, the metric log and checkpoints are not
ported."""

from __future__ import annotations

import dataclasses
from typing import Callable

from visionllm_tpu_torch.config import VisionLLMConfig


@dataclasses.dataclass
class TrainConfig:
    """The freeze fields of the JAX `TrainConfig`."""

    # freezing matrix (reference train.py:533-558; the SD vae and unet
    # rules apply to tools this port does not have yet)
    freeze_vis_encoder: bool = True
    freeze_llm: bool = False
    freeze_backbone: bool = False
    freeze_sd_unet: bool = True


def frozen_predicate(tc: TrainConfig, model_cfg: VisionLLMConfig
                     ) -> Callable[[str], bool]:
    """path -> True where the parameter is frozen."""
    def frozen(path: str) -> bool:
        if "lora_" in path:
            return False
        if tc.freeze_vis_encoder and path.startswith("core.vis_encoder"):
            return True
        if tc.freeze_llm and path.startswith("core.llm"):
            return True
        if tc.freeze_backbone and ".backbone." in path:
            return True
        if path.startswith(("sd.vae", "ip2p.vae")):
            return True
        if tc.freeze_sd_unet and path.startswith("sd.unet"):
            return True
        return False
    return frozen
