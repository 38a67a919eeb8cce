from visionllm_tpu_torch.models.stable_diffusion.clip_text import (  # noqa
    ClipTextConfig, ClipTextModel)
