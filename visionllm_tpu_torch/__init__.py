"""PyTorch/CUDA port of visionllm_tpu for NVIDIA Hopper (H100): det-VQA
(`models.composite.infer_det`), the perception front door
(`infer.Predictor`: detect, ground and pose, served as /v1/detect,
/v1/ground and /v1/pose by `serve.make_server`), int4 chat serving
(`serve.ChatService`, /v1/generate) and the det training step.

Module paths mirror the JAX package (`visionllm_tpu_torch/models/llama.py`
is the counterpart of `visionllm_tpu/models/llama.py`). The port imports
torch, numpy and the standard library only; it keeps its own copies of
the configuration dataclasses. Hand-written CUDA kernels live in `csrc/`
and are built at first use by `kernels/build.py`.
"""

__all__ = ["resolve_device"]

from visionllm_tpu_torch.device import resolve_device
