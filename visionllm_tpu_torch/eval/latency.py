"""Latency metrics: prefill TTFT and steady-state decode throughput
(counterpart of `visionllm_tpu/eval/latency.py`).

JAX fits relay overhead out with a device `while_loop` at two trip
counts (`utils/profiling.py:fit_device_time`). Here a CUDA card times n
back-to-back calls between two CUDA events after a warm-up; on the CPU
the host clock times them. Either way the number is time a call with the
launches queued, not a single call's round trip.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from visionllm_tpu_torch.models.visionllm import SpecialTokenIds, VisionLLM


def seconds_per_call(fn: Callable[[], object], device: torch.device,
                     n: int = 10, warmup: int = 2) -> float:
    """Mean seconds of `fn()` over n back-to-back calls after `warmup`:
    CUDA events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / n
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n


@torch.no_grad()
def measure_latency(core: VisionLLM, tid: SpecialTokenIds, *,
                    prompt_len: int = 592, image_size: Optional[int] = None,
                    max_len: int = 1024, n_prefill: int = 10,
                    n_decode: int = 64) -> Dict[str, float]:
    """{"ttft_s": seconds of a B1 prefill (vision encode, LLM prefill and
    the last position's logits), "decode_tok_s": B1 decode steps a second
    at `prompt_len` cached positions}, on the core's device. The prompt
    is a BOS, the image's `cfg.image_token_len` <im_patch> ids and filler
    ids up to `prompt_len`."""
    cfg = core.cfg
    param = next(core.parameters())
    dev = param.device
    size = image_size or cfg.vis_encoder.image_size
    img_len = cfg.image_token_len
    ids = ([1] + [tid.imp] * img_len
           + list(range(10, 10 + max(1, prompt_len - img_len - 1))))
    ids = ids[:prompt_len]
    input_ids = torch.tensor([ids], dtype=torch.long, device=dev)
    images = torch.full((1, size, size, 3), 0.1, device=dev)

    ttft = seconds_per_call(
        lambda: core(input_ids, images, tid)["logits"][:, -1], dev,
        n=n_prefill)

    cache = core.new_cache(1, max_len)
    core(input_ids, images, tid, cache=cache, compute_logits=False)
    embed = torch.zeros(1, 1, cfg.llm.hidden_size, dtype=param.dtype,
                        device=dev)
    pos = torch.full((1, 1), len(ids), dtype=torch.long, device=dev)

    def step():
        cache.index = len(ids)          # every step at the same context
        return core.llm_step(embed, pos, cache)["logits"]

    t_dec = seconds_per_call(step, dev, n=n_decode)
    return {"ttft_s": float(ttft), "decode_tok_s": float(1.0 / t_dec)}
