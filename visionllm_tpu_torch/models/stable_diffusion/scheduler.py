"""Diffusion noise schedule and the DDIM sampler.

Counterpart of `visionllm_tpu/models/stable_diffusion/scheduler.py`:
SD-1.5's scaled_linear betas 0.00085 -> 0.012 over 1000 train steps,
`add_noise`, and deterministic DDIM (eta 0). The JAX sampler is one
`lax.scan`; here it is a Python loop over the same fp32 arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    schedule: str = "scaled_linear"

    def alphas_cumprod(self) -> np.ndarray:
        if self.schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5,
                                self.beta_end ** 0.5,
                                self.num_train_timesteps,
                                dtype=np.float64) ** 2
        elif self.schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end,
                                self.num_train_timesteps, dtype=np.float64)
        else:
            raise ValueError(self.schedule)
        return np.cumprod(1.0 - betas).astype(np.float32)


def add_noise(sched: DiffusionSchedule, latents: torch.Tensor,
              noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) sampling (diffusers scheduler.add_noise)."""
    ac = torch.from_numpy(sched.alphas_cumprod()).to(latents.device)[
        timesteps]
    sqrt_ac = ac.sqrt()[:, None, None, None].to(latents.dtype)
    sqrt_1mac = (1 - ac).sqrt()[:, None, None, None].to(latents.dtype)
    return sqrt_ac * latents + sqrt_1mac * noise


def ddim_sample_loop(
    unet_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    latents: torch.Tensor,
    num_inference_steps: int = 50,
) -> torch.Tensor:
    """Deterministic DDIM sampling; `unet_fn(latents, t [B]) -> eps`
    closes over the conditioning (and the guidance combination)."""
    T = sched.num_train_timesteps
    step = T // num_inference_steps
    timesteps = np.flip(np.arange(0, num_inference_steps) * step).copy()
    ac = np.concatenate([sched.alphas_cumprod(), [1.0]]).astype(np.float32)
    # the last step has prev_t < 0 and reads the appended final alpha 1.0
    # at index T (diffusers' final_alpha_cumprod); a negative index would
    # wrap to ac[T - step] ~ 0.006 and return noise
    prev_t = np.where(timesteps - step >= 0, timesteps - step, T)
    a_t, a_prev = ac[timesteps], ac[prev_t]
    B, dev = latents.shape[0], latents.device
    # the per-step fp32 scalars, on the device: a division by a host
    # scalar runs as a product with its reciprocal on CUDA, not as JAX's
    # division
    sqrt_1m_t, sqrt_t, sqrt_prev, sqrt_1m_prev = (
        torch.from_numpy(np.sqrt(x).astype(np.float32)).to(dev)
        for x in (1 - a_t, a_t, a_prev, 1 - a_prev))
    lat = latents
    for i, t in enumerate(timesteps.tolist()):
        eps = unet_fn(lat, torch.full((B,), t, dtype=torch.int32,
                                      device=dev))
        lat32, eps32 = lat.float(), eps.float()
        x0 = (lat32 - sqrt_1m_t[i] * eps32) / sqrt_t[i]
        new = sqrt_prev[i] * x0 + sqrt_1m_prev[i] * eps32
        lat = new.to(lat.dtype)
    return lat
