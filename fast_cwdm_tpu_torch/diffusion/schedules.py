"""Beta schedules, including the Fast-DDPM "sampled" schedule.

Port of ``fast_cwdm_tpu/diffusion/schedules.py`` (numpy, host float64):
downstream code casts the gathered per-step coefficients to float32.
"""

from __future__ import annotations

import math

import numpy as np


def linear_betas(num_timesteps: int) -> np.ndarray:
    """Classic scaled-linspace DDPM schedule (`gaussian_diffusion.py:39-44`)."""
    scale = 1000.0 / num_timesteps
    return np.linspace(
        scale * 0.0001, scale * 0.02, num_timesteps, dtype=np.float64
    )


def sampled_betas(num_timesteps: int) -> np.ndarray:
    """Fast-DDPM subsampled schedule (`gaussian_diffusion.py:45-58`).

    Build the full 1000-step linear alpha-bar curve, pick ``num_timesteps``
    uniformly spaced indices, and re-derive betas from consecutive alpha-bar
    ratios so a short chain mimics the 1000-step noise levels. This is the
    "fast" in fast-cwdm: train AND sample with e.g. 10 steps.
    """
    full_betas = np.linspace(0.0001, 0.02, 1000, dtype=np.float64)
    full_alphas_cumprod = np.cumprod(1.0 - full_betas, axis=0)
    indices = np.linspace(0, 999, num_timesteps, dtype=int)
    sampled_cumprod = full_alphas_cumprod[indices]
    prev = np.concatenate([[1.0], sampled_cumprod[:-1]])
    betas = 1.0 - sampled_cumprod / prev
    return np.clip(betas, 0.0001, 0.999)


def betas_for_alpha_bar(
    num_timesteps: int, alpha_bar, max_beta: float = 0.999
) -> np.ndarray:
    """Discretize a continuous alpha-bar curve (`gaussian_diffusion.py:70-87`)."""
    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def cosine_betas(num_timesteps: int) -> np.ndarray:
    return betas_for_alpha_bar(
        num_timesteps,
        lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
    )


def get_named_beta_schedule(
    schedule_name: str,
    num_diffusion_timesteps: int,
    sample_schedule: str = "direct",
) -> np.ndarray:
    """Reference-compatible schedule dispatch (`gaussian_diffusion.py:30-67`)."""
    if schedule_name == "linear":
        if sample_schedule == "direct":
            return linear_betas(num_diffusion_timesteps)
        if sample_schedule == "sampled":
            return sampled_betas(num_diffusion_timesteps)
        raise NotImplementedError(f"Unknown sample_schedule: {sample_schedule}")
    if schedule_name == "cosine":
        return cosine_betas(num_diffusion_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")
