"""Likelihood helpers (port of ``fast_cwdm_tpu/diffusion/losses.py``)."""

from __future__ import annotations

import math

import torch

from fast_cwdm_tpu_torch.models.nn import mean_flat

__all__ = [
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
]


def _as_tensor(v, like: torch.Tensor | None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(
        v, dtype=like.dtype if like is not None else torch.float32,
        device=like.device if like is not None else None,
    )


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL between two diagonal Gaussians; scalars broadcast against the
    tensor arguments."""
    like = next((v for v in (mean1, logvar1, mean2, logvar2) if isinstance(v, torch.Tensor)), None)
    mean1, logvar1, mean2, logvar2 = (_as_tensor(v, like) for v in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Fast tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to [-1, 1] 8-bit bins."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min,
                    torch.log(torch.clamp(cdf_delta, min=1e-12))),
    )
