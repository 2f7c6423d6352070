"""Timestep respacing (port of ``fast_cwdm_tpu/diffusion/respace.py``).

``space_timesteps`` selects which base timesteps to keep;
``SpacedDiffusion`` re-derives betas from the kept alpha-bar curve and maps
compact timesteps back to the original ones in ``scale_timesteps``, right
before every model call. In the production path the respacing is the
identity and the step reduction is the "sampled" beta schedule.
"""

from __future__ import annotations

from typing import Any, Set

import numpy as np
import torch

from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion


def space_timesteps(num_timesteps: int, section_counts) -> Set[int]:
    """Kept original timesteps: a list of per-section counts, a
    comma-separated string, or "ddimN" for a fixed stride."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


class SpacedDiffusion(GaussianDiffusion):
    """GaussianDiffusion over a subsequence of base timesteps."""

    def __init__(self, betas, *, timestep_map, original_num_steps: int, **kwargs: Any):
        super().__init__(betas, **kwargs)
        self.timestep_map = np.asarray(timestep_map, dtype=np.int64)
        self.original_num_steps = original_num_steps

    def scale_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Compact t → original t, rescaled against the original count."""
        new_t = self._table("timestep_map", t.device)[t]
        if self.rescale_timesteps:
            return new_t.float() * (1000.0 / self.original_num_steps)
        return new_t


def create_spaced_diffusion(*, use_timesteps, betas: np.ndarray, **kwargs: Any) -> SpacedDiffusion:
    """New betas from the kept alpha-bar ratios."""
    use_timesteps = set(use_timesteps)
    betas = np.asarray(betas, dtype=np.float64)
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, alpha_cumprod in enumerate(np.cumprod(1.0 - betas)):
        if i in use_timesteps:
            new_betas.append(1.0 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return SpacedDiffusion(
        np.array(new_betas),
        timestep_map=timestep_map,
        original_num_steps=len(betas),
        **kwargs,
    )
