"""Gaussian diffusion: schedule tables and the ancestral sampling loop.

Port of the sampling part of ``fast_cwdm_tpu/diffusion/gaussian.py``.
Tables are computed in float64 on the host and kept as float32 numpy
arrays, exactly as in the JAX package; each is copied to a device once and
gathered there, so a sampling step never waits on the host.

Layout is channels-last ``(B, X, Y, Z, C)``: the wavelet latent has C=8
and the i2i condition C=24. ``model_fn(x, t)`` takes and returns
channels-last tensors.

Noise: ``jax.random``'s key stream cannot be reproduced in torch, so the
loop takes its initial noise (``noise=``) and per-step noise
(``step_noise=``) as tensors, or draws both from a ``torch.Generator``.
"""

from __future__ import annotations

import enum
from typing import Callable, Sequence

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device
from fast_cwdm_tpu_torch.diffusion import schedules
from fast_cwdm_tpu_torch.ops import wavelet as wv

MODALITIES = ("t1n", "t1c", "t2w", "t2f")


def condition_order(contr: str) -> tuple[str, ...]:
    """Condition modalities in the reference's concat order."""
    if contr not in MODALITIES:
        raise ValueError(f"unknown contrast '{contr}'")
    return tuple(m for m in MODALITIES if m != contr)


class MeanType(str, enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(str, enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(str, enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


class GaussianDiffusion:
    """Diffusion schedule tables + process configuration."""

    def __init__(
        self,
        betas: np.ndarray,
        *,
        mean_type: MeanType = MeanType.START_X,
        var_type: VarType = VarType.FIXED_LARGE,
        loss_type: LossType = LossType.MSE,
        rescale_timesteps: bool = False,
        mode: str = "default",
        wavelet: str = "haar",
        target_channels: int = 8,
    ):
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
        fl_var = np.append(posterior_variance[1], betas[1:])
        f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
        self.betas = f32(betas)
        self.alphas_cumprod = f32(acp)
        self.alphas_cumprod_prev = f32(acp_prev)
        self.alphas_cumprod_next = f32(np.append(acp[1:], 0.0))
        self.sqrt_alphas_cumprod = f32(np.sqrt(acp))
        self.sqrt_one_minus_alphas_cumprod = f32(np.sqrt(1.0 - acp))
        self.log_one_minus_alphas_cumprod = f32(np.log(1.0 - acp))
        self.sqrt_recip_alphas_cumprod = f32(np.sqrt(1.0 / acp))
        self.sqrt_recipm1_alphas_cumprod = f32(np.sqrt(1.0 / acp - 1.0))
        self.posterior_variance = f32(posterior_variance)
        self.posterior_log_variance_clipped = f32(
            np.log(np.append(posterior_variance[1], posterior_variance[1:]))
        )
        self.posterior_mean_coef1 = f32(betas * np.sqrt(acp_prev) / (1.0 - acp))
        self.posterior_mean_coef2 = f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp))
        self.fixed_large_variance = f32(fl_var)
        self.fixed_large_log_variance = f32(np.log(fl_var))
        self.log_betas = f32(np.log(betas))
        self.num_timesteps = int(betas.shape[0])
        self.mean_type = mean_type
        self.var_type = var_type
        self.loss_type = loss_type
        self.rescale_timesteps = rescale_timesteps
        self.mode = mode
        self.wavelet = wavelet
        self.target_channels = target_channels
        self._on_device: dict[tuple[str, torch.device], torch.Tensor] = {}

    @classmethod
    def named(cls, noise_schedule="linear", steps=1000, sample_schedule="direct", **kwargs):
        return cls(
            schedules.get_named_beta_schedule(noise_schedule, steps, sample_schedule),
            **kwargs,
        )

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        key = (name, device)
        tab = self._on_device.get(key)
        if tab is None:
            tab = torch.as_tensor(getattr(self, name), device=device)
            self._on_device[key] = tab
        return tab

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Per-timestep coefficients of table ``name`` for ``t`` (B,),
        shaped to broadcast over ``ndim``-dim tensors."""
        out = self._table(name, t.device)[t]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    # -- forward process -------------------------------------------------

    def scale_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        if self.rescale_timesteps:
            return t.float() * (1000.0 / self.num_timesteps)
        return t

    def q_mean_variance(self, x_start, t):
        mean = self._extract("sqrt_alphas_cumprod", t, x_start.dim()) * x_start
        variance = 1.0 - self._extract("alphas_cumprod", t, x_start.dim())
        log_variance = self._extract("log_one_minus_alphas_cumprod", t, x_start.dim())
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        return (
            self._extract("sqrt_alphas_cumprod", t, x_start.dim()) * x_start
            + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.dim()) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        n = x_t.dim()
        mean = (
            self._extract("posterior_mean_coef1", t, n) * x_start
            + self._extract("posterior_mean_coef2", t, n) * x_t
        )
        return (
            mean,
            self._extract("posterior_variance", t, n),
            self._extract("posterior_log_variance_clipped", t, n),
        )

    # -- reverse process -------------------------------------------------

    def predict_xstart_from_eps(self, x_t, t, eps):
        n = x_t.dim()
        return (
            self._extract("sqrt_recip_alphas_cumprod", t, n) * x_t
            - self._extract("sqrt_recipm1_alphas_cumprod", t, n) * eps
        )

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        c1 = self._extract("posterior_mean_coef1", t, x_t.dim())
        c2 = self._extract("posterior_mean_coef2", t, x_t.dim())
        return (1.0 / c1) * xprev - (c2 / c1) * x_t

    def _process_xstart(self, x, clip_denoised: bool, denoised_fn=None):
        """x0 projection IDWT → clamp[0,1] → DWT with the ×3/÷3 LLL
        convention; for Haar the fused block-local form."""
        if denoised_fn is not None:
            x = denoised_fn(x)
        if not clip_denoised:
            return x
        if self.wavelet in wv.HAAR and x.shape[-1] == 8:
            return wv.haar_clamp_project(x)
        if x.shape[-1] % 8:
            raise ValueError(
                "clip_denoised projects x0 through an IDWT→clamp→DWT round "
                "trip, which needs a band-fused wavelet latent (channels "
                f"divisible by 8); got {x.shape[-1]} channels. Pass "
                "clip_denoised=False for non-wavelet latents."
            )
        img = wv.idwt_normalized(x, channels=x.shape[-1] // 8, wavelet=self.wavelet)
        return wv.dwt_normalized(torch.clamp(img, 0.0, 1.0), wavelet=self.wavelet)

    def p_mean_variance(
        self,
        model_fn: Callable[..., torch.Tensor],
        x: torch.Tensor,
        t: torch.Tensor,
        *,
        cond: torch.Tensor | None = None,
        clip_denoised: bool = True,
        denoised_fn=None,
        model_kwargs: dict | None = None,
    ) -> dict[str, torch.Tensor]:
        """One model evaluation → mean, variance, log_variance, pred_xstart."""
        n = x.dim()
        x_in = torch.cat([x, cond], dim=-1) if self.mode == "i2i" else x
        model_output = model_fn(x_in, self.scale_timesteps(t), **(model_kwargs or {}))

        if self.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
            model_output, var_values = model_output.chunk(2, dim=-1)
            if self.var_type == VarType.LEARNED:
                model_log_variance = var_values
            else:
                min_log = self._extract("posterior_log_variance_clipped", t, n)
                max_log = self._extract("log_betas", t, n)
                frac = (var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.var_type == VarType.FIXED_LARGE:
            model_variance = self._extract("fixed_large_variance", t, n)
            model_log_variance = self._extract("fixed_large_log_variance", t, n)
        else:
            model_variance = self._extract("posterior_variance", t, n)
            model_log_variance = self._extract("posterior_log_variance_clipped", t, n)

        if self.mean_type == MeanType.PREVIOUS_X:
            pred_xstart = self._process_xstart(
                self.predict_xstart_from_xprev(x, t, model_output), clip_denoised, denoised_fn
            )
            model_mean = model_output
        else:
            if self.mean_type == MeanType.START_X:
                pred_xstart = self._process_xstart(model_output, clip_denoised, denoised_fn)
            else:
                pred_xstart = self._process_xstart(
                    self.predict_xstart_from_eps(x, t, model_output), clip_denoised, denoised_fn
                )
            x_ref = x[..., : self.target_channels] if self.mode == "i2i" else x
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x_ref, t)

        ones = torch.ones_like(model_mean)
        return {
            "mean": model_mean,
            "variance": model_variance * ones,
            "log_variance": model_log_variance * ones,
            "pred_xstart": pred_xstart,
        }

    def p_sample(self, model_fn, x, t, noise, *, cond=None, clip_denoised=True,
                 denoised_fn=None, model_kwargs=None):
        """Ancestral step x_t → x_{t-1} with the given standard-normal
        ``noise`` (unused where t == 0)."""
        out = self.p_mean_variance(
            model_fn, x, t, cond=cond, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        )
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def p_sample_loop(
        self,
        model_fn,
        shape: Sequence[int],
        *,
        cond: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        step_noise: Sequence[torch.Tensor] | torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
        clip_denoised: bool = True,
        denoised_fn=None,
        model_kwargs=None,
        time: int | None = None,
    ) -> torch.Tensor:
        """The full reverse chain from ``time`` (default: every step) to 0.

        ``noise`` is the initial x_T and ``step_noise[k]`` the noise of the
        k-th step taken; whatever is not given is drawn from ``generator``
        on ``device`` (default: the device of ``cond``, else ``noise``, else
        CUDA, which raises where there is no GPU).
        """
        t_total = self.num_timesteps if time is None else time
        if device is None:
            ref = cond if cond is not None else noise
            device = ref.device if ref is not None else resolve_device()
        if step_noise is not None and len(step_noise) < t_total:
            raise ValueError(f"step_noise has {len(step_noise)} entries for {t_total} steps")
        img = noise if noise is not None else torch.randn(
            tuple(shape), generator=generator, device=device
        )
        for k, i in enumerate(range(t_total - 1, -1, -1)):
            t = torch.full((img.shape[0],), i, dtype=torch.long, device=img.device)
            eps = (
                step_noise[k]
                if step_noise is not None
                else torch.randn(img.shape, generator=generator, device=img.device)
            )
            img = self.p_sample(
                model_fn, img, t, eps, cond=cond, clip_denoised=clip_denoised,
                denoised_fn=denoised_fn, model_kwargs=model_kwargs,
            )["sample"]
        return img
