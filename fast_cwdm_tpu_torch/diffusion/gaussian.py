"""Gaussian diffusion: schedule tables, the sampling loops (ancestral,
DDIM, and DPM-Solver++ through ``diffusion/dpm.py``) and the training loss.

Port of the sampling and training parts of
``fast_cwdm_tpu/diffusion/gaussian.py``.
Tables are computed in float64 on the host and kept as float32 numpy
arrays, exactly as in the JAX package; each is copied to a device once and
gathered there, so a sampling step never waits on the host.

Layout is channels-last ``(B, X, Y, Z, C)``: the wavelet latent has C=8
and the i2i condition C=24. ``model_fn(x, t)`` takes and returns
channels-last tensors.

Noise: ``jax.random``'s key stream cannot be reproduced in torch, so the
loops take their initial noise (``noise=``) and per-step noise
(``step_noise=``) as tensors, or draw both from a ``torch.Generator``;
``training_losses`` likewise takes ``noise_img`` or a generator. A method
that noises a known image first (``p_sample_loop_known``, the
interpolations) draws that noise first, then the chain's as its loop does;
the progressive generators draw as their loops, so the same generator seed
gives the loop's result step for step.
"""

from __future__ import annotations

import copy
import enum
import math
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device
from fast_cwdm_tpu_torch.diffusion import dpm, schedules
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.parallel.mesh import current_sp, global_sum_sp

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

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


class GaussianDiffusion:
    """Diffusion schedule tables + process configuration.

    The fields are those of the JAX dataclass: the host tables
    (``TABLES``, float32 numpy) and the configuration (``CONFIG``).
    ``fuse_clip_projection=False`` forces the full-spatial IDWT → clamp →
    DWT per step even for Haar, the reference's execution shape
    (``gaussian_diffusion.py:335-354``); ``create`` does not take it, so it
    is set through :meth:`replace`, as ``bench.py``'s faithful leg does.
    """

    TABLES = dict.fromkeys((
        "betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
        "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
        "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
        "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
        "fixed_large_variance", "fixed_large_log_variance", "log_betas"), np.float32)
    CONFIG = ("num_timesteps", "mean_type", "var_type", "loss_type", "rescale_timesteps",
              "mode", "wavelet", "target_channels", "fuse_clip_projection")

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
        fuse_clip_projection: bool = True,
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
        self.fuse_clip_projection = fuse_clip_projection
        self._on_device: dict[tuple[str, torch.device], torch.Tensor] = {}

    @classmethod
    def create(
        cls,
        betas: np.ndarray,
        *,
        mean_type: MeanType = MeanType.START_X,
        var_type: VarType = VarType.FIXED_LARGE,
        loss_type: LossType = LossType.MSE,
        rescale_timesteps: bool = False,
        mode: str = "default",
        wavelet: str = "haar",
        target_channels: int = 8,
    ) -> "GaussianDiffusion":
        """The JAX package's constructor: every table from ``betas``."""
        return cls(betas, mean_type=mean_type, var_type=var_type, loss_type=loss_type,
                   rescale_timesteps=rescale_timesteps, mode=mode, wavelet=wavelet,
                   target_channels=target_channels)

    @classmethod
    def named(cls, noise_schedule="linear", steps=1000, sample_schedule="direct", **kwargs):
        return cls.create(
            schedules.get_named_beta_schedule(noise_schedule, steps, sample_schedule),
            **kwargs,
        )

    def replace(self, **changes) -> "GaussianDiffusion":
        """A copy with the named fields changed (flax's ``replace``); the
        original is left as it is. A table is kept as host numpy in its
        dtype, and its device copies are dropped."""
        unknown = sorted(set(changes) - set(self.TABLES) - set(self.CONFIG))
        if unknown:
            raise TypeError(f"{type(self).__name__} has no field(s) {unknown}")
        new = copy.copy(self)
        for name, value in changes.items():
            if name in self.TABLES:
                value = np.asarray(value, dtype=self.TABLES[name])
            setattr(new, name, value)
        new._on_device = {k: v for k, v in self._on_device.items() if k[0] not in changes}
        return new

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

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        n = x_t.dim()
        return (
            self._extract("sqrt_recip_alphas_cumprod", t, n) * x_t - pred_xstart
        ) / self._extract("sqrt_recipm1_alphas_cumprod", t, n)

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        c1 = self._extract("posterior_mean_coef1", t, x_t.dim())
        c2 = self._extract("posterior_mean_coef2", t, x_t.dim())
        return (1.0 / c1) * xprev - (c2 / c1) * x_t

    def _process_xstart(self, x, clip_denoised: bool, denoised_fn=None):
        """x0 projection IDWT → clamp[0,1] → DWT with the ×3/÷3 LLL
        convention; for an 8-channel Haar latent the fused block-local form
        unless ``fuse_clip_projection`` is False (then K2 → clamp → K1 on
        the card)."""
        if denoised_fn is not None:
            x = denoised_fn(x)
        if not clip_denoised:
            return x
        if self.fuse_clip_projection and self.wavelet in wv.HAAR and x.shape[-1] == 8:
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
                 denoised_fn=None, cond_fn=None, model_kwargs=None):
        """Ancestral step x_t → x_{t-1} with the given standard-normal
        ``noise`` (unused where t == 0); ``cond_fn`` applies classifier
        guidance to the posterior mean (:meth:`condition_mean`)."""
        out = self.p_mean_variance(
            model_fn, x, t, cond=cond, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        )
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t, model_kwargs=model_kwargs)
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
        cond_fn=None,
        model_kwargs=None,
        time: int | None = None,
        chunk_size: int | None = None,
        params=None,
    ) -> torch.Tensor:
        """The full reverse chain from ``time`` (default: every step) to 0.

        ``noise`` is the initial x_T and ``step_noise[k]`` the noise of the
        k-th step taken; whatever is not given is drawn from ``generator``
        on ``device`` (default: the device of ``cond``, else ``noise``, else
        CUDA, which raises where there is no GPU), x_T first, then one draw
        per step in the order of the steps.

        ``chunk_size``: run the chain as ⌈T/chunk⌉ calls of
        :meth:`scan_steps` (identical numerics). ``params``: when given,
        ``model_fn`` is called as ``model_fn(params, x, t)``. The JAX
        package's ``_run_p_segment`` keeps params as jit arguments of one
        compiled segment; eager PyTorch compiles nothing, so it has no
        counterpart here.
        """
        t_total = self.num_timesteps if time is None else time
        img = self._start(shape, cond, noise, step_noise, generator, device, t_total)
        net = model_fn if params is None else (
            lambda x, t, **kw: model_fn(params, x, t, **kw))
        ts = range(t_total - 1, -1, -1)
        chunk = chunk_size if chunk_size and chunk_size < t_total else max(t_total, 1)
        for s in range(0, t_total, chunk):
            img = self.scan_steps(
                net, img, ts[s : s + chunk],
                None if step_noise is None else step_noise[s : s + chunk],
                cond=cond, generator=generator, clip_denoised=clip_denoised,
                denoised_fn=denoised_fn, cond_fn=cond_fn, model_kwargs=model_kwargs,
            )
        return img

    def scan_steps(self, model_fn, img, ts, step_noise=None, *, cond=None,
                   generator: torch.Generator | None = None, clip_denoised=True,
                   denoised_fn=None, cond_fn=None, model_kwargs=None) -> torch.Tensor:
        """Ancestral steps over an arbitrary timestep segment ``ts``
        (descending): the building block of :meth:`p_sample_loop` and of
        caller-managed chunking. ``step_noise[k]`` is the noise of the k-th
        step of the segment; where it is not given, each step draws its
        noise from ``generator`` just before it runs."""
        for k, i in enumerate(ts):
            t = torch.full((img.shape[0],), int(i), dtype=torch.long, device=img.device)
            eps = (
                step_noise[k]
                if step_noise is not None
                else torch.randn(img.shape, generator=generator, device=img.device)
            )
            img = self.p_sample(
                model_fn, img, t, eps, cond=cond, clip_denoised=clip_denoised,
                denoised_fn=denoised_fn, cond_fn=cond_fn, model_kwargs=model_kwargs,
            )["sample"]
        return img

    def _start(self, shape, cond, noise, step_noise, generator, device, t_total):
        """The initial x_T, drawn unless given, and a check of step_noise."""
        if device is None:
            ref = cond if cond is not None else noise
            device = ref.device if ref is not None else resolve_device()
        if step_noise is not None and len(step_noise) < t_total:
            raise ValueError(f"step_noise has {len(step_noise)} entries for {t_total} steps")
        if noise is not None:
            return noise
        return torch.randn(tuple(shape), generator=generator, device=device)

    def _noised(self, shape, t_total, imgs, noise, generator):
        """q_sample of each of ``imgs`` to step ``t_total - 1`` with one
        shared noise draw (``noise``, else drawn from ``generator``)."""
        ref = imgs[0]
        if noise is None:
            noise = torch.randn(tuple(shape), generator=generator, device=ref.device)
        t0 = torch.full((shape[0],), t_total - 1, dtype=torch.long, device=ref.device)
        return [self.q_sample(im, t0, noise) for im in imgs]

    def p_sample_loop_known(self, model_fn, shape, *, img: torch.Tensor, cond=None,
                            noise=None, step_noise=None,
                            generator: torch.Generator | None = None, clip_denoised=True,
                            denoised_fn=None, cond_fn=None, model_kwargs=None,
                            noise_level: int = 500, time: int | None = None) -> torch.Tensor:
        """Partial noising: q_sample the KNOWN ``img`` to step
        ``min(noise_level, time or T) - 1`` with ``noise`` (drawn first from
        ``generator`` when not given), then the ancestral chain from there
        to 0 (``step_noise`` as in :meth:`p_sample_loop`)."""
        t_total = min(noise_level, self.num_timesteps if time is None else time)
        (x,) = self._noised(shape, t_total, [img], noise, generator)
        return self.p_sample_loop(
            model_fn, shape, cond=cond, noise=x, step_noise=step_noise, generator=generator,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
            model_kwargs=model_kwargs, time=t_total,
        )

    def sample_known(self, model_fn, img: torch.Tensor, *, cond=None, noise=None,
                     step_noise=None, generator: torch.Generator | None = None,
                     clip_denoised=True, denoised_fn=None, cond_fn=None, model_kwargs=None,
                     noise_level: int = 500, time: int | None = None) -> torch.Tensor:
        """:meth:`p_sample_loop_known` at ``img``'s shape. As in the JAX
        package (a documented deviation from the reference, whose version
        cannot run), the model is a parameter and the shape comes from
        ``img``."""
        return self.p_sample_loop_known(
            model_fn, tuple(img.shape), img=img, cond=cond, noise=noise,
            step_noise=step_noise, generator=generator, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, cond_fn=cond_fn, model_kwargs=model_kwargs,
            noise_level=noise_level, time=time,
        )

    def p_sample_loop_interpolation(self, model_fn, shape, *, img1: torch.Tensor,
                                    img2: torch.Tensor, lambdaint: float, cond=None,
                                    noise=None, step_noise=None,
                                    generator: torch.Generator | None = None,
                                    clip_denoised=True, denoised_fn=None, cond_fn=None,
                                    model_kwargs=None, noise_level: int = 300,
                                    time: int | None = None):
        """Latent interpolation: q_sample both endpoints to ``noise_level``
        with ONE shared noise draw, mix ``lambdaint·x1 + (1−lambdaint)·x2``
        and denoise the mixture over ``noise_level-1..0`` (the JAX
        package's deviation from the reference's hard-coded t=299).
        Returns ``(sample, interpol, img1, img2)``."""
        t_total = min(noise_level, self.num_timesteps if time is None else time)
        x1, x2 = self._noised(shape, t_total, [img1, img2], noise, generator)
        interpol = lambdaint * x1 + (1.0 - lambdaint) * x2
        sample = self.p_sample_loop(
            model_fn, shape, cond=cond, noise=interpol, step_noise=step_noise,
            generator=generator, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            cond_fn=cond_fn, model_kwargs=model_kwargs, time=t_total,
        )
        return sample, interpol, img1, img2

    def p_sample_loop_progressive(self, model_fn, shape, *, cond=None, noise=None,
                                  step_noise=None, generator: torch.Generator | None = None,
                                  device=None, clip_denoised=True, denoised_fn=None,
                                  cond_fn=None, model_kwargs=None,
                                  time: int | None = None) -> Iterator[dict]:
        """Generator of each ancestral step's ``{"sample", "pred_xstart"}``,
        ``time`` (default T) of them; noise drawn as :meth:`p_sample_loop`
        draws it, so the last sample is that loop's result."""
        t_total = self.num_timesteps if time is None else time
        img = self._start(shape, cond, noise, step_noise, generator, device, t_total)
        for k, i in enumerate(range(t_total - 1, -1, -1)):
            t = torch.full((img.shape[0],), i, dtype=torch.long, device=img.device)
            eps = (step_noise[k] if step_noise is not None
                   else torch.randn(img.shape, generator=generator, device=img.device))
            out = self.p_sample(model_fn, img, t, eps, cond=cond, clip_denoised=clip_denoised,
                                denoised_fn=denoised_fn, cond_fn=cond_fn,
                                model_kwargs=model_kwargs)
            yield out
            img = out["sample"]

    # -- DDIM ------------------------------------------------------------

    def ddim_sample(self, model_fn, x, t, noise=None, *, cond=None, clip_denoised=True,
                    denoised_fn=None, eta: float = 0.0, cond_fn=None, model_kwargs=None):
        """DDIM step x_t → x_{t-1} (eta-parameterised); ``noise`` is the
        standard-normal draw, needed only when ``eta`` > 0. ``cond_fn``
        applies score-based guidance (:meth:`condition_score`) after the
        model evaluation."""
        out = self.p_mean_variance(
            model_fn, x, t, cond=cond, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        )
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs=model_kwargs)
        x_ref = x[..., : self.target_channels] if self.mode == "i2i" else x
        n = x_ref.dim()
        eps = self.predict_eps_from_xstart(x_ref, t, out["pred_xstart"])
        abar = self._extract("alphas_cumprod", t, n)
        abar_prev = self._extract("alphas_cumprod_prev", t, n)
        sigma = eta * torch.sqrt((1 - abar_prev) / (1 - abar)) * torch.sqrt(1 - abar / abar_prev)
        sample = out["pred_xstart"] * torch.sqrt(abar_prev) + torch.sqrt(
            1 - abar_prev - sigma**2
        ) * eps
        if eta != 0.0:
            if noise is None:
                raise ValueError("ddim_sample with eta > 0 needs its noise")
            nonzero = (t != 0).to(x_ref.dtype).reshape((-1,) + (1,) * (n - 1))
            sample = sample + nonzero * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model_fn, shape, *, cond=None, noise=None, step_noise=None,
                         generator: torch.Generator | None = None, device=None,
                         clip_denoised=True, denoised_fn=None, eta: float = 0.0,
                         cond_fn=None, model_kwargs=None,
                         time: int | None = None) -> torch.Tensor:
        """The DDIM chain from ``time`` (default: every step) to 0; noise
        as in :meth:`p_sample_loop` (per-step noise is drawn only when
        ``eta`` > 0)."""
        t_total = self.num_timesteps if time is None else time
        img = self._start(shape, cond, noise, step_noise, generator, device, t_total)
        return self.ddim_scan_steps(
            model_fn, img, range(t_total - 1, -1, -1), step_noise, cond=cond,
            generator=generator, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, eta=eta, cond_fn=cond_fn, model_kwargs=model_kwargs,
        )

    def ddim_scan_steps(self, model_fn, img, ts, step_noise=None, *, cond=None,
                        generator: torch.Generator | None = None, clip_denoised=True,
                        denoised_fn=None, eta: float = 0.0, cond_fn=None,
                        model_kwargs=None) -> torch.Tensor:
        """DDIM over an arbitrary timestep segment ``ts`` (descending);
        ``step_noise[k]`` is the noise of the k-th step of the segment."""
        for k, i in enumerate(ts):
            t = torch.full((img.shape[0],), int(i), dtype=torch.long, device=img.device)
            eps = None
            if eta != 0.0:
                shape = (*img.shape[:-1], self.target_channels)
                eps = step_noise[k] if step_noise is not None else torch.randn(
                    shape, generator=generator, device=img.device
                )
            img = self.ddim_sample(
                model_fn, img, t, eps, cond=cond, clip_denoised=clip_denoised,
                denoised_fn=denoised_fn, eta=eta, cond_fn=cond_fn, model_kwargs=model_kwargs,
            )["sample"]
        return img

    def ddim_reverse_sample(self, model_fn, x, t, *, cond=None, clip_denoised=True,
                            denoised_fn=None, model_kwargs=None) -> dict[str, torch.Tensor]:
        """Deterministic ODE step x_t → x_{t+1}."""
        out = self.p_mean_variance(
            model_fn, x, t, cond=cond, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        )
        x_ref = x[..., : self.target_channels] if self.mode == "i2i" else x
        eps = self.predict_eps_from_xstart(x_ref, t, out["pred_xstart"])
        abar_next = self._extract("alphas_cumprod_next", t, x_ref.dim())
        sample = out["pred_xstart"] * torch.sqrt(abar_next) + torch.sqrt(1 - abar_next) * eps
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop_known(self, model_fn, shape, *, img: torch.Tensor, noise=None,
                               step_noise=None, generator: torch.Generator | None = None,
                               device=None, clip_denoised=True, denoised_fn=None,
                               cond_fn=None, model_kwargs=None, eta: float = 0.0,
                               noise_level: int = 1000, time: int | None = None):
        """The DDIM chain over ``min(noise_level, time or T)`` steps from
        fresh noise at ``shape``, conditioned on ``img`` by channel concat
        (the i2i path of :meth:`p_mean_variance`, so ``mode`` must be
        "i2i"). Returns ``(sample, None, img)``, the reference's tuple."""
        if self.mode != "i2i":
            raise ValueError(
                "ddim_sample_loop_known conditions on img by channel concat, which "
                f"requires mode='i2i' (got mode={self.mode!r})")
        t_total = min(noise_level, self.num_timesteps if time is None else time)
        sample = self.ddim_sample_loop(
            model_fn, shape, cond=img, noise=noise, step_noise=step_noise,
            generator=generator, device=device, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, eta=eta, cond_fn=cond_fn, model_kwargs=model_kwargs,
            time=t_total,
        )
        return sample, None, img

    def ddim_sample_loop_interpolation(self, model_fn, shape, *, img1: torch.Tensor,
                                       img2: torch.Tensor, lambdaint: float, cond=None,
                                       noise=None, step_noise=None,
                                       generator: torch.Generator | None = None,
                                       clip_denoised=True, denoised_fn=None, cond_fn=None,
                                       model_kwargs=None, eta: float = 0.0,
                                       noise_level: int = 200, time: int | None = None):
        """:meth:`p_sample_loop_interpolation` with the DDIM chain (the
        JAX package's ``noise_level``, where the reference hard-codes
        t=199). Returns ``(sample, interpol, img1, img2)``."""
        t_total = min(noise_level, self.num_timesteps if time is None else time)
        x1, x2 = self._noised(shape, t_total, [img1, img2], noise, generator)
        interpol = lambdaint * x1 + (1.0 - lambdaint) * x2
        sample = self.ddim_sample_loop(
            model_fn, shape, cond=cond, noise=interpol, step_noise=step_noise,
            generator=generator, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            eta=eta, cond_fn=cond_fn, model_kwargs=model_kwargs, time=t_total,
        )
        return sample, interpol, img1, img2

    def ddim_sample_loop_progressive(self, model_fn, shape, *, cond=None, noise=None,
                                     step_noise=None, generator: torch.Generator | None = None,
                                     device=None, clip_denoised=True, denoised_fn=None,
                                     eta: float = 0.0, cond_fn=None, model_kwargs=None,
                                     time: int | None = None) -> Iterator[dict]:
        """Generator of each DDIM step's ``{"sample", "pred_xstart"}``;
        noise drawn as :meth:`ddim_sample_loop` draws it."""
        t_total = self.num_timesteps if time is None else time
        img = self._start(shape, cond, noise, step_noise, generator, device, t_total)
        for k, i in enumerate(range(t_total - 1, -1, -1)):
            t = torch.full((img.shape[0],), i, dtype=torch.long, device=img.device)
            eps = None
            if eta != 0.0:
                eps = step_noise[k] if step_noise is not None else torch.randn(
                    (*img.shape[:-1], self.target_channels), generator=generator,
                    device=img.device)
            out = self.ddim_sample(model_fn, img, t, eps, cond=cond,
                                   clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                   eta=eta, cond_fn=cond_fn, model_kwargs=model_kwargs)
            yield out
            img = out["sample"]

    def dpm_solver_pp_loop(self, model_fn, shape, **kwargs) -> torch.Tensor:
        """DPM-Solver++ multistep sampling (:mod:`.dpm`)."""
        return dpm.dpm_solver_pp_loop(self, model_fn, shape, **kwargs)

    # -- classifier guidance ---------------------------------------------

    def _grad_log_p(self, cond_fn, x, t, model_kwargs):
        """``cond_fn(x, scale_timesteps(t), **model_kwargs)``, the gradient
        ∇ₓ log p(y|x), with autograd on so that it may differentiate a
        classifier even where the loop runs under ``torch.no_grad()``."""
        with torch.enable_grad():
            return cond_fn(x, self.scale_timesteps(t), **(model_kwargs or {}))

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """Shift the posterior mean by Σ·∇ₓ log p(y|x)."""
        gradient = self._grad_log_p(cond_fn, x, t, model_kwargs)
        return p_mean_var["mean"].float() + p_mean_var["variance"] * gradient.float()

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """Score-based conditioning: eps − √(1−ᾱ)·∇ₓ log p(y|x), then x0
        and the posterior mean recomputed from it."""
        x_ref = x[..., : self.target_channels] if self.mode == "i2i" else x
        abar = self._extract("alphas_cumprod", t, x_ref.dim())
        eps = self.predict_eps_from_xstart(x_ref, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1.0 - abar) * self._grad_log_p(cond_fn, x, t, model_kwargs)
        out = dict(p_mean_var)
        out["pred_xstart"] = self.predict_xstart_from_eps(x_ref, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x_ref, t)
        return out

    # -- training loss ---------------------------------------------------

    def training_losses(
        self,
        model_fn,
        batch: dict[str, torch.Tensor] | torch.Tensor,
        t: torch.Tensor,
        generator: torch.Generator | None = None,
        *,
        contr: str = "t1n",
        mode: str | None = None,
        model_kwargs: dict | None = None,
        noise_img: torch.Tensor | None = None,
    ):
        """x0-prediction MSE in wavelet space (the JAX package's
        ``training_losses``).

        ``batch``: image-space volumes ``(B, X, Y, Z, 1)`` per modality in
        i2i mode, or one tensor otherwise. The noise is drawn in image space
        (``noise_img``, or from ``generator``) and DWT'd without the LLL/3
        scaling, as the reference does; the conditions and the target are
        DWT'd with it. ``model_fn(x, t)`` takes and returns channels-last
        tensors.

        Returns ``(terms, model_output, model_output_idwt)``:
        ``terms["mse_wav"]`` is the per-subband (8,) MSE (mean over the
        voxels, then the batch) and ``terms["loss_per_sample"]`` the (B,)
        mean over everything else. Under an active sp axis the batch holds
        this rank's Y slabs: the means are the volumes', and the two
        outputs are slabs. The objective is always x0-prediction,
        so the diffusion must be built with ``MeanType.START_X``.
        """
        if self.mean_type != MeanType.START_X:
            raise ValueError(
                "training_losses trains an x0-predictor (wavelet-space MSE)"
                f" but this diffusion has mean_type={self.mean_type}; build"
                " it with predict_xstart=True / MeanType.START_X so sampling"
                " interprets the model output correctly"
            )
        mode = mode or self.mode
        model_kwargs = model_kwargs or {}
        if mode == "i2i":
            target = batch[contr]
            cond_dwt = torch.cat(
                [wv.dwt_normalized(batch[m], self.wavelet) for m in condition_order(contr)],
                dim=-1,
            )
        else:
            target, cond_dwt = batch, None
        x_start_dwt = wv.dwt_normalized(target, self.wavelet)
        if noise_img is None:
            noise_img = torch.randn(target.shape, generator=generator,
                                    dtype=target.dtype, device=target.device)
        noise_dwt = wv.dwt3_flat(noise_img, self.wavelet)  # no LLL scaling
        x_t = self.q_sample(x_start_dwt, t, noise_dwt)
        if cond_dwt is not None:
            x_t = torch.cat([x_t, cond_dwt], dim=-1)
        model_output = model_fn(x_t, self.scale_timesteps(t), **model_kwargs)
        model_output_idwt = wv.idwt_normalized(model_output, 1, self.wavelet)
        sq = (x_start_dwt - model_output) ** 2
        if current_sp() is None:
            mse_wav = sq.mean(dim=tuple(range(1, sq.dim() - 1))).mean(dim=0)
            per_sample = sq.mean(dim=tuple(range(1, sq.dim())))
        else:
            # this rank's Y slab: per-(row, subband) sums and the voxel
            # count, summed over the sp group (every rank holds the loss)
            n = torch.full((sq.shape[0], 1), float(sq[0, ..., 0].numel()), device=sq.device)
            sums = global_sum_sp(torch.cat([sq.sum(dim=tuple(range(1, sq.dim() - 1))), n], 1))
            per_band = sums[:, :-1] / sums[:, -1:]
            mse_wav, per_sample = per_band.mean(dim=0), per_band.mean(dim=1)
        terms = {"mse_wav": mse_wav, "loss_per_sample": per_sample}
        return terms, model_output, model_output_idwt


    # -- variational bound -----------------------------------------------

    def vb_terms_bpd(self, model_fn, x_start, x_t, t, *, cond=None,
                     clip_denoised=True) -> dict[str, torch.Tensor]:
        """The bound's term at ``t`` in bits per dimension: KL(q‖p) of the
        posterior, or the decoder's discretized NLL where t == 0."""
        from fast_cwdm_tpu_torch.diffusion import losses  # losses → models → this module
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, cond=cond, clip_denoised=clip_denoised)
        kl = losses.normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = losses.mean_flat(kl) / math.log(2.0)
        decoder_nll = -losses.discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = losses.mean_flat(decoder_nll) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}

    def prior_bpd(self, x_start) -> torch.Tensor:
        """KL(q(x_T|x_0) ‖ N(0, I)) in bits per dimension, (B,)."""
        from fast_cwdm_tpu_torch.diffusion import losses
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        mean, _, log_var = self.q_mean_variance(x_start, t)
        return losses.mean_flat(losses.normal_kl(mean, log_var, 0.0, 0.0)) / math.log(2.0)

    def calc_bpd_loop(self, model_fn, x_start, *, cond=None, clip_denoised=True,
                      step_noise=None,
                      generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """The whole variational bound, t = T-1 down to 0 (implemented
        correctly, as in the JAX package; the reference's is broken).
        ``step_noise[k]`` is the q_sample noise of the k-th timestep
        visited, else drawn from ``generator`` one timestep at a time.

        Returns total_bpd (B,), prior_bpd (B,), vb, xstart_mse and mse
        (B, T), in the order t = T-1 … 0 along the second axis."""
        from fast_cwdm_tpu_torch.diffusion import losses
        b = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for k, ti in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((b,), ti, dtype=torch.long, device=x_start.device)
            noise = (step_noise[k] if step_noise is not None
                     else torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                                      device=x_start.device))
            x_t = self.q_sample(x_start, t, noise)
            out = self.vb_terms_bpd(model_fn, x_start, x_t, t, cond=cond,
                                    clip_denoised=clip_denoised)
            vb.append(out["output"])
            xstart_mse.append(losses.mean_flat((out["pred_xstart"] - x_start) ** 2))
            eps = self.predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            mse.append(losses.mean_flat((eps - noise) ** 2))
        vb = torch.stack(vb, dim=1)
        prior = self.prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb,
                "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(mse, dim=1)}
