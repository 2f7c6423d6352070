"""DPM-Solver++ multistep sampling (port of ``fast_cwdm_tpu/diffusion/dpm.py``).

DPM-Solver++ (Lu et al. 2022, arXiv:2211.01095) integrates the
probability-flow ODE in log-SNR time with the data-prediction
parameterisation, a direct fit for the x0-predicting model: the solver's
D(x, t) is the model output after the clamp/Haar projection
(``p_mean_variance``'s ``pred_xstart``). The second-order multistep variant
(2M) reuses the previous step's x0 prediction, so N model evaluations buy a
second-order chain. With ``order=1`` each transition equals a DDIM (eta=0)
step over the same timestep subsequence.

The coefficients are computed on the host in float64 from the diffusion's
``alphas_cumprod`` and cast to float32, exactly as in the JAX package; the
chain is a Python loop of eager steps on the device (``diffusion/graph.py``
replays one captured :func:`dpm_step` instead).
"""

from __future__ import annotations

import numpy as np
import torch


def dpm_timestep_indices(num_timesteps: int, steps: int) -> np.ndarray:
    """Descending schedule indices T-1 → 0, evenly spaced in index space
    (round of linspace, the rule of the "sampled" schedule)."""
    if not 2 <= steps <= num_timesteps:
        raise ValueError(f"steps must be in [2, {num_timesteps}], got {steps}")
    idx = np.unique(np.round(np.linspace(0, num_timesteps - 1, steps)).astype(np.int64))[::-1]
    # spacing (T-1)/(steps-1) >= 1: the rounded points never collide
    assert len(idx) == steps and idx[0] == num_timesteps - 1 and idx[-1] == 0
    return np.ascontiguousarray(idx)


def _solver_tables(alphas_cumprod: np.ndarray, idx: np.ndarray, order: int):
    """Per-transition coefficients of the 2M chain, float64 → float32.

    Points are the ``len(idx)`` schedule indices plus a terminal point with
    alpha-bar = 1. Transition j runs point j → j+1:

      x_{j+1} = (sigma_{j+1}/sigma_j) * x_j - alpha_{j+1} * expm1(-h_{j+1}) * D~_j
      D~_j    = (1 + c_j) * D_j - c_j * D_{j-1},   c_j = h_{j+1} / (2 h_j)

    with alpha = sqrt(alpha-bar), sigma = sqrt(1 - alpha-bar), h the step in
    lambda = log(alpha/sigma). ``c_j`` is zero at the first and the last
    transition, and everywhere when ``order == 1``.
    """
    ab = np.asarray(alphas_cumprod, dtype=np.float64)[idx]
    alpha = np.sqrt(ab)
    sigma = np.sqrt(1.0 - ab)
    lam = np.log(alpha) - np.log(sigma)
    n = len(idx)
    sigma_ratio = np.zeros(n)
    acoef = np.zeros(n)
    mix = np.zeros(n)
    h = np.diff(lam)
    if np.any(h <= 0):
        raise ValueError(
            "alpha-bar must be strictly increasing along the solver path; "
            "schedule has a non-monotone segment at the chosen indices"
        )
    sigma_ratio[: n - 1] = sigma[1:] / sigma[:-1]
    acoef[: n - 1] = alpha[1:] * np.expm1(-h)
    # terminal transition: alpha=1, sigma=0, h=inf → expm1(-inf) = -1
    sigma_ratio[n - 1] = 0.0
    acoef[n - 1] = -1.0
    if order == 2:
        mix[1 : n - 1] = h[1:] / (2.0 * h[:-1])
    elif order != 1:
        raise ValueError(f"order must be 1 or 2, got {order}")
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return f32(sigma_ratio), f32(acoef), f32(mix)


def dpm_step(diffusion, model_fn, x, prev_x0, t, s_ratio, a_c, c, *, cond=None,
             clip_denoised: bool = True, denoised_fn=None, cond_fn=None, model_kwargs=None):
    """One transition of the 2M chain from ``x`` at timesteps ``t`` with the
    previous x0 prediction ``prev_x0`` and the transition's coefficients
    (0-dim tensors of :func:`_solver_tables`); returns ``(x_next, x0)``.
    ``cond_fn`` applies score-based guidance (``condition_score``)."""
    out = diffusion.p_mean_variance(
        model_fn, x, t, cond=cond, clip_denoised=clip_denoised,
        denoised_fn=denoised_fn, model_kwargs=model_kwargs,
    )
    if cond_fn is not None:
        out = diffusion.condition_score(cond_fn, out, x, t, model_kwargs=model_kwargs)
    x0 = out["pred_xstart"]
    x0_tilde = (1.0 + c) * x0 - c * prev_x0
    return s_ratio * x - a_c * x0_tilde, x0


def solver_tables(diffusion, idx: np.ndarray, order: int, device) -> torch.Tensor:
    """The coefficients of the chain over schedule indices ``idx`` as one
    (3, steps) float32 tensor on ``device``: sigma ratio, alpha coefficient
    and 2M mix of each transition."""
    return torch.as_tensor(np.stack(_solver_tables(diffusion.alphas_cumprod, idx, order)),
                           device=device)


def dpm_solver_pp_loop(diffusion, model_fn, shape, *, cond=None, noise=None,
                       generator: torch.Generator | None = None, device=None,
                       steps: int = 50, order: int = 2, clip_denoised: bool = True,
                       denoised_fn=None, cond_fn=None, model_kwargs=None) -> torch.Tensor:
    """Sample with DPM-Solver++ multistep: ``steps`` model evaluations.
    Deterministic given ``noise``; otherwise the initial latent is drawn
    from ``generator`` on ``device`` (default: the device of ``cond``, else
    CUDA). The JAX package draws it from its key without a split."""
    idx = dpm_timestep_indices(diffusion.num_timesteps, steps)
    x = diffusion._start(shape, cond, noise, None, generator, device, steps)
    tables = solver_tables(diffusion, idx, order, x.device)
    prev_x0 = torch.zeros_like(x)
    for j, t_index in enumerate(idx):
        t = torch.full((x.shape[0],), int(t_index), dtype=torch.long, device=x.device)
        x, prev_x0 = dpm_step(
            diffusion, model_fn, x, prev_x0, t, *tables[:, j], cond=cond,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
            model_kwargs=model_kwargs,
        )
    return x
