"""Training state and the EMA update (port of
``fast_cwdm_tpu/training/state.py``).

Everything a train step changes lives in one :class:`TrainState`: the
completed step count, the parameters (the model's own ``nn.Parameter``
objects by name, updated in place), the optimizer state, one EMA shadow per
rate and the timestep sampler's state. The JAX package's state is an
immutable pytree that its jitted step returns anew; here the step updates
these tensors in place and returns the same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    opt_state: dict[str, Any]
    ema_params: tuple[dict[str, torch.Tensor], ...] = ()
    ema_rates: tuple[float, ...] = ()
    sampler_state: Any = ()

    @classmethod
    def create(cls, model: torch.nn.Module, opt, *, ema_rates=(), sampler_state=()) -> "TrainState":
        """The state of a fresh run: step 0, ``opt.init`` of the model's
        parameters, and each EMA shadow a copy of them."""
        params = dict(model.named_parameters())
        return cls(
            step=0,
            params=params,
            opt_state=opt.init(params),
            ema_params=tuple(
                {k: v.detach().clone() for k, v in params.items()} for _ in ema_rates
            ),
            ema_rates=tuple(float(r) for r in ema_rates),
            sampler_state=sampler_state,
        )


def ema_rate_at(rate: float, step: int) -> np.float32:
    """The warmed-up EMA rate ``min(rate, (1+t)/(10+t))`` in float32, with
    t the count of completed optimizer steps (after the step's increment),
    as the JAX package computes it."""
    t = np.float32(step)
    return min(np.float32(rate), (np.float32(1.0) + t) / (np.float32(10.0) + t))


@torch.no_grad()
def update_ema(state: TrainState) -> None:
    """Every shadow ``e ← e·r + p·(1 − r)`` in place, ``r = ema_rate_at(rate,
    state.step)``. The warm-up makes early shadows track the parameters and
    anneal toward the asymptotic rate (the JAX package's measured fix for
    shadows that otherwise remember the random init)."""
    names = list(state.params)
    params = [state.params[k].detach() for k in names]
    for rate, ema in zip(state.ema_rates, state.ema_params):
        r = ema_rate_at(rate, state.step)
        shadows = [ema[k] for k in names]
        torch._foreach_mul_(shadows, float(r))
        torch._foreach_add_(shadows, torch._foreach_mul(params, float(np.float32(1.0) - r)))
