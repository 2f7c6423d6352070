"""Timestep samplers (port of ``fast_cwdm_tpu/diffusion/resample.py``).

``UniformSampler`` is the production one. ``LossSecondMomentResampler``
samples t in proportion to sqrt(E[loss²]) per timestep once every timestep
has ``history_per_term`` recorded losses. Its state is a
:class:`LossAwareState` of two tensors, updated functionally as in the JAX
package; ``update(..., axis_name="data")`` first gathers every rank's t
and losses over the process group (``parallel/mesh.py``), so that every
rank records the same history. Draws come from a ``torch.Generator``
instead of a ``jax.random`` key.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class UniformSampler:
    """Uniform t with importance weights 1."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: torch.Generator | None, batch_size: int, state=None,
               device: str | torch.device = "cpu"):
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator,
                          device=device)
        return t, torch.ones((batch_size,), dtype=torch.float32, device=device)

    def init_state(self, device: str | torch.device = "cpu"):
        return ()

    def update(self, state, t, losses, axis_name: str | None = None):
        return state


@dataclass
class LossAwareState:
    """Ring buffer of recent losses per timestep."""

    loss_history: torch.Tensor  # (T, K) float32
    loss_counts: torch.Tensor  # (T,) int32


class LossSecondMomentResampler:
    """Importance-sample t ∝ sqrt(E[loss²]) once warmed up."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device: str | torch.device = "cpu") -> LossAwareState:
        return LossAwareState(
            loss_history=torch.zeros((self.num_timesteps, self.history_per_term),
                                     dtype=torch.float32, device=device),
            loss_counts=torch.zeros((self.num_timesteps,), dtype=torch.int32, device=device),
        )

    def weights(self, state: LossAwareState) -> torch.Tensor:
        """The sampling distribution over t: uniform until every timestep
        has a full history."""
        warmed = bool((state.loss_counts == self.history_per_term).all())
        if not warmed:
            return torch.full((self.num_timesteps,), 1.0 / self.num_timesteps,
                              dtype=torch.float32, device=state.loss_history.device)
        w = torch.sqrt(torch.mean(state.loss_history**2, dim=-1))
        w = w / torch.sum(w)
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def sample(self, generator: torch.Generator | None, batch_size: int,
               state: LossAwareState, device: str | torch.device | None = None):
        p = self.weights(state)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t])

    def update(self, state: LossAwareState, t: torch.Tensor, losses: torch.Tensor,
               axis_name: str | None = None, mesh=None) -> LossAwareState:
        """Record per-example losses at their timesteps, in batch order
        (a full row shifts left and takes the new loss at its end). With
        ``axis_name`` ("data") every data index's t and losses are gathered
        in order first (over ``mesh``'s data axis, default
        ``make_mesh()``), as the JAX package's ``all_gather`` does, so every
        rank's history stays the same; the ranks of an sp group hold the
        same rows, t and (volume) losses, and gather nothing among
        themselves."""
        if axis_name is not None:
            from fast_cwdm_tpu_torch.parallel.mesh import DATA_AXIS, all_gather_rows, make_mesh

            if axis_name != DATA_AXIS:
                raise ValueError(f"axis_name must be {DATA_AXIS!r} or None, got {axis_name!r}")
            mesh = mesh or make_mesh()
            t, losses = all_gather_rows(mesh, t), all_gather_rows(mesh, losses)
        hist = state.loss_history.clone()
        counts = state.loss_counts.clone()
        k = self.history_per_term
        for ti, li in zip(t.tolist(), losses.detach().float()):
            count = int(counts[ti])
            if count == k:
                hist[ti] = torch.cat([hist[ti, 1:], li.reshape(1).to(hist)])
            else:
                hist[ti, count] = li
            counts[ti] = min(count + 1, k)
        return LossAwareState(loss_history=hist, loss_counts=counts)
