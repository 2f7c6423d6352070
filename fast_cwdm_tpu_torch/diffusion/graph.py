"""The reverse chain on the card as replays of one captured CUDA graph.

The JAX package runs the whole chain as one jitted program, a
``lax.scan`` over the steps (``fast_cwdm_tpu/cli/common.py``,
``make_synthesis_fn``). Eager PyTorch launches every operation of every
step from the host, over a thousand per UNet forward, and the card waits
on the host between them. Here one reverse step of a sampler (ddpm:
``GaussianDiffusion.p_sample``; ddim: ``ddim_sample`` with eta 0; dpm++:
``dpm.dpm_step``) is captured once with ``torch.cuda.graph`` and replayed
once per step.

- **Static buffers.** The captured step reads every per-step input from
  buffers allocated before the capture: the latent, the timesteps, the
  step noise (ddpm), the solver coefficients and the previous x0 (dpm++),
  and the condition. The host fills them with device-to-device copies
  before each replay.
- **Noise.** The step noise is drawn outside the graph from the caller's
  generator, one draw per step in the order of the steps, as the eager
  loop (``GaussianDiffusion.scan_steps``) draws it, so the same generator
  seed gives the eager chain's result. ``chunk`` bounds how many steps'
  noise is drawn ahead into one buffer; it changes no number.
- **Warm-up.** The first two steps of a new graph run eagerly on a side
  stream, so that what is built at first use (the schedule tables and the
  x0 projection's constants on the device, the packed wgmma weights,
  cuDNN's plans, the kernel libraries) exists before the capture. They
  are real steps of the chain. The third step is captured, and every step
  from there on is a replay.
- **Launch counters.** The wrappers count when Python calls them: once
  while the step is captured, never during a replay. The capture's counts
  are taken back and kept as the launches of one step, and each replay
  adds them, so the counts per volume are those of the eager chain.
- **One memory pool.** Every graph of the process allocates from one
  private pool per device: the graphs of several models (one per missing
  modality in ``cli.complete_dataset``) share it. That is safe because no
  two graphs replay at once and a chain copies its result out of the pool
  before it returns.
- **No fallback.** A failed capture or replay raises; nothing here runs
  the eager loop in its place.

The capture runs in the default ("global") error mode: no thread of the
CLIs (NIfTI decode, prefetch and write) makes a CUDA call.
"""

from __future__ import annotations

import time

import torch

from fast_cwdm_tpu_torch import ops
from fast_cwdm_tpu_torch.diffusion import dpm

WARMUP_STEPS = 2
SAMPLERS = ("ddpm", "ddim", "dpm++")
_POOLS: dict[int, torch.cuda.MemPool] = {}
# graphs captured and replayed in this process (a run shows with them that
# it went through the captured chain)
counts = {"captures": 0, "replays": 0}


def graph_pool(device: torch.device) -> tuple[int, int]:
    """The id of the memory pool that every CUDA graph of the process on
    ``device`` allocates from. A ``MemPool`` keeps its pool alive by itself;
    the bare id of ``torch.cuda.graph_pool_handle()`` may not be captured
    into again once every graph that used it is gone."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _POOLS:
        with torch.cuda.device(index):
            _POOLS[index] = torch.cuda.MemPool()
    return _POOLS[index].id


class StepGraph:
    """``step(**inputs) -> tuple of tensors`` on static input buffers shaped
    like ``inputs``. A call copies its keyword tensors into the buffers of
    those names, then runs the step: eagerly on a side stream for the first
    ``WARMUP_STEPS`` calls, then as a replay of the graph captured at the
    next call. ``capture_seconds``, ``pool_bytes`` (the growth of the
    memory reserved by the allocator over the capture) and
    ``launches_per_replay`` are known after the capture."""

    def __init__(self, step, inputs: dict[str, torch.Tensor]):
        self.step = step
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple[torch.Tensor, ...] = ()
        self.launches_per_replay: dict[str, int] = {}
        self.capture_seconds: float | None = None
        self.pool_bytes: int | None = None
        self.warmups = 0

    def __call__(self, **feed: torch.Tensor) -> tuple[torch.Tensor, ...]:
        for k, v in feed.items():
            self.inputs[k].copy_(v)
        if self.graph is None:
            if self.warmups < WARMUP_STEPS:
                self.warmups += 1
                return self._eager_on_side_stream()
            self._capture()
        self.graph.replay()
        counts["replays"] += 1
        now = ops.launch_counts()
        ops.set_launch_counts({k: now[k] + n for k, n in self.launches_per_replay.items()})
        return self.outputs

    def _eager_on_side_stream(self) -> tuple[torch.Tensor, ...]:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.step(**self.inputs)
        main.wait_stream(side)
        for t in out:  # read on the main stream: not reused before that
            t.record_stream(main)
        return out

    def _capture(self) -> None:
        dev = next(iter(self.inputs.values())).device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=graph_pool(dev)):
                outputs = self.step(**self.inputs)
            after = ops.launch_counts()
        finally:
            ops.set_launch_counts(before)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches_per_replay = {k: after[k] - n for k, n in before.items() if after[k] != n}
        self.graph, self.outputs = graph, outputs
        counts["captures"] += 1


class CapturedChain:
    """The reverse chain of ``sampler`` ("ddpm", "ddim" with eta 0, or
    "dpm++" with ``steps`` evaluations) over ``model_fn(x, t)``, each step a
    replay of one :class:`StepGraph`. The graph is built at the first call
    and built again when the latent's or the condition's shape, or any of
    ``parameters`` (the model's weights: written or moved), changes."""

    def __init__(self, diffusion, model_fn, sampler: str, *, steps: int | None = None,
                 clip_denoised: bool = True, parameters=()):
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        self.diffusion = diffusion
        self.model_fn = model_fn
        self.sampler = sampler
        self.steps = steps or min(50, diffusion.num_timesteps)
        self.clip_denoised = clip_denoised
        self.parameters = list(parameters)
        self.graph: StepGraph | None = None
        self._key = None

    def _step(self):
        d, f, cd = self.diffusion, self.model_fn, self.clip_denoised
        if self.sampler == "ddpm":
            return lambda img, t, noise, cond: (
                d.p_sample(f, img, t, noise, cond=cond, clip_denoised=cd)["sample"],)
        if self.sampler == "ddim":
            return lambda img, t, cond: (
                d.ddim_sample(f, img, t, cond=cond, clip_denoised=cd)["sample"],)
        return lambda img, t, prev_x0, coef, cond: dpm.dpm_step(
            d, f, img, prev_x0, t, *coef, cond=cond, clip_denoised=cd)

    def _graph_for(self, img: torch.Tensor, cond: torch.Tensor) -> StepGraph:
        key = (tuple(img.shape), tuple(cond.shape), img.device,
               tuple((p._version, p.data_ptr()) for p in self.parameters))
        if key != self._key:
            self.graph = None  # free the old graph's memory before the new one
            t = torch.zeros(img.shape[0], dtype=torch.long, device=img.device)
            inputs = {"img": img, "t": t, "cond": cond}
            if self.sampler == "ddpm":
                inputs["noise"] = img
            elif self.sampler == "dpm++":
                inputs["prev_x0"] = img
                inputs["coef"] = torch.zeros(3, device=img.device)
            self.graph = StepGraph(self._step(), inputs)
            self._key = key
        return self.graph

    @torch.inference_mode()
    def __call__(self, shape, *, cond: torch.Tensor, noise: torch.Tensor | None = None,
                 step_noise=None, generator: torch.Generator | None = None,
                 chunk: int | None = None) -> torch.Tensor:
        """The chain from x_T (``noise``, or drawn from ``generator``) to x_0,
        as the eager loops of the sampler compute it: ``step_noise[k]`` (ddpm)
        is the noise of the k-th step, else drawn from ``generator``, at most
        ``chunk`` steps ahead (None: the whole chain)."""
        d = self.diffusion
        if self.sampler == "dpm++":  # raises on a bad step count before any draw
            idx = dpm.dpm_timestep_indices(d.num_timesteps, self.steps)
        n_steps = self.steps if self.sampler == "dpm++" else d.num_timesteps
        x = d._start(shape, cond, noise, None if self.sampler == "dpm++" else step_noise,
                     generator, cond.device, n_steps)
        g = self._graph_for(x, cond)
        g.inputs["cond"].copy_(cond)
        b, dev = x.shape[0], x.device
        if self.sampler == "dpm++":
            tables = dpm.solver_tables(d, idx, 2, dev)
            ts = torch.as_tensor(idx, device=dev)[:, None].expand(-1, b)
            prev_x0 = torch.zeros_like(x)
            for j in range(self.steps):
                x, prev_x0 = g(img=x, t=ts[j], prev_x0=prev_x0, coef=tables[:, j])
            return x.clone()
        ts = torch.arange(n_steps - 1, -1, -1, device=dev)[:, None].expand(-1, b)
        if self.sampler == "ddim":
            for k in range(n_steps):
                (x,) = g(img=x, t=ts[k])
            return x.clone()
        seg = chunk if chunk and chunk < n_steps else n_steps
        for s in range(0, n_steps, seg):
            n = min(seg, n_steps - s)
            if step_noise is None:
                eps = torch.empty((n, *x.shape), device=dev)
                for k in range(n):  # one draw per step, as torch.randn in scan_steps
                    eps[k].normal_(generator=generator)
            else:
                eps = step_noise[s : s + n]
            for k in range(n):
                (x,) = g(img=x, t=ts[s + k], noise=eps[k])
        return x.clone()
