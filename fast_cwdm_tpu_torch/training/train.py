"""The train step (port of ``fast_cwdm_tpu/training/train.py``).

One optimizer step: t from the schedule sampler, image-space noise, the
DWTs of the four modalities (kernel K1), the UNet forward and backward
(K3 and its VJP under ``fuse_gn_silu``), the IDWT of the prediction (K2),
AdamW with the linear anneal, the EMA shadows and the metrics. Nothing
reads a value back to the host, except the loss-aware sampler's update;
the metrics stay tensors on the device until the caller reads them.

Randomness: the JAX step splits one key into t, noise and dropout keys;
the port draws each from its own ``torch.Generator`` (:class:`StepRNG`),
and the step takes explicit ``t`` and ``noise_img`` so that tests can feed
it the JAX side's draws.

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank holds its
rows of the global batch. t and the noise are drawn for the GLOBAL batch
from the step's generators on every rank and each rank takes its rows, so
a sharded step computes what an unsharded step on the global batch
computes. After the backward (and any accumulation) one all-reduce of a
flat float32 buffer averages the gradients, the loss and the batch-mean
metrics over the ranks; AdamW and the EMA then run identically on every
rank. Under a tp axis (``parallel.mesh.shard_params``) the ranks of a tp
group hold the same rows and draws, each its slices of the sharded
parameters: their gradients are averaged over the replica group in a
second all-reduce, and AdamW and the EMA update each rank's slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from fast_cwdm_tpu_torch.diffusion.resample import LossSecondMomentResampler, UniformSampler
from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict, state_dict_from_jax
from fast_cwdm_tpu_torch.parallel import mesh as pmesh
from fast_cwdm_tpu_torch.training.state import TrainState, update_ema

# metric leaves that are image panels (mid-plane slices), not scalars: the
# loop fetches them only on image-log steps
IMAGE_METRIC_KEYS = ("sample_slice", "subband_slices")
# metric leaves with one row per sample: a rank's rows under a mesh
PER_SAMPLE_METRIC_KEYS = ("loss_per_sample", "t") + IMAGE_METRIC_KEYS


class AdamW:
    """optax's ``adamw`` (scale_by_adam → add_decayed_weights →
    scale_by_learning_rate), one operation at a time in its order and in
    float32, over a dict of parameters, in place.

    ``lr_anneal_steps`` > 0 anneals the learning rate linearly,
    ``lr·(1 − min(count, N)/N)``, evaluated at the count before the update
    (optax's schedule state). The state is ``{"count": int, "mu": {name:
    tensor}, "nu": {name: tensor}}``; :meth:`state_to_tree` and
    :meth:`state_from_tree` map it to and from optax's tree, under the JAX
    parameter names of ``models/convert.py``."""

    def __init__(self, lr: float, *, weight_decay: float = 0.0, lr_anneal_steps: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.weight_decay = weight_decay
        self.lr_anneal_steps = int(lr_anneal_steps)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict[str, torch.Tensor]) -> dict[str, Any]:
        zeros = lambda: {k: torch.zeros_like(v, memory_format=torch.contiguous_format)  # noqa: E731
                         for k, v in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def learning_rate(self, count: int) -> np.float32:
        """The float32 step size at update ``count`` (0-based)."""
        lr = np.float32(self.lr)
        if not self.lr_anneal_steps:
            return lr
        n = self.lr_anneal_steps
        return lr * (np.float32(1.0) - np.float32(min(count, n)) / np.float32(n))

    @torch.no_grad()
    def update_(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                state: dict[str, Any]) -> None:
        names = list(params)
        p = [params[k].detach() for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        count = state["count"] + 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        # mu = (1 − b1)·g + b1·mu; nu = (1 − b2)·g² + b2·nu
        torch._foreach_mul_(mu, float(b1))
        torch._foreach_add_(mu, torch._foreach_mul(g, float(np.float32(1.0 - self.b1))))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, float(np.float32(1.0 - self.b2)))
        torch._foreach_mul_(nu, float(b2))
        torch._foreach_add_(nu, g2)
        del g2
        # bias corrections 1 − b**count in float32
        c = np.float32(count)
        u = torch._foreach_div(mu, float(np.float32(1.0) - b1**c))
        nu_hat = torch._foreach_div(nu, float(np.float32(1.0) - b2**c))
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, float(np.float32(self.eps)))
        torch._foreach_div_(u, nu_hat)
        del nu_hat
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, float(np.float32(self.weight_decay))))
        torch._foreach_mul_(u, float(-self.learning_rate(state["count"])))
        torch._foreach_add_(p, u)
        state["count"] = count

    def state_to_tree(self, state: dict[str, Any], model: torch.nn.Module,
                      mesh: pmesh.DataMesh | None = None) -> tuple:
        """optax's ``adamw`` state tree, as the JAX package's ``opt_*.ckpt``
        holds it: ``(ScaleByAdamState(count, mu, nu), EmptyState(),
        ScaleByScheduleState(count) or EmptyState())`` with int32 counts and
        float32 moments under the JAX parameter names. Under ``mesh``'s tp
        axis the moments' slices are gathered first (collective over the tp
        group)."""
        count = np.asarray(state["count"], np.int32)
        full = (lambda t: t) if mesh is None else (  # noqa: E731
            lambda t: pmesh.gather_params(mesh, model, t))
        adam = {"count": count,
                "mu": jax_params_from_state_dict(full(state["mu"]), model),
                "nu": jax_params_from_state_dict(full(state["nu"]), model)}
        sched = {"count": count.copy()} if self.lr_anneal_steps else {}
        return (adam, {}, sched)

    def state_from_tree(self, tree, model: torch.nn.Module, device: str | torch.device,
                        mesh: pmesh.DataMesh | None = None) -> dict[str, Any]:
        """The inverse of :meth:`state_to_tree`, from a loaded ``.ckpt`` tree
        (tuples come back keyed "0", "1", "2"); under ``mesh``'s tp axis the
        moments of the sharded parameters are this rank's slices."""
        adam = tree["0"] if isinstance(tree, dict) else tree[0]
        # by parameter name: a shared tensor's alias keys (the WavUNet's
        # decoder) name no moment of their own
        names = dict(model.named_parameters())

        def to_dev(sd):
            sd = {k: sd[k] for k in names}
            if mesh is not None:
                sd = pmesh.shard_tensors(mesh, model, sd)
            return {k: v.to(device=device, dtype=torch.float32).contiguous()
                    for k, v in sd.items()}

        return {"count": int(np.asarray(adam["count"])),
                "mu": to_dev(state_dict_from_jax(adam["mu"], model)),
                "nu": to_dev(state_dict_from_jax(adam["nu"], model))}


def make_optimizer(lr: float, *, weight_decay: float = 0.0, lr_anneal_steps: int = 0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamW:
    """AdamW with the reference's linear anneal (``lr·(1 − step/N)``)."""
    return AdamW(lr, weight_decay=weight_decay, lr_anneal_steps=lr_anneal_steps,
                 b1=b1, b2=b2, eps=eps)


@dataclass
class StepRNG:
    """One generator per purpose: timesteps, image-space noise (both on the
    training device) and dropout (seeds the device's default generator
    around the forward and backward)."""

    t: torch.Generator
    noise: torch.Generator
    dropout: torch.Generator

    @classmethod
    def seeded(cls, seed: int, device: str | torch.device) -> "StepRNG":
        dev = torch.device(device)
        return cls(t=torch.Generator(device=dev).manual_seed(seed),
                   noise=torch.Generator(device=dev).manual_seed(seed + 1),
                   dropout=torch.Generator().manual_seed(seed + 2))


def _max_abs(tensors) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(list(tensors), float("inf"))).max()


def _has_dropout(model: torch.nn.Module) -> bool:
    return any(isinstance(m, torch.nn.Dropout) and m.p > 0 for m in model.modules())


def make_train_step(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    opt: AdamW,
    *,
    contr: str = "t1n",
    mode: str = "i2i",
    sampler: Any = None,
    compute_dtype: torch.dtype | None = None,
    with_norms: bool = True,
    accum_steps: int = 1,
    lesion_weight: float = 0.0,
    lesion_core_weight: float = 0.0,
    lesion_t_power: float = 0.0,
    mesh: pmesh.DataMesh | None = None,
) -> Callable[..., tuple[TrainState, dict]]:
    """Build ``step(state, batch, rng=None, *, t=None, noise_img=None) ->
    (state, metrics)``.

    ``batch``: image-space volumes ``(B, X, Y, Z, 1)`` per modality (i2i),
    or one tensor, on the training device. ``t`` and ``noise_img``
    override the sampler's and the noise generator's draws. The model is
    put in training mode (dropout on).

    ``mesh``: the data, sp and tp axes. ``batch`` is then this rank's rows of
    the global batch (``mesh.size`` times as many) and, under sp, its Y
    slab of every volume (``shard_batch``); ``t`` / ``noise_img``, given or
    drawn, are the global batch's (whole volumes), of which the step takes
    its rows and slab, so the ranks of an sp group use the same t and the
    same noise. Under sp every rank backpropagates the volumes' loss
    through its slab (its gradients are its slab's share); the one
    all-reduce sums them over sp and averages over data. Under a tp axis
    the ranks of a tp group take the same rows, slab and draws; the
    parameters ``shard_params`` sliced are reduced over the replica group
    (their own all-reduce), the others over the world, and the norm
    metrics are maxima over the tp group. The collectives' bytes and
    milliseconds go to ``step.comm`` (a
    :class:`~fast_cwdm_tpu_torch.parallel.mesh.CommLog`, by kind: the
    gradient all-reduce, the sp halos, reductions and gathers, and the tp
    gathers).

    ``accum_steps``: the batch is split into that many microbatches run
    one after another (one microbatch's activations live at a time), the
    gradients averaged, ONE optimizer step; the same t and the same
    full-batch noise draw as without accumulation, sliced.

    ``lesion_weight`` / ``lesion_core_weight`` add the image-space MSE over
    the seg mask (> 0) / the enhancing core (label 4), a per-sample masked
    mean averaged over the batch, weighted per sample by
    ``(p+1)·(t/(T−1))^p`` with ``p = lesion_t_power`` (i2i, the batch
    carries ``"seg"``).

    Metrics: loss, mse_wav (8,), loss_per_sample, t, the two image panels,
    grad_max and param_max (zeros without ``with_norms``), and mse_lesion
    / mse_lesion_core where those terms are on; all detached device
    tensors. Under a mesh, loss, mse_wav and the lesion terms are the
    global batch's; loss_per_sample, t and the panels are this rank's rows
    (``PER_SAMPLE_METRIC_KEYS``, which the loop gathers).
    """
    sampler = sampler or UniformSampler(diffusion.num_timesteps)
    loss_aware = isinstance(sampler, LossSecondMomentResampler)
    lesion_on = bool(lesion_weight) or bool(lesion_core_weight)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    for name, w in (("lesion_weight", lesion_weight),
                    ("lesion_core_weight", lesion_core_weight),
                    ("lesion_t_power", lesion_t_power)):
        if w < 0:
            raise ValueError(
                f"{name} must be >= 0, got {w} (a negative weight would reward lesion error)"
            )
    if lesion_on and mode != "i2i":
        raise ValueError(
            "lesion_weight/lesion_core_weight need i2i mode (the mask comes from the "
            "case's seg labels; unconditional batches are plain arrays)"
        )
    dropout_on = _has_dropout(model)
    dp = mesh is not None and mesh.world is not None
    sp = mesh.sp_axis if mesh is not None else None
    tp = mesh.tp_axis if mesh is not None else None
    comm = pmesh.CommLog()

    def model_fn(x, tt):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        # channels-last → NCDHW view (channels_last_3d memory) and back
        return model(x.permute(0, 4, 1, 2, 3), tt).float().permute(0, 2, 3, 4, 1)

    def loss_fn(batch, t, noise_img):
        terms, model_out, out_idwt = diffusion.training_losses(
            model_fn, batch, t, contr=contr, mode=mode, noise_img=noise_img)
        loss = terms["mse_wav"].mean()  # equal subband weights
        if lesion_on:
            diff2 = (out_idwt.float() - batch[contr].float()) ** 2
            dims = tuple(range(1, diff2.dim()))
            if lesion_t_power:
                tt = t.float() / max(diffusion.num_timesteps - 1, 1)
                w_t = (lesion_t_power + 1.0) * tt**lesion_t_power
            else:
                w_t = torch.ones(t.shape, dtype=torch.float32, device=t.device)

            def masked_aux(mask):
                # per-sample masked mean, t-weighted, batch-averaged;
                # empty-mask samples contribute exactly 0
                s = (diff2 * mask).sum(dims)
                c = mask.sum(dims)
                if pmesh.current_sp() is not None:  # the volume's masked mean
                    s, c = pmesh.global_sum_sp(torch.stack([s, c])).unbind(0)
                return (w_t * s / torch.clamp(c, min=1.0)).mean()

            if lesion_weight:
                aux = masked_aux((batch["seg"] > 0).float())
                loss = loss + lesion_weight * aux
                terms["mse_lesion"] = aux
            if lesion_core_weight:
                aux_c = masked_aux((batch["seg"] == 4).float())  # raw BraTS label 4
                loss = loss + lesion_core_weight * aux_c
                terms["mse_lesion_core"] = aux_c
        terms[IMAGE_METRIC_KEYS[0]] = out_idwt[:, :, :, out_idwt.shape[3] // 2, 0]
        terms[IMAGE_METRIC_KEYS[1]] = model_out[:, :, :, model_out.shape[3] // 2, :]
        return loss, {k: v.detach() for k, v in terms.items()}

    def forward_backward(state, batch, t, noise_img, bsz):
        for p in state.params.values():
            p.grad = None
        if accum_steps == 1:
            loss, terms = loss_fn(batch, t, noise_img)
            loss.backward()
            return loss.detach(), terms, None
        if bsz % accum_steps != 0:
            raise ValueError(f"batch size {bsz} not divisible by accum_steps {accum_steps}")
        n, mb = accum_steps, bsz // accum_steps
        extra = (["mse_lesion"] if lesion_weight else []) + (
            ["mse_lesion_core"] if lesion_core_weight else [])
        outs = []
        for i in range(n):
            sl = slice(i * mb, (i + 1) * mb)
            mb_batch = ({k: v[sl] for k, v in batch.items()} if isinstance(batch, dict)
                        else batch[sl])
            loss_i, terms_i = loss_fn(mb_batch, t[sl], noise_img[sl])
            loss_i.backward()  # grads accumulate in order, as the JAX scan sums them
            outs.append((loss_i.detach(), terms_i))
        terms = {
            "mse_wav": torch.stack([o[1]["mse_wav"] for o in outs]).mean(dim=0),
            "loss_per_sample": torch.cat([o[1]["loss_per_sample"] for o in outs]),
            **{k: torch.cat([o[1][k] for o in outs]) for k in IMAGE_METRIC_KEYS},
            **{k: torch.stack([o[1][k] for o in outs]).mean() for k in extra},
        }
        return torch.stack([o[0] for o in outs]).mean(), terms, n

    def step(state: TrainState, batch, rng: StepRNG | None = None, *,
             t: torch.Tensor | None = None, noise_img: torch.Tensor | None = None):
        model.train()
        target = batch[contr] if isinstance(batch, dict) else batch
        bsz, dev = target.shape[0], target.device
        # the global batch's t and noise, drawn alike on every rank; this
        # rank's rows (and Y slab) of them
        gbsz = bsz * mesh.size if dp else bsz
        lo, hi = pmesh.local_batch_rows(mesh, gbsz) if dp else (0, bsz)
        ny = target.shape[2] * (sp.size if sp else 1)
        y0, y1 = pmesh.y_slab(sp, ny)
        if t is None:
            if loss_aware:
                t, _ = sampler.sample(rng.t if rng else None, gbsz, state.sampler_state)
            else:
                t, _ = sampler.sample(rng.t if rng else None, gbsz, device=dev)
        t = t.to(dev)[lo:hi]
        if noise_img is None:
            # the full batch's noise in one draw (sliced per microbatch
            # under accumulation), so accum_steps does not change it
            noise_img = torch.randn((gbsz, target.shape[1], ny, *target.shape[3:]),
                                    generator=rng.noise if rng else None,
                                    dtype=target.dtype, device=dev)
        noise_img = noise_img[lo:hi, :, y0:y1]
        with pmesh.sp_active(sp), pmesh.tp_active(tp):
            if dropout_on:
                seed = int(torch.randint(2**62, (1,), generator=rng.dropout if rng else None))
                devices = [dev] if dev.type == "cuda" else []
                with torch.random.fork_rng(devices=devices, device_type=dev.type):
                    torch.manual_seed(seed)
                    loss, terms, accum = forward_backward(state, batch, t, noise_img, bsz)
            else:
                loss, terms, accum = forward_backward(state, batch, t, noise_img, bsz)
        for axis in (sp, tp):
            if axis is not None:
                axis.log.move_to(comm)
        grads = {}
        for k, p in state.params.items():
            gk = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = gk / accum if accum else gk
        means = [k for k in ("mse_lesion", "mse_lesion_core") if k in terms]
        if dp:
            # one all-reduce per optimizer step: the gradients, then the
            # loss and the batch-mean metrics in the same buffer
            loss = loss.reshape(1).clone()
            terms["mse_wav"] = terms["mse_wav"].clone()
            for k in means:
                terms[k] = terms[k].reshape(1).clone()
            # the tp slices first: they reduce over the replica group
            sliced = pmesh.sharded_params(model) if tp is not None else {}
            order = [k for k in grads if k in sliced] + [k for k in grads if k not in sliced]
            pmesh.all_reduce_mean_(
                mesh, [*(grads[k] for k in order), loss, terms["mse_wav"],
                       *(terms[k] for k in means)],
                comm, replicated=2 + len(means), sharded=len(sliced))
            loss = loss[0]
            for k in means:
                terms[k] = terms[k][0]
        opt.update_(state.params, grads, state.opt_state)
        state.step += 1
        update_ema(state)
        if loss_aware:
            state.sampler_state = sampler.update(
                state.sampler_state, t, terms["loss_per_sample"],
                axis_name=pmesh.DATA_AXIS if dp else None, mesh=mesh)
        metrics = {"loss": loss, "mse_wav": terms["mse_wav"],
                   "loss_per_sample": terms["loss_per_sample"], "t": t,
                   **{k: terms[k] for k in IMAGE_METRIC_KEYS}}
        for k in means:
            metrics[k] = terms[k]
        if with_norms:
            norms = pmesh.max_over_tp(mesh, torch.stack([
                _max_abs(grads.values()), _max_abs(p.detach() for p in state.params.values())]))
            metrics["grad_max"], metrics["param_max"] = norms[0], norms[1]
        else:
            metrics["grad_max"] = metrics["param_max"] = torch.zeros((), device=dev)
        for p in state.params.values():
            p.grad = None
        return state, metrics

    step.comm = comm
    return step


def make_eval_sample_fn(model: torch.nn.Module, diffusion: GaussianDiffusion, *,
                        params_source: str = "params"):
    """Build ``sample(state, cond, generator=None, *, noise=None,
    step_noise=None) -> tensor``: the full ancestral chain on the condition
    ``cond`` (B, X, Y, Z, 24), in eval mode and without autograd, for
    validation during training. ``params_source="ema"`` samples with the
    first EMA shadow (where the state has one) instead of the live
    parameters, without copying either into the model."""
    from torch.func import functional_call

    def model_fn(params, x, t):
        return functional_call(model, params, (x.permute(0, 4, 1, 2, 3), t)).permute(0, 2, 3, 4, 1)

    @torch.no_grad()
    def sample(state: TrainState, cond: torch.Tensor, generator: torch.Generator | None = None,
               *, noise=None, step_noise=None) -> torch.Tensor:
        params = (state.ema_params[0] if params_source == "ema" and state.ema_params
                  else state.params)
        was_training = model.training
        model.eval()
        try:
            shape = (cond.shape[0], *cond.shape[1:-1], diffusion.target_channels)
            return diffusion.p_sample_loop(
                lambda x, t: model_fn(params, x, t), shape, cond=cond, noise=noise,
                step_noise=step_noise, generator=generator, device=cond.device)
        finally:
            model.train(was_training)

    return sample
