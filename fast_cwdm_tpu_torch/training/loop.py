"""Training loop (port of ``fast_cwdm_tpu/training/loop.py``).

Feeds batches to the train step (``training/train.py``), reads the metrics
back only on log and save steps (one copy to the host each), logs the
reference's keys (loss, per-subband MSE, norms, per-quartile loss, phase
seconds, image panels every other log window), keeps one BEST checkpoint
per modality with its optimizer blob, resumes from a checkpoint with its
optimizer state, and on SIGTERM finishes the step in flight, writes a
step-stamped checkpoint and returns with ``preempted`` set.

BEST checkpoints are written on a background thread (one in flight; the
tensors are copied to the host first), which ``run_loop`` waits for
before it returns. ``DIFFUSION_TRAINING_TEST`` (set) returns after the
first save;
``FAST_CWDM_STRICT_FINITE`` (set) raises on a non-finite logged loss.

Checkpoints hold the JAX package's trees (parameters under its names,
optax's adamw state), so a run resumes across the two packages.

Data and spatial parallelism (``mesh``, one process per GPU under
``torchrun``): the data source yields this rank's rows of each global
batch of ``batch_size`` and, under sp, its Y slab of every volume; the
step sums the gradients over sp and averages them over data. On log and
save steps the image panels are gathered over the sp group and the
per-sample metrics across the data axis (collective: every rank fetches
at the same steps); the SIGTERM flag is agreed over the world every step,
so that a signal to any subset of ranks stops every rank after the same
step; checkpoints, BEST, the ledger and the log files are written by
global rank 0 alone. Under a tp axis the model is sharded
(``parallel.mesh.shard_params``): rank 0's tp group gathers the
parameters, moments and EMA shadows for every save, so that a file
written under tp holds the full arrays, the same bytes as one process's
for the same state; a resume slices them.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device
from fast_cwdm_tpu_torch.data.loader import prefetch_to_device, to_device
from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion, condition_order
from fast_cwdm_tpu_torch.diffusion.resample import UniformSampler
from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict, state_dict_from_jax
from fast_cwdm_tpu_torch.parallel import mesh as pmesh
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training.state import TrainState
from fast_cwdm_tpu_torch.training.train import (
    IMAGE_METRIC_KEYS,
    PER_SAMPLE_METRIC_KEYS,
    StepRNG,
    make_optimizer,
    make_train_step,
)
from fast_cwdm_tpu_torch.utils import logger

SUBBAND_NAMES = ("lll", "llh", "lhl", "lhh", "hll", "hlh", "hhl", "hhh")


def _infinite(iterable_factory: Callable[[], Iterable]) -> Iterator:
    """Endless epochs of ``iterable_factory()``; raises on an empty epoch (an
    empty data dir, fewer cases than one batch, or a one-shot iterator
    passed instead of a factory)."""
    epoch = 0
    while True:
        count = 0
        for item in iterable_factory():
            count += 1
            yield item
        if count == 0:
            if epoch == 0:
                raise ValueError(
                    "data source yielded no batches in its first epoch — is the dataset "
                    "empty, or smaller than one batch (drop_last discards the ragged tail)?"
                )
            raise ValueError(
                "data source yielded no items after a non-empty epoch — pass a CALLABLE "
                "factory (a bare iterator is exhausted after its first epoch)"
            )
        epoch += 1


class TrainLoop:
    # True iff the last run_loop returned early on a trapped SIGTERM: a
    # caller must treat that as "resume me", never as completion
    preempted = False

    def __init__(
        self,
        *,
        model: torch.nn.Module,
        diffusion: GaussianDiffusion,
        data: Callable[[], Iterable] | Iterable,
        batch_size: int,
        lr: float = 1e-5,
        ema_rate: str | float = "0.9999",
        log_interval: int = 100,
        save_interval: int = 50,
        resume_checkpoint: str = "",
        resume_step: int = 0,
        weight_decay: float = 0.0,
        lr_anneal_steps: int = 0,
        mode: str = "i2i",
        contr: str = "t1n",
        sample_schedule: str = "direct",
        diffusion_steps: int = 1000,
        dataset: str = "brats",
        schedule_sampler=None,
        seed: int = 0,
        checkpoint_dir: str | None = None,
        config: dict | None = None,
        prefetch: int = 2,
        microbatch: int = -1,
        lesion_weight: float = 0.0,
        lesion_core_weight: float = 0.0,
        lesion_t_power: float = 0.0,
        device: str | torch.device | None = None,
        mesh: pmesh.DataMesh | None = None,
    ):
        self.device = resolve_device(device)
        # default: the process group's data axis (one rank without torchrun)
        self.mesh = mesh if mesh is not None else pmesh.make_mesh()
        # global rank 0 writes every file; the others compute and log to stdout
        self.writer_rank = self.mesh.process_rank == 0
        # under tp, the ranks of rank 0's tp group gather what it writes
        self.gathers = self.mesh.tp > 1 and self.mesh.rank == 0 and self.mesh.sp_rank == 0
        self.model = pmesh.shard_params(self.mesh, model.to(self.device))
        self.diffusion = diffusion
        self.data_factory = data if callable(data) else (lambda: data)
        self.batch_size = batch_size
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.lr_anneal_steps = lr_anneal_steps
        self.mode = mode
        self.contr = contr
        self.sample_schedule = sample_schedule
        self.diffusion_steps = diffusion_steps
        self.dataset = dataset
        self.resume_step = resume_step
        self.checkpoint_dir = checkpoint_dir or ckpt.get_blob_logdir()
        self.config = config or {}
        self.prefetch = prefetch
        self._ema_rates = tuple(
            float(x) for x in (str(ema_rate).split(",") if ema_rate not in ("", None) else []))
        self.opt = make_optimizer(lr, weight_decay=weight_decay, lr_anneal_steps=lr_anneal_steps)
        self.sampler = schedule_sampler or UniformSampler(diffusion.num_timesteps)
        # microbatch <= 0 or >= batch_size: no accumulation; otherwise the
        # (global) batch runs as batch_size/microbatch accumulated chunks,
        # each rank taking its rows of every chunk
        if 0 < microbatch < batch_size:
            if batch_size % microbatch != 0:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by microbatch {microbatch}")
            accum_steps = batch_size // microbatch
        else:
            accum_steps = 1
        self.step_fn = make_train_step(
            self.model, diffusion, self.opt, contr=contr, mode=mode, sampler=self.sampler,
            accum_steps=accum_steps, lesion_weight=lesion_weight,
            lesion_core_weight=lesion_core_weight, lesion_t_power=lesion_t_power,
            mesh=self.mesh,
        )
        self.rng = StepRNG.seeded(seed, self.device)
        # BEST saves write in the background; every return waits for them
        self.writer = ckpt.AsyncWriter()
        self.state: TrainState | None = None
        # one record per log step: step, loss, wall seconds per step of the
        # window (the metric fetch synchronises the device), and the
        # gradient all-reduce's milliseconds and bytes per step
        self.step_log: list[dict] = []
        self._pending_resume: str | None = None
        if resume_checkpoint:
            self._load(resume_checkpoint)

    # ------------------------------------------------------------------
    def _init_state(self, batch) -> TrainState:
        """The run's state, checked against the first batch: the model's
        input channels must be the batch's subbands (8 per modality)."""
        if self.mode == "i2i":
            n_in = 8 * (1 + len(condition_order(self.contr)))
        else:
            n_in = 8 * batch.shape[-1]
        want = getattr(self.model, "in_channels", n_in)
        if want != n_in:
            raise ValueError(
                f"the model takes {want} input channels, the batch gives {n_in} "
                f"(mode={self.mode!r})")
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.log(f"creating model: {n_params / 1e6:.2f}M params")
        init = getattr(self.sampler, "init_state", None)
        return TrainState.create(
            self.model, self.opt, ema_rates=self._ema_rates,
            sampler_state=init(self.device) if init else ())

    def _load(self, path: str) -> None:
        if not os.path.exists(path):
            logger.log(f"resume checkpoint {path} not found; fresh start")
            return
        self._pending_resume = path
        if not self.resume_step:
            self.resume_step = ckpt.parse_resume_step_from_filename(path)

    def _jax_tree(self, tensors: dict[str, torch.Tensor]) -> dict:
        """The JAX tree of the full tensors (gathered over tp)."""
        return jax_params_from_state_dict(
            pmesh.gather_params(self.mesh, self.model, tensors), self.model)

    def _to_device(self, params: dict) -> dict[str, torch.Tensor]:
        """A loaded JAX tree as this rank's tensors (its tp slices)."""
        full = state_dict_from_jax(params, self.model)
        names = dict(self.model.named_parameters())
        return {k: v.to(self.device, torch.float32) for k, v in pmesh.shard_tensors(
            self.mesh, self.model, {k: full[k] for k in names}).items()}

    @torch.no_grad()
    def _apply_resume(self) -> None:
        path = self._pending_resume
        if not path:
            return
        loaded = ckpt.load_with_ema_probe(path)
        params = self._to_device(loaded["params"])
        for k, p in self.state.params.items():
            p.copy_(params[k])
        got = tuple(loaded["ema_params"])
        live = self.state.ema_params
        if len(got) != len(live):
            logger.log(
                f"resume: checkpoint has {len(got)} EMA shadow(s), run wants {len(live)} — "
                "missing shadows start from the loaded params")
        for i, shadow in enumerate(live):
            src = self._to_device(got[i]) if i < len(got) else params
            for k, v in shadow.items():
                v.copy_(src[k])
        # the step inside the checkpoint wins over the one in its name
        if int(np.asarray(loaded.get("step", 0) or 0)) > 0:
            self.resume_step = int(np.asarray(loaded["step"]))
        # state.step counts this process's steps (the EMA warm-up's t), as
        # in the JAX package; the optimizer's count comes with its blob
        # the optimizer state: a step-stamped checkpoint's own opt blob
        # first (the run's naming, the older contr-only stem, the
        # reference's bare opt{step}), opt_best last (its moments and
        # anneal count come from the last BEST save); the newest file of a
        # stem where both formats exist
        ckpt_dir = os.path.dirname(path)
        stems = []
        if self.resume_step and "_BEST_" not in os.path.basename(path):
            stems += [
                ckpt.opt_checkpoint_name(self.contr, self.resume_step, self.sample_schedule,
                                         self.diffusion_steps, self.dataset, ext=""),
                f"opt_{self.dataset}_{self.contr}_{self.resume_step:06d}",
                f"opt{self.resume_step:06d}",
            ]
        stems.append(f"opt_best_{self.contr}")
        opt_path = stale = None
        for stem in stems:
            candidates = [p for p in (os.path.join(ckpt_dir, stem + ext)
                                      for ext in (".ckpt", ".orbax")) if os.path.exists(p)]
            if candidates:
                opt_path = max(candidates, key=os.path.getmtime)
                stale = stem.startswith("opt_best") and len(stems) > 1
                break
        if opt_path:
            if stale:
                logger.log(
                    f"WARNING: no step-{self.resume_step} opt blob next to {path}; restoring "
                    f"{os.path.basename(opt_path)} — Adam moments and the LR-anneal count "
                    "come from the last BEST save, not from the resumed step")
            tree = ckpt.load_checkpoint(opt_path)["opt_state"]
            self.state.opt_state = self.opt.state_from_tree(tree, self.model, self.device,
                                                            self.mesh)
            logger.log(f"restored the optimizer state from {opt_path}")
        else:
            logger.log(f"WARNING: no optimizer state found next to {path}; resuming with a "
                       "FRESH optimizer (Adam moments reset)")
        logger.log(f"resumed from {path} at step {self.resume_step}")
        self._pending_resume = None

    # ------------------------------------------------------------------
    def _fetch(self, metrics: dict) -> dict:
        """Metrics to the host (numpy): the image panels' Y gathered over the
        sp group, the per-sample ones across the data axis (collective)."""
        y_axis = {k: 2 for k in IMAGE_METRIC_KEYS}
        y_axis.update({k: 1 for k in metrics if k.startswith("source/")})
        return pmesh.gather_metrics(self.mesh, metrics, PER_SAMPLE_METRIC_KEYS, y_axis)

    def _preempt_agreed(self, preempted: list) -> bool:
        """Whether any rank was sent SIGTERM. Delivery is per process: a
        rank that stopped alone would leave the others waiting in the next
        all-reduce, and a signal to rank 1 only would save nothing. One
        small all-reduce a step stops every rank after the same step, and
        rank 0 saves."""
        return pmesh.any_rank(self.mesh, bool(preempted))

    def run_loop(self) -> TrainState:
        # SIGTERM (preemption): finish the step in flight, write a
        # step-stamped checkpoint and return with preempted set. The
        # handler goes in only in the main thread; the previous one comes
        # back on return.
        self.preempted = False
        preempted: list[int] = []
        prev_handler, installed = None, False
        try:
            prev_handler = signal.signal(signal.SIGTERM,
                                         lambda signum, frame: preempted.append(signum))
            # signal.signal makes SIGTERM interrupt system calls (EINTR),
            # which native code (the collectives' library) need not retry:
            # restart them instead (the handler only records the signal)
            signal.siginterrupt(signal.SIGTERM, False)
            installed = True
        except ValueError:  # not the main thread
            pass
        try:
            state = self._run_loop(preempted)
            self.writer.wait()
            # one all-reduce as a barrier: no rank returns before rank 0's
            # files are written, so a caller that reads them next (a
            # resume) finds them on every rank
            pmesh.any_rank(self.mesh, False)
            return state
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)

    def _run_loop(self, preempted: list) -> TrainState:
        data_iter = _infinite(self.data_factory)
        if self.prefetch > 0:
            data_iter = prefetch_to_device(data_iter, size=self.prefetch, device=self.device)
            put = lambda b: b  # noqa: E731 — already on the device
        else:
            put = lambda b: to_device(b, self.device)  # noqa: E731
        try:
            return self._steps(data_iter, put, preempted)
        finally:
            # stop the loader and prefetch threads before returning, so none
            # is still running when the process exits
            data_iter.close()

    def _steps(self, data_iter, put, preempted: list) -> TrainState:
        t_data = t_step = t_log = t_save = 0.0
        last_metrics = None
        step = self.resume_step
        window_t0, window_step = time.perf_counter(), step

        while not self.lr_anneal_steps or step < self.lr_anneal_steps:
            t0 = time.time()
            batch = put(next(data_iter))
            if self.state is None:
                self.state = self._init_state(batch)
                self._apply_resume()
                step = self.resume_step
                window_t0, window_step = time.perf_counter(), step
            t1 = time.time()
            t_data += t1 - t0
            self.state, metrics = self.step_fn(self.state, batch, self.rng)
            last_metrics = metrics
            t2 = time.time()
            t_step += t2 - t1
            step += 1

            # one fetch per step even when log and save coincide; the image
            # panels only on image-log steps (every other log window)
            m = None
            image_step = step % (2 * self.log_interval) == 0
            if step % self.log_interval == 0 or step % self.save_interval == 0:
                want = {k: v for k, v in metrics.items()
                        if image_step or k not in IMAGE_METRIC_KEYS}
                if image_step and self.mode == "i2i" and isinstance(batch, dict):
                    for mod in sorted(batch):
                        if mod != self.contr and batch[mod].dim() == 5:
                            want[f"source/{mod}"] = batch[mod][0, :, :, batch[mod].shape[3] // 2, 0]
                m = self._fetch(want)

            if step % self.log_interval == 0:
                loss = float(m["loss"])
                now = time.perf_counter()
                n_win = step - window_step
                rec = {"step": step, "loss": loss, "seconds_per_step": (now - window_t0) / n_win}
                # the gradient all-reduce and the sp collectives, by kind
                for kind, (n_bytes, ms, _) in self.step_fn.comm.drain_by_kind().items():
                    rec[f"{kind}_ms_per_step"] = ms / n_win
                    rec[f"{kind}_bytes_per_step"] = n_bytes / n_win
                    logger.logkv(f"time/{kind}_ms", rec[f"{kind}_ms_per_step"])
                    logger.logkv(f"comm/{kind}_bytes", rec[f"{kind}_bytes_per_step"])
                self.step_log.append(rec)
                window_t0, window_step = now, step
                if not np.isfinite(loss):
                    logger.log(f"Encountered non-finite loss {loss}")
                    if os.environ.get("FAST_CWDM_STRICT_FINITE"):
                        raise FloatingPointError(f"non-finite loss {loss} at step {step}")
                logger.logkv("step", step)
                logger.logkv("loss", loss)
                logger.logkv("loss/MSE", loss)
                logger.logkv("time/load", round(t_data, 4))
                logger.logkv("time/forward", round(t_step, 4))
                logger.logkv("time/total", round(t_data + t_step, 4))
                logger.logkv("norm/grad_max", float(m["grad_max"]))
                logger.logkv("norm/param_max", float(m["param_max"]))
                for i, name in enumerate(SUBBAND_NAMES):
                    logger.logkv(f"loss/mse_wav_{name}", float(m["mse_wav"][i]))
                for k in ("mse_lesion", "mse_lesion_core"):
                    if k in m:
                        logger.logkv(f"loss/{k}", float(m[k]))
                T = self.diffusion.num_timesteps
                for ls, ti in zip(np.atleast_1d(m["loss_per_sample"]), np.atleast_1d(m["t"])):
                    logger.logkv_mean(f"loss_q{int(4 * int(ti) / T)}", float(ls))
                logger.dumpkvs()
                if image_step:
                    imgs = {"sample/x_0": logger.visualize(m["sample_slice"][0])}
                    for i, name in enumerate(SUBBAND_NAMES):
                        imgs[f"sample/{name.upper()}"] = logger.visualize(
                            m["subband_slices"][0, :, :, i])
                    for k in sorted(m):
                        if k.startswith("source/"):
                            imgs[k] = logger.visualize(m[k])
                    logger.log_images(imgs, step)
                t3 = time.time()
                t_log += t3 - t2
                total = t_data + t_step + t_log + t_save
                print(f"[PROFILE] Step {step}: Data={t_data:.2f}s Step={t_step:.2f}s "
                      f"Log={t_log:.2f}s Save={t_save:.2f}s Total={total:.2f}s")
                t_data = t_step = t_log = t_save = 0.0

            if step % self.save_interval == 0:
                t3 = time.time()
                self.save_if_best(float(m["loss"]), step)
                t_save += time.time() - t3
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    logger.log("DIFFUSION_TRAINING_TEST: early exit")
                    return self.state

            if self._preempt_agreed(preempted):
                logger.log(f"SIGTERM at step {step}: writing preemption checkpoint and exiting")
                self.preempted = True
                self.save(step)
                return self.state

        # the last annealed steps are often the best weights of the run:
        # offer them to save_if_best when the end is not a save step
        if (self.lr_anneal_steps and step and step % self.save_interval != 0
                and last_metrics is not None):
            self.save_if_best(float(last_metrics["loss"]), step)
        return self.state

    # ------------------------------------------------------------------
    def _payload(self, step: int) -> dict:
        return {"params": self._jax_tree(self.state.params),
                "ema_params": tuple(self._jax_tree(e) for e in self.state.ema_params),
                "step": step}

    def _opt_payload(self) -> dict:
        return {"opt_state": self.opt.state_to_tree(self.state.opt_state, self.model,
                                                    self.mesh)}

    def save_if_best(self, loss: float, step: int) -> bool:
        if not (self.writer_rank or self.gathers):
            return False  # the parameters are the same on every rank
        # under tp, the writer's tp group gathers the payloads together
        payload, opt_payload = self._payload(step), self._opt_payload()
        if not self.writer_rank:
            return False
        saved = ckpt.save_if_best(
            self.checkpoint_dir, self.contr, loss, payload, opt_payload,
            sample_schedule=self.sample_schedule, diffusion_steps=self.diffusion_steps,
            dataset=self.dataset,
            config={**self.config, "sample_schedule": self.sample_schedule,
                    "diffusion_steps": self.diffusion_steps, "contr": self.contr,
                    "step": step, "loss": loss},
            writer=self.writer,
        )
        if saved:
            logger.log(f"saved new best for {self.contr} at step {step} (loss {loss:.6f})")
        return saved

    def save(self, step: int, prune_previous: bool = True) -> None:
        """Step-stamped checkpoint and its optimizer blob (the preemption
        save); ``prune_previous`` then deletes this run's older ones.
        Rank 0 writes; under tp, its tp group gathers with it."""
        if not (self.writer_rank or self.gathers):
            return
        payload, opt_payload = self._payload(step), self._opt_payload()
        if not self.writer_rank:
            return
        names = (self.contr, step, self.sample_schedule, self.diffusion_steps, self.dataset)
        self.writer.wait()
        ckpt.save_checkpoint(os.path.join(self.checkpoint_dir, ckpt.step_checkpoint_name(*names)),
                             payload, config=self.config)
        ckpt.save_checkpoint(os.path.join(self.checkpoint_dir, ckpt.opt_checkpoint_name(*names)),
                             opt_payload)
        if prune_previous:
            ckpt.prune_step_checkpoints(self.checkpoint_dir, *names)
