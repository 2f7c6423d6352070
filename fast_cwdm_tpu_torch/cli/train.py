"""Training CLI (port of ``fast_cwdm_tpu/cli/train.py``).

    python -m fast_cwdm_tpu_torch.cli.train --data_dir=DATA --lr=1e-5 \\
        --batch_size=1 --log_interval=100 --save_interval=50 \\
        --lr_anneal_steps=5000 --use_checkpoint=True --num_workers=12 \\
        --checkpoint_dir=CKPTS --contr=t1n <run.sh's COMMON flags> [--device cpu]

The flags and defaults are the JAX package's (``run.sh``'s TRAIN and
COMMON bundles run unchanged), plus ``--device`` (default ``cuda``; without
a GPU it raises unless ``--device cpu``). Checkpoints are the JAX package's
``.ckpt`` files, or its ``.orbax`` directories under
``FAST_CWDM_CKPT_BACKEND=orbax``, so a run resumes in either package. The
process exits 143
when SIGTERM preempted the run (a step-stamped checkpoint was written;
resume with ``--resume_checkpoint``), 0 when it ran to its end.

``--device_cache`` keeps every case in device memory after its first
epoch; ``--dataset lidc-idri`` trains unconditionally (``--mode default``)
on LIDC CT volumes.

Data parallelism: one process per GPU, started by torchrun,

    torchrun --nproc_per_node=N -m fast_cwdm_tpu_torch.cli.train --data_mesh 0 ...

``--batch_size`` is the global batch (a multiple of the data axis); each
rank decodes its rows of every batch, the gradients are averaged over the
data axis, and global rank 0 writes the checkpoints and the log files (the
other ranks log to stdout). ``--data_mesh 0`` means every rank not taken
by ``--spatial_mesh`` and ``--tensor_mesh``; another value times both
must equal the number of ranks.

``--spatial_mesh S`` splits the Y axis of every volume over S consecutive
ranks (the ``sp`` axis): each rank trains on its Y slab (224 → 224/S),
exchanging conv halos and GroupNorm sums with its sp group, and the
gradients are summed over it. With one GPU, two ranks share it under
``FAST_CWDM_DIST_BACKEND=gloo``:

    FAST_CWDM_DIST_BACKEND=gloo torchrun --standalone --nproc_per_node=2 \
        -m fast_cwdm_tpu_torch.cli.train --spatial_mesh 2 ...

``--tensor_mesh T`` (the ``tp`` axis) gives T consecutive ranks the same
rows and slab and each of them 1/T of the output channels of every
parameter the JAX package's ``param_spec`` shards (its slice of the
weights, Adam's moments and the EMA shadows); every layer gathers its
output channels over the T ranks. The checkpoints hold the full arrays.
"""

from __future__ import annotations

import argparse
import itertools
import random
import sys

import numpy as np
import torch

from fast_cwdm_tpu_torch.models.factory import (
    add_dict_to_argparser,
    args_to_dict,
    model_and_diffusion_defaults,
)


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        seed=0,
        data_dir="",
        schedule_sampler="uniform",
        lr=1e-4,
        weight_decay=0.0,
        lr_anneal_steps=0,
        batch_size=1,
        microbatch=-1,  # real gradient accumulation (dead in the reference)
        ema_rate="0.9999",
        log_interval=100,
        save_interval=5000,
        resume_checkpoint="",
        resume_step=0,
        use_fp16=False,
        fp16_scale_growth=1e-3,
        dataset="brats",
        use_tensorboard=True,
        tensorboard_path="",
        num_workers=0,
        cache_dataset=False,  # keep preprocessed volumes in host memory
        device_cache=False,
        # -1: the factory's default (ds <= 1); 0 recomputes every ResBlock
        remat_max_ds=-1,
        mode="default",
        renormalize=True,
        contr="t1n",
        lesion_weight=0.0,
        lesion_core_weight=0.0,
        lesion_t_power=0.0,
        checkpoint_dir="",
        data_mesh=0,  # 0 = every device on the data axis
        spatial_mesh=1,
        tensor_mesh=1,
        device="cuda",
    )
    md = model_and_diffusion_defaults()
    defaults.update({k: v for k, v in md.items() if k not in defaults})
    # the reference train.py's overrides of the shared schema
    defaults.update(
        dims=3,
        num_groups=32,
        channel_mult="1,2,2,4,4",
        in_channels=8,
        out_channels=8,
        bottleneck_attention=False,
        sample_schedule="direct",
        # the objective is x0-prediction; sampling needs START_X
        predict_xstart=True,
    )
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def main(argv=None):
    """Train; returns the finished ``TrainLoop`` (``.preempted``,
    ``.state``, ``.step_log``)."""
    from fast_cwdm_tpu_torch import resolve_device
    from fast_cwdm_tpu_torch.data.brats import MODALITIES, BRATSVolumes, LIDCVolumes, iterate_batches
    from fast_cwdm_tpu_torch.data.loader import (
        device_resident_batches,
        iter_items,
        shard_order_rows,
    )
    from fast_cwdm_tpu_torch.diffusion.resample import create_named_schedule_sampler
    from fast_cwdm_tpu_torch.models.factory import create_model_and_diffusion
    from fast_cwdm_tpu_torch.parallel.mesh import (
        local_batch_rows,
        make_mesh,
        setup_distributed,
        y_slab,
    )
    from fast_cwdm_tpu_torch.training.loop import TrainLoop
    from fast_cwdm_tpu_torch.utils import logger

    args = create_argparser().parse_args(argv)
    owns_group = not torch.distributed.is_initialized()
    device = setup_distributed(resolve_device(args.device))  # before the logger
    mesh = make_mesh(data=args.data_mesh or -1, sp=args.spatial_mesh, tp=args.tensor_mesh)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    if mesh.process_rank == 0:
        logger.configure()
    else:
        # the other ranks: stdout only, where file sinks would race rank 0's
        logger.configure(format_strs=["stdout"])
    logger.log("creating model and diffusion...")
    cfg = args_to_dict(args, model_and_diffusion_defaults().keys())
    if args.mode == "i2i":
        cfg["in_channels"] = 32  # 8 target + 3×8 condition subbands
    if args.remat_max_ds >= 0:
        cfg["remat_max_ds"] = args.remat_max_ds
    model, diffusion = create_model_and_diffusion(**cfg)

    lesion_on = bool(args.lesion_weight) or bool(args.lesion_core_weight)
    if lesion_on and (args.dataset == "lidc-idri" or args.mode != "i2i"):
        raise ValueError(
            "--lesion_weight/--lesion_core_weight need BraTS seg labels and i2i mode "
            f"(got dataset={args.dataset!r}, mode={args.mode!r})")
    if args.dataset == "lidc-idri":
        dataset = LIDCVolumes(args.data_dir, mode="train")
    else:
        dataset = BRATSVolumes(args.data_dir, mode="train", cache=args.cache_dataset,
                               with_seg=lesion_on)
    keys = tuple(MODALITIES) + (("seg",) if lesion_on else ())
    logger.log(f"dataset: {len(dataset)} cases from {args.data_dir}")
    epoch_counter = itertools.count()  # a new shuffle every epoch
    device_cache: dict = {}
    # every rank builds the same seeded order and decodes only its rows of
    # each global batch
    rows = None
    if mesh.size > 1:
        rows = local_batch_rows(mesh, args.batch_size)
        logger.log(f"data mesh {mesh.shape}: rank {mesh.process_rank} decodes rows "
                   f"[{rows[0]}, {rows[1]}) of each batch of {args.batch_size}")
    if mesh.sp > 1:
        logger.log(f"mesh {mesh.shape}: rank {mesh.process_rank} trains on Y slab "
                   f"{mesh.sp_rank} of {mesh.sp} of every volume")
    if mesh.tp > 1:
        logger.log(f"mesh {mesh.shape}: rank {mesh.process_rank} holds tp slice "
                   f"{mesh.tp_rank} of {mesh.tp} of the sharded parameters")

    if args.dataset == "lidc-idri":  # unconditional: batches are plain arrays
        def data():
            order = np.random.default_rng(args.seed + next(epoch_counter)).permutation(len(dataset))
            local_bs = args.batch_size
            if rows is not None:
                order, local_bs = shard_order_rows(order, args.batch_size, rows)
            buf = []
            for item in iter_items(dataset, order, args.num_workers):
                buf.append(item)
                if len(buf) == local_bs:
                    yield np.stack(buf)
                    buf = []
    elif args.device_cache:
        if rows is not None or mesh.sp > 1:
            raise ValueError(
                "--device_cache is a single-process input path; a data-parallel run feeds "
                "each rank its rows of every batch (drop the flag or run one rank)")
        def data():
            return device_resident_batches(dataset, args.batch_size, device=device, shuffle=True,
                                           seed=args.seed + next(epoch_counter), keys=keys,
                                           cache=device_cache)
    else:
        def data():
            return iterate_batches(dataset, args.batch_size, shuffle=True,
                                   seed=args.seed + next(epoch_counter),
                                   num_workers=args.num_workers, keys=keys, rows=rows)

    if mesh.sp > 1:  # each rank keeps its Y slab of every volume
        whole = data

        def data():
            def slab(v):
                y0, y1 = y_slab(mesh, v.shape[2])
                return v[:, :, y0:y1]

            for batch in whole():
                yield ({k: slab(v) for k, v in batch.items()} if isinstance(batch, dict)
                       else slab(batch))

    loop = TrainLoop(
        model=model,
        diffusion=diffusion,
        data=data,
        batch_size=args.batch_size,
        lr=args.lr,
        ema_rate=args.ema_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        resume_checkpoint=args.resume_checkpoint,
        resume_step=args.resume_step,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps,
        mode=args.mode,
        contr=args.contr,
        sample_schedule=args.sample_schedule,
        diffusion_steps=args.diffusion_steps,
        dataset=args.dataset,
        schedule_sampler=create_named_schedule_sampler(args.schedule_sampler,
                                                       diffusion.num_timesteps),
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir or None,
        config=cfg,
        microbatch=args.microbatch,
        lesion_weight=args.lesion_weight,
        lesion_core_weight=args.lesion_core_weight,
        lesion_t_power=args.lesion_t_power,
        device=device,
        mesh=mesh,
    )
    loop.run_loop()
    if owns_group and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return loop


if __name__ == "__main__":
    sys.exit(143 if main().preempted else 0)
