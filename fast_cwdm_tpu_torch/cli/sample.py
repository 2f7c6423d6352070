"""Sampling CLI (port of ``fast_cwdm_tpu/cli/sample.py``).

Per eval case: DWT the 3 known modalities → 24-channel condition, run the
reverse chain, IDWT with ×3 LLL, clamp [0,1], zero non-brain voxels via
the first condition modality, crop Z to 155, and write ``sample.nii.gz``
and ``target.nii.gz`` with an identity affine.

    python -m fast_cwdm_tpu_torch.cli.sample --data_dir DIR --model_path W.pt \\
        --contr t1c --sample_schedule sampled --diffusion_steps 10 [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import random
import time

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device
from fast_cwdm_tpu_torch.models.factory import (
    add_dict_to_argparser,
    args_to_dict,
    model_and_diffusion_defaults,
)


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        seed=0,
        data_dir="",
        data_mode="validation",
        clip_denoised=True,
        num_samples=1,
        batch_size=1,
        use_ddim=False,
        class_cond=False,
        sampling_steps=0,
        model_path="",
        output_dir="./results",
        mode="i2i",
        renormalize=False,
        half_res_crop=False,
        concat_coords=False,
        contr="",
        use_ema=False,
        sampler="",  # "" → honor --use_ddim; or ddpm | ddim | dpm++
        device="cuda",
    )
    md = model_and_diffusion_defaults()
    defaults.update({k: v for k, v in md.items() if k not in defaults})
    defaults.update(
        dims=3, num_groups=32, channel_mult="1,2,2,4,4",
        in_channels=32, out_channels=8, bottleneck_attention=False,
        # x0-prediction checkpoints: the schema default (EPSILON) would
        # mis-decode them
        predict_xstart=True,
    )
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def main(argv=None) -> list[float]:
    """Sample every case of ``--data_dir``; returns the seconds each case's
    synthesis took (condition, chain and postprocess)."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.data.brats import BRATSVolumes
    from fast_cwdm_tpu_torch.data.nifti import Nifti1Image, save
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order

    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    random.seed(args.seed)
    np.random.seed(args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    cfg = args_to_dict(args, model_and_diffusion_defaults().keys())
    # a config stored beside the checkpoint wins for model/diffusion keys;
    # dtype stays a runtime choice
    stored = common.load_checkpoint_config(args.model_path) or {}
    cfg.update({k: v for k, v in stored.items() if k in cfg and k != "dtype"})
    cfg["mode"] = "i2i"
    sampler = args.sampler or ("ddim" if args.use_ddim else "ddpm")
    if sampler == "ddim" and args.sampling_steps:
        cfg["timestep_respacing"] = f"ddim{args.sampling_steps}"
    model, diffusion = common.build_model_and_diffusion(cfg)
    common.load_params(args.model_path, model, use_ema=args.use_ema)
    synth = common.make_synthesis_fn(
        model, diffusion, sampler=sampler,
        sampler_steps=(args.sampling_steps or None) if sampler == "dpm++" else None,
        clip_denoised=args.clip_denoised, device=device,
    )

    ds = BRATSVolumes(args.data_dir, mode="eval")
    print(f"sampling {len(ds)} cases, contr={args.contr}, device={device}")
    writer = common.AsyncWriter()

    def write_pair(out_dir, sample_i, target_i):
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
        save(Nifti1Image(sample_i, np.eye(4)), os.path.join(out_dir, "sample.nii.gz"))
        save(Nifti1Image(target_i, np.eye(4)), os.path.join(out_dir, "target.nii.gz"))

    timings = []
    for idx in range(len(ds)):
        item = ds[idx]
        t0 = time.perf_counter()
        subj = common.subject_id_from_path(item["subj"])
        batch = {m: item[m][None] for m in ("t1n", "t1c", "t2w", "t2f")}
        cond = common.prepare_condition(batch, args.contr, device=device)
        mask_vol = batch[condition_order(args.contr)[0]]
        sample = synth(cond, mask_vol, generator)  # (B, 224, 224, 155)
        timings.append(time.perf_counter() - t0)
        target = batch[args.contr][..., 0][:, :, :, :155]
        out_dir = os.path.join(args.output_dir, subj)
        for i in range(sample.shape[0]):
            writer.submit(subj, write_pair, out_dir, sample[i], np.asarray(target[i]))
        print(f"{subj}: sampled in {timings[-1]:.2f}s (write pipelined)")

    failed = writer.drain()
    if failed:
        print(f"[sample] {failed} write(s) FAILED")
        raise SystemExit(1)
    return timings


if __name__ == "__main__":
    main()
