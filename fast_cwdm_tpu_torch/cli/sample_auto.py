"""Auto-completion CLI (port of ``fast_cwdm_tpu/cli/sample_auto.py``): per
case of ``--data_dir``, read the missing modality from the loader, find the
``BEST`` checkpoint of that modality once (the synthesis is cached per
modality), synthesize it, zero what is at or below ``--threshold`` (0.04),
un-crop to the source geometry and write
``{output_dir}/{subj}/{subj}-{missing}.nii.gz``.

    python -m fast_cwdm_tpu_torch.cli.sample_auto --data_dir IN \\
        --checkpoint_dir CKPTS --output_dir OUT [--device cpu]

Runs on CUDA unless ``--device cpu`` is given. The cases draw their noise
from one ``torch.Generator`` seeded with ``--seed``, in case order, as the
JAX package splits one key: the same distribution, other draws.
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
        checkpoint_dir="checkpoints",
        clip_denoised=True,
        batch_size=1,
        output_dir="./results_auto",
        mode="i2i",
        threshold=0.04,
        use_ema=False,
        dataset="brats",
        sampler="ddpm",  # ddpm | ddim | dpm++
        sampling_steps=0,  # dpm++ evaluations or ddimN respacing; 0: default
        device="cuda",
    )
    md = model_and_diffusion_defaults()
    defaults.update({k: v for k, v in md.items() if k not in defaults})
    defaults.update(
        dims=3, num_groups=32, channel_mult="1,2,2,4,4",
        in_channels=32, out_channels=8, bottleneck_attention=False,
    )
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def main(argv=None) -> dict:
    """Synthesize the missing modality of every incomplete case; returns
    ``{"seconds": [...], "done": n, "skipped": n, "failed": n}`` (seconds of
    each synthesis: condition, chain and postprocess)."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.data.brats import MODALITIES, BRATSVolumes, unprocess_volume
    from fast_cwdm_tpu_torch.data.loader import ThreadedLoader
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order

    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    random.seed(args.seed)
    np.random.seed(args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    synth_cache: dict[str, object] = {}

    def get_synth(contr: str):
        if contr not in synth_cache:
            # base: the CLI flags; the checkpoint's stored config wins for
            # model/diffusion keys, an explicit --dtype for dtype
            synth_cache[contr] = common.load_best_synthesis(
                args.checkpoint_dir, contr, dataset=args.dataset,
                base_cfg=args_to_dict(args, model_and_diffusion_defaults().keys()),
                dtype=args.dtype, use_ema=args.use_ema, tag="auto",
                clip_denoised=args.clip_denoised, sampler=args.sampler,
                sampler_steps=args.sampling_steps or None, device=device,
            )
        return synth_cache[contr]

    def write_sample(sample, src, out_dir, out_name):
        src_img = nifti.load_header(src)  # the geometry only
        full = unprocess_volume(sample[..., None], raw_shape=src_img.shape)
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
        nifti.save(nifti.Nifti1Image(full.astype(np.float32), src_img.affine, src_img.header),
                   out_name)

    ds = BRATSVolumes(args.data_dir, mode="auto")
    print(f"[auto] {len(ds)} cases, device={device}")
    done = skipped = 0
    seconds = []
    writer = common.AsyncWriter()
    for item in ThreadedLoader(ds, num_workers=2):
        missing = item["missing"]
        if missing == "none":
            skipped += 1
            continue
        subj = common.subject_id_from_path(item["subj"])
        batch = {m: item[m][None] for m in MODALITIES if item[m].ndim == 4}
        synth = get_synth(missing)
        t0 = time.perf_counter()
        cond = common.prepare_condition(batch, missing, device=device)
        mask_vol = batch[condition_order(missing)[0]]
        sample = synth(cond, mask_vol, generator)[0]  # (224, 224, 155)
        seconds.append(time.perf_counter() - t0)
        sample[sample <= args.threshold] = 0.0

        src = item["filedict"][condition_order(missing)[0]]
        out_dir = os.path.join(args.output_dir, subj)
        out_name = os.path.join(out_dir, f"{subj}-{missing}.nii.gz")
        writer.submit(subj, write_sample, sample, src, out_dir, out_name)
        print(f"[auto] {subj}: synthesized {missing} in {seconds[-1]:.2f}s → {out_name}")
        done += 1

    failed = writer.drain()
    print(f"[auto] completed {done - failed} cases ({skipped} already complete, {failed} failed)")
    return {"seconds": seconds, "done": done, "skipped": skipped, "failed": failed}


if __name__ == "__main__":
    main()
