"""Dataset-completion CLI (port of ``fast_cwdm_tpu/cli/complete_dataset.py``,
the BraSyn production pipeline).

Per case directory: find the one missing modality by filename, load and
preprocess the three present ones, find the ``BEST`` checkpoint of the
missing modality in ``--checkpoint_dir`` (a ``.ckpt`` of the JAX package or
of the port; its config rides in the sidecar), synthesize it, un-crop it
to the source geometry (240×240×155) with the source affine and header, and
copy the present files through. A case that fails is counted and the run
goes on.

    python -m fast_cwdm_tpu_torch.cli.complete_dataset --input_dir IN \\
        --output_dir OUT --checkpoint_dir CKPTS [--sampler dpm++ \\
        --sampling_steps 10] [--shard i/N] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given. Each case draws its noise
from its own ``torch.Generator``, seeded from ``--seed`` and the crc32 of
the case name, so a case's volume depends neither on the shard nor on the
order of the cases, as in the JAX package (whose key per case is
``fold_in(PRNGKey(seed), crc32(case))``). The draws themselves differ from
JAX's: the same distribution, other samples.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device
from fast_cwdm_tpu_torch.data.brats import MODALITIES


def find_missing_modality(case_dir: str) -> str | None:
    """The one modality without a ``-{m}.`` file in ``case_dir``; None when
    none or several are missing."""
    present = set()
    for f in os.listdir(case_dir):
        for m in MODALITIES:
            if f"-{m}." in f:
                present.add(m)
    missing = [m for m in MODALITIES if m not in present]
    return missing[0] if len(missing) == 1 else None


def case_seed(seed: int, case: str) -> int:
    """The generator seed of one case: ``seed`` and the case name's crc32."""
    return (seed * 2**31 + (zlib.crc32(case.encode()) & 0x7FFFFFFF)) % 2**63


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--dataset", default="brats")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument(
        "--shard", default="",
        help="'i/N': process every N-th case starting at i (0-based); one "
        "invocation per card, shards disjoint by construction",
    )
    p.add_argument(
        "--dtype", default="", choices=["", "float32", "bfloat16"],
        help="compute dtype override: bfloat16 (production default) or "
        "float32; a runtime choice, never read from the checkpoint",
    )
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "dpm++"])
    p.add_argument(
        "--sampling_steps", type=int, default=0,
        help="model evaluations: dpm++ solver steps (default "
        "min(50, diffusion steps)) or ddimN respacing; ignored for ddpm",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Complete every case of ``--input_dir``; returns ``{"seconds": {case:
    s}, "failed": [case, ...]}``, the seconds of each synthesis (condition,
    chain and postprocess) and the failed cases."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.data.brats import load_preprocessed, unprocess_volume
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order

    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    synth_cache: dict[str, object] = {}

    def get_synth(contr: str):
        if contr not in synth_cache:
            # base_cfg None: the production preset; the checkpoint's stored
            # config wins for model/diffusion keys
            synth_cache[contr] = common.load_best_synthesis(
                args.checkpoint_dir, contr, dataset=args.dataset, dtype=args.dtype,
                use_ema=args.use_ema, tag="complete", sampler=args.sampler,
                sampler_steps=args.sampling_steps or None, device=device,
            )
        return synth_cache[contr]

    pathlib.Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    case_dirs = sorted(
        d for d in (os.path.join(args.input_dir, n) for n in os.listdir(args.input_dir))
        if os.path.isdir(d)
    )
    if args.shard:
        try:
            i, n = (int(x) for x in args.shard.split("/"))
        except ValueError:
            i, n = -1, 0  # malformed → rejected below
        if not 0 <= i < n:
            raise SystemExit(f"--shard must be 'i/N' with 0 <= i < N, got {args.shard!r}")
        total = len(case_dirs)
        case_dirs = case_dirs[i::n]
        print(f"[complete] shard {i}/{n}: {len(case_dirs)} of {total} cases")
    print(f"[complete] {len(case_dirs)} cases, device={device}")
    # a case fails once, whether its synthesis, its write or its copy fails
    failed_cases: set[str] = set()
    seconds: dict[str, float] = {}

    def load_case(case_dir: str):
        """Host work of one case, on a prefetch thread: NIfTI decode overlaps
        the previous case's sampling."""
        missing = find_missing_modality(case_dir)
        avail: dict[str, np.ndarray] = {}
        src_img = None
        if missing is not None:
            for f in sorted(os.listdir(case_dir)):
                for m in MODALITIES:
                    if f"-{m}." in f and m != missing:
                        path = os.path.join(case_dir, f)
                        avail[m] = load_preprocessed(path)[None]
                        if src_img is None:
                            src_img = nifti.load_header(path)
        return missing, avail, src_img

    def copy_through(case_dir, out_case):
        """The present files, copied before synthesis, so that a failed case
        still leaves a complete pass-through directory."""
        pathlib.Path(out_case).mkdir(parents=True, exist_ok=True)
        for f in os.listdir(case_dir):
            shutil.copy2(os.path.join(case_dir, f), os.path.join(out_case, f))

    def write_case(case, out_case, missing, sample_np, src_img):
        if args.threshold > 0:
            sample_np[sample_np <= args.threshold] = 0.0
        full = unprocess_volume(sample_np[..., None], raw_shape=src_img.shape)
        pathlib.Path(out_case).mkdir(parents=True, exist_ok=True)
        nifti.save(nifti.Nifti1Image(full.astype(np.float32), src_img.affine, src_img.header),
                   os.path.join(out_case, f"{case}-{missing}.nii.gz"))

    # two cases in flight on the loader; writes and copies behind, in pools
    # of their own so their failures are counted apart
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {d: pool.submit(load_case, d) for d in case_dirs[:2]}
    writer = common.AsyncWriter(label="write")
    copier = common.AsyncWriter(label="copy")
    for idx, case_dir in enumerate(case_dirs):
        case = os.path.basename(case_dir)
        if idx + 2 < len(case_dirs):
            nxt = case_dirs[idx + 2]
            futures[nxt] = pool.submit(load_case, nxt)
        out_case = os.path.join(args.output_dir, case)
        copier.submit(case, copy_through, case_dir, out_case)
        try:
            missing, avail, src_img = futures.pop(case_dir).result()
            if missing is None:
                continue
            synth = get_synth(missing)
            t0 = time.perf_counter()
            cond = common.prepare_condition(avail, missing, device=device)
            mask_vol = avail[condition_order(missing)[0]]
            gen = torch.Generator(device=device).manual_seed(case_seed(args.seed, case))
            sample_np = synth(cond, mask_vol, gen)[0]
            seconds[case] = time.perf_counter() - t0
            writer.submit(case, write_case, case, out_case, missing, sample_np, src_img)
            print(f"[complete] {case}: {missing} sampled in {seconds[case]:.2f}s "
                  "(write pipelined)")
        except Exception as e:  # noqa: BLE001 — one bad case must not stop the run
            print(f"[complete] FAILED {case}: {type(e).__name__}: {e}")
            failed_cases.add(case)

    failed_cases.update(writer.drain_failed())
    failed_cases.update(copier.drain_failed())
    pool.shutdown(wait=True)
    print(f"[complete] done: {len(case_dirs) - len(failed_cases)} ok, "
          f"{len(failed_cases)} failed")
    return {"seconds": seconds, "failed": sorted(failed_cases)}


if __name__ == "__main__":
    main()
