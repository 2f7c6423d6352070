"""Synthesis-quality benchmark on the phantom dataset (port of
``scripts/quality_bench.py``).

Generate procedural multi-modality phantoms (``data/phantom.py``: the 3→1
completion task is well-posed by construction), train the production
config on them (``run.sh``'s budget: 5000 steps, lr 1e-5, remat, batch 1),
then score held-out 3→1 completions with ``ssim3d``/``psnr`` (float64 on
the card) across samplers and step counts: the (quality, s/volume)
frontier.

Stages (resumable: each is skipped when its artifact exists):
  gen   → {workdir}/train, {workdir}/val phantom trees (seeds 0.., 10000..)
  train → {workdir}/ckpt_{schedule}_{steps}/ BEST checkpoint per schedule,
          each leg in a child process of ``fast_cwdm_tpu_torch.cli.train``
  eval  → {workdir}/quality.json + a markdown table on stdout

On the card:        python -m fast_cwdm_tpu_torch.scripts.quality_bench --workdir W
CPU harness smoke:  python -m fast_cwdm_tpu_torch.scripts.quality_bench --quick --device cpu --workdir W

``--device`` defaults to ``cuda`` in every mode, ``--quick`` included:
without a GPU the run raises unless ``--device cpu`` is given.
``--quick`` shrinks every knob; its numbers are not quality evidence.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROD_Z = 155
_T0 = time.monotonic()


def _wall_remaining(a) -> float:
    """Seconds left in the --max_wall_hours budget (inf when unset)."""
    if not a.max_wall_hours:
        return float("inf")
    return a.max_wall_hours * 3600.0 - (time.monotonic() - _T0)


def parse_args(argv=None):
    from fast_cwdm_tpu_torch.cli.common import str2bool

    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--contr", default="t1c")
    ap.add_argument("--train_cases", type=int, default=24)
    ap.add_argument("--val_cases", type=int, default=4)
    ap.add_argument("--train_steps", type=int, default=5000)
    ap.add_argument(
        "--schedules", default="direct:1000,sampled:10",
        help="comma list of sample_schedule:diffusion_steps models to train",
    )
    ap.add_argument(
        "--samplers",
        default="ddpm:full,ddpm:100,ddim:100,dpm++:50,dpm++:25,dpm++:10",
        help="comma list sampler:steps evaluated on the direct model "
        "('full' = the model's whole chain); the sampled:N model is always "
        "evaluated with its native N-step chain",
    )
    ap.add_argument(
        "--rim_texture", type=float, default=0.0,
        help="stochastic t1c lesion-rim texture amplitude (normalized "
        "units; see data/phantom.py). >0 gives the completion task a "
        "genuine posterior spread so the sampler frontier can bend; "
        "use a FRESH --workdir; the texture-fidelity column only means "
        "anything on a dataset generated with the same value",
    )
    ap.add_argument("--stages", default="gen,train,eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--save_interval", type=int, default=500)
    ap.add_argument(
        "--quick", action="store_true",
        help="tiny model + tiny phantoms: "
        "validates the harness end to end in minutes (numbers are NOT "
        "quality evidence)",
    )
    ap.add_argument("--write_md", default="",
                    help="also append the results table to this markdown file")
    ap.add_argument(
        "--ema_rows", type=str2bool, default=True,
        help="add one EMA-weights row per model on its headline leg",
    )
    ap.add_argument(
        "--max_wall_hours", type=float, default=0.0,
        help="wall-clock budget for THIS invocation; when a training leg "
        "would outlive it, the leg is SIGTERM'd (checkpoint-and-exit) and "
        "the harness exits 143 so the operator relaunches to resume",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    return ap.parse_args(argv)


def model_flags(a) -> list[str]:
    if a.quick:
        return [
            "--num_channels=16", "--num_res_blocks=1", "--channel_mult=1,2",
            "--attention_resolutions=", "--num_groups=8",
            "--bottleneck_attention=False", "--image_size=8",
            "--in_channels=32", "--out_channels=8", "--dims=3",
            "--resample_2d=False", "--mode=i2i", "--predict_xstart=True",
            "--dtype=float32",
        ]
    return [
        "--dims=3", "--num_groups=32", "--num_channels=64",
        "--num_res_blocks=2", "--channel_mult=1,2,2,4,4",
        "--attention_resolutions=", "--bottleneck_attention=False",
        "--image_size=112", "--in_channels=32", "--out_channels=8",
        "--resample_2d=False", "--use_scale_shift_norm=False",
        "--additive_skips=False", "--noise_schedule=linear",
        "--predict_xstart=True", "--mode=i2i", "--dataset=brats",
        "--dtype=bfloat16", "--use_checkpoint=True",
    ]


def phantom_shape(a):
    return (40, 40, 26) if a.quick else (240, 240, 155)


def stage_gen(a) -> tuple[str, str]:
    from fast_cwdm_tpu_torch.data.phantom import write_phantom_dataset

    train_dir = os.path.join(a.workdir, "train")
    val_dir = os.path.join(a.workdir, "val")
    shape = phantom_shape(a)
    for d, n, seed0 in (
        (train_dir, a.train_cases, 0),
        (val_dir, a.val_cases, 10_000),
    ):
        done = os.path.join(d, ".complete")
        if os.path.exists(done):
            print(f"[gen] {d} exists, skipping")
            continue
        t0 = time.perf_counter()
        write_phantom_dataset(
            d, n, start_seed=seed0, shape=shape,
            rim_texture=a.rim_texture,
        )
        open(done, "w").close()
        print(f"[gen] {d}: {n} cases in {time.perf_counter() - t0:.1f}s")
    return train_dir, val_dir


def ckpt_dir_for(a, schedule: str, steps: int) -> str:
    return os.path.join(a.workdir, f"ckpt_{schedule}_{steps}")


def _resume_candidate(a, cdir: str, schedule: str, steps: int) -> str:
    """Newest restartable checkpoint in ``cdir``: a step-stamped preemption
    save (params + paired opt blob) beats BEST (params only; its opt blob
    may be stale)."""
    import glob

    from fast_cwdm_tpu_torch.training import checkpoints as ckpt

    stamped = sorted(
        p
        for p in glob.glob(
            os.path.join(cdir, f"brats_{a.contr}_*_{schedule}_{steps}.ckpt")
        )
        if ckpt.parse_resume_step_from_filename(p) > 0
    )
    if stamped:
        return max(stamped, key=os.path.getmtime)
    found = ckpt.find_best_checkpoint(cdir, a.contr)
    return found[0] if found else ""


def _run_train_leg(a, argv: list[str]) -> str:
    """Run ONE training leg; "completed", "preempted" or "failed(rc=N)".

    Each leg is a child process of ``python -m
    fast_cwdm_tpu_torch.cli.train`` (exit 0 at its end, 143 on SIGTERM
    preemption), so one model's device memory (cached dataset, optimizer
    state, graph pools) is released before the next leg starts. With
    ``--max_wall_hours`` a leg that outlives the remaining budget gets
    SIGTERM: the loop writes a step-stamped checkpoint and exits 143.
    ``--quick`` trains in-process (a tiny model, no memory to release).
    """
    if a.quick:
        from fast_cwdm_tpu_torch.cli import train as train_cli

        return "preempted" if train_cli.main(argv).preempted else "completed"
    cmd = [sys.executable, "-m", "fast_cwdm_tpu_torch.cli.train"] + argv
    proc = subprocess.Popen(cmd, env=dict(os.environ), cwd=REPO)
    budget = _wall_remaining(a)
    try:
        rc = proc.wait(timeout=budget if budget != float("inf") else None)
    except subprocess.TimeoutExpired:
        print("[train] wall budget exhausted; SIGTERM → checkpoint+exit")
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        return "preempted"
    if rc == 0:
        return "completed"
    if rc == 143:
        return "preempted"
    return f"failed(rc={rc})"


def stage_train(a, train_dir: str) -> None:
    for spec in a.schedules.split(","):
        schedule, steps_s = spec.split(":")
        steps = int(steps_s)
        cdir = ckpt_dir_for(a, schedule, steps)
        done = os.path.join(cdir, ".done")
        if os.path.exists(done):
            print(f"[train] {spec}: complete (marker), skipping")
            continue
        # a BEST checkpoint alone does NOT mean the run finished (BEST is
        # written every save_interval): resume instead of skipping
        resume = _resume_candidate(a, cdir, schedule, steps)
        argv = model_flags(a) + [
            f"--data_dir={train_dir}",
            f"--checkpoint_dir={cdir}",
            f"--contr={a.contr}",
            f"--sample_schedule={schedule}",
            f"--diffusion_steps={steps}",
            f"--lr={a.lr}",
            f"--batch_size={a.batch_size}",
            f"--lr_anneal_steps={a.train_steps}",
            f"--save_interval={a.save_interval}",
            "--log_interval=100",
            "--num_workers=4",
            # decode each case once and keep it in device memory: no host
            # copy per step (24 production cases take ~3.1 GB)
            "--device_cache=True",
            # recompute every ResBlock so the cached dataset and the
            # activations fit together
            "--remat_max_ds=0",
            f"--seed={a.seed}",
            f"--device={a.device}",
        ]
        if resume:
            argv.append(f"--resume_checkpoint={resume}")
            print(f"[train] {spec}: resuming from {resume}")
        print(f"[train] {spec}: {a.train_steps} steps → {cdir}")
        t0 = time.perf_counter()
        status = _run_train_leg(a, argv)
        if status != "completed":
            # SIGTERM preemption: a checkpoint was written but the budget
            # was NOT reached; a .done here would make the next invocation
            # skip a half-trained model
            print(f"[train] {spec}: {status}; exiting for resume")
            sys.exit(143)
        open(done, "w").close()
        print(f"[train] {spec} done in {time.perf_counter() - t0:.0f}s")


def _leg(label, sampler, respacing, dpm_steps, use_ema=False) -> dict:
    """Every leg carries an explicit ``use_ema`` field."""
    return {
        "label": label, "sampler": sampler, "respacing": respacing,
        "dpm_steps": dpm_steps, "use_ema": use_ema,
    }


def _sampler_legs(a) -> list[dict]:
    legs = []
    for spec in a.samplers.split(","):
        sampler, steps_s = spec.split(":")
        if sampler == "ddpm":
            resp = "" if steps_s == "full" else steps_s
            legs.append(_leg(f"ddpm-{steps_s}", "ddpm", resp, None))
        elif sampler == "ddim":
            legs.append(_leg(f"ddim-{steps_s}", "ddim", f"ddim{steps_s}", None))
        elif sampler == "dpm++":
            legs.append(_leg(f"dpm++-{steps_s}", "dpm++", "", int(steps_s)))
        else:
            raise ValueError(f"unknown sampler {sampler!r}")
    return legs


def quality_json_path(a) -> str:
    return os.path.join(a.workdir, "quality.json")


def load_rows(a) -> list[dict]:
    path = quality_json_path(a)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f).get("rows", [])
    return []


def dump_rows(a, rows: list[dict]) -> None:
    """Write quality.json atomically after EVERY row, so a killed eval
    loses at most one sampler leg."""
    path = quality_json_path(a)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(
            {
                "contr": a.contr,
                "train_cases": a.train_cases,
                "val_cases": a.val_cases,
                "train_steps": a.train_steps,
                "quick": a.quick,
                "rows": rows,
            },
            f, indent=2,
        )
    os.replace(tmp, path)


def texture_ratio(sample, gt, seg):
    """Lesion high-pass energy ratio std(HP(sample))/std(HP(gt)) over
    seg>0 (host numpy): the sampler-discrimination metric for rim-textured
    phantoms. Whole-volume SSIM rewards over-smoothing of genuinely
    stochastic content, so texture fidelity is measured apart. ~1.0 = the
    synthesis carries the right texture energy; <1 = over-smoothed."""
    if seg is None or not (seg > 0).any():
        return None
    from scipy.ndimage import uniform_filter

    m = seg > 0
    hp_s = sample - uniform_filter(sample, size=3)
    hp_g = gt - uniform_filter(gt, size=3)
    denom = float(hp_g[m].std())
    return float(hp_s[m].std()) / denom if denom > 0 else None


def stage_eval(a, val_dir: str) -> list[dict]:
    import numpy as np
    import torch

    from fast_cwdm_tpu_torch import resolve_device
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.cli.evaluate_synthesis import psnr, ssim3d
    from fast_cwdm_tpu_torch.data.brats import BRATSVolumes, load_seg
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order
    from fast_cwdm_tpu_torch.models.factory import model_and_diffusion_defaults
    from fast_cwdm_tpu_torch.training import checkpoints as ckpt

    dev = resolve_device(a.device)
    crop_z = min(PROD_Z, phantom_shape(a)[2])
    rows: list[dict] = load_rows(a)
    done_keys = {(r["model"], r["leg"]) for r in rows}
    if rows:
        print(f"[eval] resuming: {len(rows)} rows already in quality.json")
    ds = BRATSVolumes(val_dir, mode="eval")
    cases = []
    for i in range(len(ds)):
        item = ds[i]
        batch = {
            m: np.asarray(item[m])[None] for m in ("t1n", "t1c", "t2w", "t2f")
        }
        mask = batch[condition_order(a.contr)[0]]
        gt = batch[a.contr][0, ..., 0][:, :, :crop_z]
        seg = None
        seg_path = item.get("filedict", {}).get("seg")
        if seg_path:
            seg = load_seg(seg_path)[..., 0][:, :, :crop_z]
        cases.append((mask, gt, batch, seg))
    print(f"[eval] {len(cases)} held-out cases, target {a.contr}, device={dev}")
    on_dev = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)  # noqa: E731

    # context rows: how well does trivially COPYING an input score?
    for m in condition_order(a.contr):
        if ("-", f"copy-{m}") in done_keys:
            continue
        ssims, psnrs, tex = [], [], []
        for _, gt, batch, seg in cases:
            copy = batch[m][0, ..., 0][:, :, :crop_z]
            c, g = on_dev(copy), on_dev(gt)
            ssims.append(ssim3d(c, g))
            psnrs.append(psnr(c, g))
            tex.append(texture_ratio(copy, gt, seg))
        tex = [v for v in tex if v is not None]
        rows.append({
            "model": "-", "leg": f"copy-{m}", "evals": 0,
            "ssim_mean": float(np.mean(ssims)),
            "ssim_min": float(np.min(ssims)),
            "psnr_mean": float(np.mean(psnrs)),
            "texture_ratio": float(np.mean(tex)) if tex else None,
            "s_per_volume": None,
        })
        dump_rows(a, rows)

    # parse the model flags through the train CLI's own parser, so the eval
    # model config can never drift from the trained one
    from fast_cwdm_tpu_torch.cli.train import create_argparser

    a_args = create_argparser().parse_args(
        model_flags(a) + ["--data_dir=unused"]
    )

    schedules = [tuple(s.split(":")) for s in a.schedules.split(",")]
    for schedule, steps_s in schedules:
        steps = int(steps_s)
        cdir = ckpt_dir_for(a, schedule, steps)
        found = ckpt.find_best_checkpoint(cdir, a.contr)
        if not found:
            print(f"[eval] no checkpoint for {schedule}:{steps}, skipping")
            continue
        path = found[0]
        legs = (
            _sampler_legs(a)
            if schedule == "direct"
            else [_leg(f"{schedule}-{steps}", "ddpm", "", None)]
        )
        # one EMA-weights row per model on its headline leg (direct →
        # ddpm-100 if requested, else the first leg; sampled → its native
        # chain): does the EMA the trainer keeps help at this budget?
        if a.ema_rows:
            head = next(
                (l for l in legs if l["label"] == "ddpm-100"), legs[0]
            )
            legs = legs + [dict(head, label=head["label"] + "+ema",
                                use_ema=True)]
        for leg in legs:
            label, sampler = leg["label"], leg["sampler"]
            respacing, dpm_steps = leg["respacing"], leg["dpm_steps"]
            use_ema = leg["use_ema"]
            if (f"{schedule}-{steps}", label) in done_keys:
                print(f"[eval] {schedule}-{steps}/{label}: done, skipping")
                continue
            cfg = {
                k: v
                for k, v in vars(a_args).items()
                if k in model_and_diffusion_defaults()
            }
            cfg.update(
                mode="i2i", sample_schedule=schedule, diffusion_steps=steps,
                timestep_respacing=respacing,
            )
            model, diffusion = common.build_model_and_diffusion(cfg)
            model, ema_applied = common.load_params_ex(
                path, model, use_ema=use_ema
            )
            if use_ema and not ema_applied:
                # raw weights under an '+ema' label would read as "EMA makes
                # no difference": skip with a visible note
                print(f"[eval] {schedule}-{steps}/{label}: checkpoint has "
                      "no EMA shadows — row skipped")
                continue
            synth = common.make_synthesis_fn(
                model, diffusion, crop_z=crop_z,
                sampler=sampler, sampler_steps=dpm_steps, device=dev,
            )
            evals = dpm_steps if dpm_steps else diffusion.num_timesteps
            ssims, psnrs, walls, texs = [], [], [], []
            for idx, (mask, gt, batch, seg) in enumerate(cases):
                gen = torch.Generator(device=dev).manual_seed(
                    (a.seed + 1) * 1_000_003 + idx)
                cond = common.prepare_condition(batch, a.contr, device=dev)
                t0 = time.perf_counter()
                # the image comes back to the host: the clock stops after
                # the card has finished
                sample = synth(cond, mask, gen)[0]
                wall = time.perf_counter() - t0
                s, g = on_dev(sample), on_dev(gt)
                ssims.append(ssim3d(s, g))
                psnrs.append(psnr(s, g))
                tr = texture_ratio(sample, gt, seg)
                if tr is not None:
                    texs.append(tr)
                if idx > 0:  # case 0 pays the graph capture
                    walls.append(wall)
            row = {
                "model": f"{schedule}-{steps}",
                "leg": label,
                "evals": evals,
                "ssim_mean": float(np.mean(ssims)),
                "ssim_min": float(np.min(ssims)),
                "psnr_mean": float(np.mean(psnrs)),
                "texture_ratio": float(np.mean(texs)) if texs else None,
                "s_per_volume": (
                    round(float(np.min(walls)), 3) if walls else None
                ),
            }
            rows.append(row)
            dump_rows(a, rows)
            print("[eval]", json.dumps(row))
            del synth, model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def render_md(a, rows: list[dict]) -> str:
    with_tex = any(r.get("texture_ratio") is not None for r in rows)
    hdr = "| model | sampler | evals | SSIM (mean) | SSIM (min) | PSNR |"
    hdr += " texture |" if with_tex else ""
    hdr += " s/vol |"
    lines = [hdr, "|---|" + "---|" * (hdr.count("|") - 2)]
    for r in rows:
        tex = r.get("texture_ratio")
        line = (
            f"| {r['model']} | {r['leg']} | {r['evals']} "
            f"| {r['ssim_mean']:.4f} | {r['ssim_min']:.4f} "
            f"| {r['psnr_mean']:.2f} "
        )
        if with_tex:
            line += f"| {tex:.3f} " if tex is not None else "| — "
        line += (
            f"| {r['s_per_volume'] if r['s_per_volume'] is not None else '—'} |"
        )
        lines.append(line)
    return "\n".join(lines)


def apply_quick(a) -> None:
    """Shrink every knob to CPU-smoke scale (numbers are NOT evidence)."""
    a.train_cases = min(a.train_cases, 3)
    a.val_cases = min(a.val_cases, 2)
    a.train_steps = min(a.train_steps, 60)
    a.save_interval = min(a.save_interval, 30)
    a.lr = max(a.lr, 1e-4)
    if a.schedules == "direct:1000,sampled:10":
        # the linear schedule needs T ≳ 50 (betas scale with 1000/T and
        # must stay ≤ 1)
        a.schedules = "direct:100,sampled:4"
    if a.samplers.startswith("ddpm:full,ddpm:100"):
        a.samplers = "ddpm:full,ddpm:10,ddim:10,dpm++:5"


def main(argv=None) -> list[dict] | None:
    """Run the stages; returns the eval rows (None without an eval stage)."""
    from fast_cwdm_tpu_torch import resolve_device

    a = parse_args(argv)
    resolve_device(a.device)  # no GPU and no --device cpu: raise before any work
    os.makedirs(a.workdir, exist_ok=True)
    stages = a.stages.split(",")
    if a.quick:
        apply_quick(a)
    train_dir, val_dir = stage_gen(a)
    if "train" in stages:
        stage_train(a, train_dir)
    if "eval" not in stages:
        return None
    rows = stage_eval(a, val_dir)
    dump_rows(a, rows)
    md = render_md(a, rows)
    print(md)
    print(f"[quality] wrote {quality_json_path(a)}")
    if a.write_md:
        with open(a.write_md, "a") as f:
            f.write("\n" + md + "\n")
    return rows


if __name__ == "__main__":
    main()
