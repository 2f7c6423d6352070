"""Probe: can the ARCHITECTURE learn the sharp inverse at all, or does the
diffusion OBJECTIVE dilute it? (port of ``scripts/probe_regression.py``,
the follow-up to QUALITY.md's "binding constraint".)

Two readings of the round-5 finding (the diffusion-trained denoiser never
synthesizes the core-localized enhancement the downstream segmenter keys
on) remain:

  (a) OBJECTIVE: x0-MSE at every t dilutes the cond→core gradient (most of
      the core is visible in x_t, so the denoiser learns to copy, not to
      infer), and the architecture could fit the inverse if asked directly;
  (b) ARCHITECTURE/BUDGET: the 64-channel UNet at 5,000 steps cannot reach
      the sharp nonlinear inverse at the core's scale whatever the
      objective.

The probe trains the IDENTICAL production UNet (same config and parameter
count; the x_t input slot fed zeros, t = 0) as a PURE REGRESSOR cond → x0
wavelet coefficients (the deterministic limit of x0-prediction), then runs
the downstream chain (``scripts/downstream_bench.py`` stages:
prepare_nnunet → segment → per-label Dice and region means) on its val
completions.

  Regression Dice in the control band (≥ ~0.67) → reading (a);
  regression Dice floored with a flat core       → reading (b).

Stages (``--stages``, default ``train,eval``):
  train    → {workdir}/regression.ckpt (the JAX package's ``.ckpt``
             format, ``{"params", "step"}`` + a config sidecar; AdamW with
             the linear anneal over ``--train_steps``; the dataset pinned on
             the device in bf16); ``.train_done`` marks it complete;
             SIGTERM checkpoints and exits 143; ``--resume`` (or an
             existing checkpoint) continues from its step;
  eval     → {workdir}/completed_regression (the val tree with ``--contr``
             replaced by the regression's prediction, raw geometry), then
             the downstream chain on the real and the completed trees, the
             report written to ``--out``.

    python -m fast_cwdm_tpu_torch.scripts.probe_regression --workdir W \\
        --data_dir TRAIN --val_dir VAL --out PROBE_regression_torch.json
    python -m fast_cwdm_tpu_torch.scripts.probe_regression --quick --device cpu --workdir /tmp/prq

``--quick``: a tiny model and tiny phantoms, generated when the trees are
absent; its numbers are not evidence. ``--device`` defaults to ``cuda`` in
every mode, ``--quick`` included: without a GPU the run raises unless
``--device cpu`` is given. The default ``--out`` is a file of the port's
own, never a committed JAX record.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import time
from types import SimpleNamespace

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--data_dir", default="",
                    help="train tree (generated when --quick and absent)")
    ap.add_argument("--val_dir", default="",
                    help="val tree (generated when --quick and absent)")
    ap.add_argument("--contr", default="t1c")
    ap.add_argument("--train_steps", type=int, default=5000)
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="regression default 1e-4: the probe asks CAN the "
                    "architecture fit f, so the optimizer gets favorable "
                    "settings; --lr 1e-5 reproduces the production value")
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--lesion_weight", type=float, default=0.0)
    ap.add_argument("--lesion_core_weight", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_interval", type=int, default=100)
    ap.add_argument("--save_interval", type=int, default=1000)
    ap.add_argument("--resume", default="",
                    help="checkpoint written by a previous (preempted) run")
    ap.add_argument("--out", default="PROBE_regression_torch.json")
    ap.add_argument("--quick", action="store_true",
                    help="tiny model + tiny phantoms: validates the harness "
                    "end-to-end; numbers are NOT evidence")
    ap.add_argument("--stages", default="train,eval")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    return ap.parse_args(argv)


def model_config(a) -> dict:
    from fast_cwdm_tpu_torch.cli.common import production_config

    if a.quick:
        return dict(
            num_channels=16, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="", num_groups=8,
            bottleneck_attention=False, image_size=8, in_channels=32,
            out_channels=8, dims=3, resample_2d=False, mode="i2i",
            predict_xstart=True, dtype="float32",
            sample_schedule="direct", diffusion_steps=1000,
        )
    # the production model, production memory discipline (full remat so
    # the pinned dataset fits the card's memory — cli/train --remat_max_ds=0)
    return production_config(
        sample_schedule="direct", diffusion_steps=1000,
        use_checkpoint=True, remat_max_ds=0,
    )


def build_model(cfg: dict, device, seed: int = 0):
    """The model of ``cfg`` in its own initialisation from ``seed`` (the
    global generator forked), on ``device``."""
    import torch

    from fast_cwdm_tpu_torch.cli.common import build_model_and_diffusion

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _ = build_model_and_diffusion(cfg)
    return model.to(device)


def compute_dtype_of(cfg: dict):
    import torch

    return torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32


def _find(case_dir: str, tag: str) -> str | None:
    for f in sorted(os.listdir(case_dir)):
        if f"-{tag}." in f and not f.startswith("."):
            return os.path.join(case_dir, f)
    return None


def _load_tree(root: str, with_seg: bool, device):
    """Stack every case's 4 preprocessed modalities (+seg) and pin them on
    the device: imgs ``(N,X,Y,Z,4)`` in bfloat16 (half of float32's bytes;
    the quantization RMS is orders below the measured loss floor), segs
    ``(N,X,Y,Z)`` uint8: loaded once, no host-to-device copy a step."""
    import torch

    from fast_cwdm_tpu_torch.data.brats import MODALITIES, load_preprocessed, load_seg

    cases = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    imgs, segs = [], []
    for c in cases:
        cdir = os.path.join(root, c)
        vols = [load_preprocessed(_find(cdir, m))[..., 0] for m in MODALITIES]
        imgs.append(np.stack(vols, axis=-1))
        if with_seg:
            segs.append(load_seg(_find(cdir, "seg"))[..., 0])
    imgs = torch.from_numpy(np.stack(imgs)).to(device, torch.bfloat16)
    segs = (torch.from_numpy(np.stack(segs)).to(device) if with_seg
            else torch.zeros((len(cases),) + tuple(imgs.shape[1:4]), dtype=torch.uint8,
                             device=device))
    print(f"[regression] {len(cases)} cases from {root}: imgs {tuple(imgs.shape)}")
    return cases, imgs, segs


def _apply(model, x, compute_dtype):
    """The UNet on channels-last ``x`` at t = 0, output float32
    channels-last."""
    import torch

    t0 = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    out = model(x.to(compute_dtype).permute(0, 4, 1, 2, 3), t0)
    return out.float().permute(0, 2, 3, 4, 1)


def loss_fn(model, vols, seg, *, contr: str, compute_dtype,
            lesion_weight: float = 0.0, lesion_core_weight: float = 0.0):
    """The regression loss of a batch ``vols`` (B, X, Y, Z, 4) in
    ``MODALITIES`` order and ``seg`` (B, X, Y, Z): the wavelet MSE of the
    prediction (the x_t slot fed zeros, t = 0) against the target's
    normalised DWT, plus ``lesion_weight`` × the image-space MSE inside the
    lesion (seg > 0) and ``lesion_core_weight`` × the MSE inside the core
    (seg == 4), each a per-sample masked mean averaged over the batch.
    Returns ``(loss, terms)``."""
    import torch

    from fast_cwdm_tpu_torch.data.brats import MODALITIES
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    ti = MODALITIES.index(contr)
    target = vols[..., ti: ti + 1].float()
    cond = torch.cat([wv.dwt_normalized(vols[..., c: c + 1].float())
                      for c in (MODALITIES.index(m) for m in condition_order(contr))], dim=-1)
    x0_wav = wv.dwt_normalized(target)
    # the x_t slot of the production input layout, fed zeros: the
    # deterministic limit of x0-prediction (identical architecture and
    # parameter count to every diffusion run this probe is compared to)
    x = torch.cat([torch.zeros_like(x0_wav), cond], dim=-1)
    out = _apply(model, x, compute_dtype)
    sq = (x0_wav - out) ** 2
    mse_wav = sq.mean(dim=tuple(range(1, sq.dim() - 1))).mean(dim=0)
    loss = mse_wav.mean()
    terms = {"mse_wav_mean": mse_wav.mean().detach()}
    if lesion_weight or lesion_core_weight:
        out_img = wv.idwt_normalized(out, 1)
        diff2 = (out_img - target) ** 2
        axes = tuple(range(1, diff2.dim()))

        def masked_aux(mask):
            s = (diff2 * mask).sum(axes)
            c = mask.sum(axes)
            return (s / torch.clamp(c, min=1.0)).mean()

        if lesion_weight:
            aux = masked_aux((seg > 0).float()[..., None])
            loss = loss + lesion_weight * aux
            terms["mse_lesion"] = aux.detach()
        if lesion_core_weight:
            aux_c = masked_aux((seg == 4).float()[..., None])
            loss = loss + lesion_core_weight * aux_c
            terms["mse_lesion_core"] = aux_c.detach()
    return loss, terms


def predict(model, cond, compute_dtype):
    """The regression's completion of ``cond`` (B, X/2, Y/2, Z/2, 24): the
    UNet with zeros in the x_t slot at t = 0, the normalised IDWT (K2 on the
    card), clamped to [0, 1] → (B, X, Y, Z, 1)."""
    import torch

    from fast_cwdm_tpu_torch.ops import wavelet as wv

    zeros = torch.zeros(cond.shape[:-1] + (model.out_channels,), dtype=cond.dtype,
                        device=cond.device)
    outw = _apply(model, torch.cat([zeros, cond], dim=-1), compute_dtype)
    return torch.clamp(wv.idwt_normalized(outw, 1), 0.0, 1.0)


def _payload(model, step: int) -> dict:
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict

    return {"params": jax_params_from_state_dict(model.state_dict(), model),
            "step": np.asarray(step, np.int32)}


def _load_weights(model, path: str) -> int:
    """Load ``{"params", "step"}`` from ``path`` into ``model``; its step."""
    from fast_cwdm_tpu_torch.models.convert import state_dict_from_jax
    from fast_cwdm_tpu_torch.training import checkpoints as ckpt

    blob = ckpt.load_checkpoint(path)
    model.load_state_dict(state_dict_from_jax(blob["params"], model), strict=True)
    return int(np.asarray(blob["step"]))


def stage_train(a, cfg: dict, model) -> str:
    ckpt_path = os.path.join(a.workdir, "regression.ckpt")
    done = os.path.join(a.workdir, ".train_done")
    if os.path.exists(done):
        print("[regression] train: complete (marker), skipping")
        return ckpt_path

    import torch

    from fast_cwdm_tpu_torch.training import checkpoints as ckpt
    from fast_cwdm_tpu_torch.training.state import TrainState
    from fast_cwdm_tpu_torch.training.train import make_optimizer

    dev = next(model.parameters()).device
    lesion_on = bool(a.lesion_weight) or bool(a.lesion_core_weight)
    _, imgs, segs = _load_tree(a.data_dir, lesion_on, dev)
    n_cases = imgs.shape[0]
    compute_dtype = compute_dtype_of(cfg)
    opt = make_optimizer(a.lr, weight_decay=a.weight_decay, lr_anneal_steps=a.train_steps)
    start_step = 0
    resume = a.resume or (ckpt_path if os.path.exists(ckpt_path) else "")
    if resume:
        start_step = _load_weights(model, resume)
        print(f"[regression] resumed {resume} at step {start_step}")
    state = TrainState.create(model, opt)  # fresh optimizer state, as the JAX probe
    state.step = start_step
    # case draws and dropout seeds from one generator per (seed, start step)
    gen = torch.Generator().manual_seed(a.seed * 1_000_003 + start_step)
    kw = dict(contr=a.contr, compute_dtype=compute_dtype, lesion_weight=a.lesion_weight,
              lesion_core_weight=a.lesion_core_weight)

    def step():
        idx = torch.randint(0, n_cases, (a.batch_size,), generator=gen).to(dev)
        seed = int(torch.randint(2**62, (1,), generator=gen))
        model.train()
        for p in state.params.values():
            p.grad = None
        devices = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices, device_type=dev.type):
            torch.manual_seed(seed)  # dropout, where the config has any
            loss, terms = loss_fn(model, imgs[idx], segs[idx], **kw)
            loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in state.params.items()}
        opt.update_(state.params, grads, state.opt_state)
        state.step += 1
        terms["loss"] = loss.detach()
        return terms

    stop = {"sig": 0}

    def _onterm(signum, frame):
        stop["sig"] = signum

    prev = signal.signal(signal.SIGTERM, _onterm)
    # no EINTR in the threads' system calls while the flag is awaited
    signal.siginterrupt(signal.SIGTERM, False)
    try:
        t0 = time.perf_counter()
        terms = {}
        for i in range(start_step, a.train_steps):
            terms = step()
            if (i + 1) % a.log_interval == 0 or i == start_step:
                vals = {k: float(v) for k, v in terms.items()}
                dt = (time.perf_counter() - t0) / max(i + 1 - start_step, 1)
                print(f"[regression] step {i + 1}/{a.train_steps} "
                      + " ".join(f"{k}={v:.3e}" for k, v in vals.items())
                      + f" ({dt:.2f}s/step)", flush=True)
            if (i + 1) % a.save_interval == 0 or stop["sig"]:
                ckpt.save_checkpoint(ckpt_path, _payload(model, state.step), config=dict(cfg))
                if stop["sig"]:
                    print(f"[regression] SIGTERM at step {i + 1}; checkpointed")
                    sys.exit(143)
    finally:
        signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)
    ckpt.save_checkpoint(ckpt_path, _payload(model, state.step), config=dict(cfg))
    final = {k: float(v) for k, v in terms.items()}
    with open(os.path.join(a.workdir, "train_final.json"), "w") as f:
        json.dump({"steps": a.train_steps, "final": final}, f, indent=2)
    open(done, "w").close()
    print(f"[regression] train done: {final}")
    return ckpt_path


def stage_complete(a, cfg: dict, model, ckpt_path: str) -> str:
    """Write the regression completions as a completed-val tree in raw
    geometry (as ``downstream_bench.stage_control``'s writer)."""
    out = os.path.join(a.workdir, "completed_regression")
    done = os.path.join(out, ".complete")
    if os.path.exists(done):
        return out

    import torch

    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.data.brats import load_preprocessed, unprocess_volume
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    dev = next(model.parameters()).device
    _load_weights(model, ckpt_path)
    model.eval()
    compute_dtype = compute_dtype_of(cfg)
    for case in sorted(os.listdir(a.val_dir)):
        src = os.path.join(a.val_dir, case)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(out, case)
        os.makedirs(dst, exist_ok=True)
        with torch.inference_mode():
            cond = torch.cat([wv.dwt_normalized(torch.from_numpy(
                load_preprocessed(_find(src, m))[None]).to(dev))
                for m in condition_order(a.contr)], dim=-1)
            img = predict(model, cond, compute_dtype)[0].cpu().numpy()
        for f in os.listdir(src):
            if f.startswith("."):
                continue
            sp = os.path.join(src, f)
            if f"-{a.contr}." in f:
                hdr = nifti.load_header(sp)
                full = unprocess_volume(img, raw_shape=hdr.shape)
                nifti.save(nifti.Nifti1Image(full.astype(np.float32), hdr.affine, hdr.header),
                           os.path.join(dst, f))
            else:
                shutil.copy2(sp, os.path.join(dst, f))
        print(f"[regression] completed {case}")
    open(done, "w").close()
    return out


def stage_eval(a, completed: str) -> dict:
    from fast_cwdm_tpu_torch.cli.evaluate_synthesis import calculate_dice_scores
    from fast_cwdm_tpu_torch.scripts import downstream_bench as ds

    ns = SimpleNamespace(workdir=a.workdir, val_dir=a.val_dir, contr=a.contr)
    report = {"label": "regression", "legs": {}}
    preds = {}
    for tag, tree in (("real", a.val_dir), ("regression", completed)):
        images, labels = ds.stage_nnunet(ns, tree, tag)
        preds[tag] = ds.stage_segment(ns, images, tag)
        scores = calculate_dice_scores(preds[tag], labels)
        if tag != "real":
            scores["region_means"] = ds.region_means(ns, tree)
        report["legs"][tag] = scores
        print(f"[regression] {tag}: dice_mean={scores['dice_mean']} "
              f"per_label={scores['dice_per_label_mean']} (n={scores['n']})")
    report["agreement"] = ds.agreement(ns, preds["real"], preds["regression"])
    report["gt_region_means"] = ds.region_means(ns, a.val_dir)["mean"]
    tf = os.path.join(a.workdir, "train_final.json")
    if os.path.exists(tf):
        with open(tf) as f:
            report["train"] = json.load(f)
    report["config"] = {
        "train_steps": a.train_steps, "lr": a.lr,
        "batch_size": a.batch_size, "lesion_weight": a.lesion_weight,
        "lesion_core_weight": a.lesion_core_weight, "seed": a.seed,
    }
    return report


def main(argv=None) -> dict | None:
    a = parse_args(argv)
    os.makedirs(a.workdir, exist_ok=True)
    if a.quick:
        from fast_cwdm_tpu_torch.data.phantom import write_phantom_dataset

        a.data_dir = a.data_dir or os.path.join(a.workdir, "train")
        a.val_dir = a.val_dir or os.path.join(a.workdir, "val")
        for d, n, seed0 in ((a.data_dir, 3, 0), (a.val_dir, 2, 10_000)):
            if not os.path.isdir(d):
                write_phantom_dataset(d, n, start_seed=seed0, shape=(40, 40, 26))
        a.train_steps = min(a.train_steps, 30)
        a.save_interval = min(a.save_interval, 20)
        a.log_interval = 10
    if not (a.data_dir and a.val_dir):
        raise SystemExit("--data_dir and --val_dir are required")

    from fast_cwdm_tpu_torch import resolve_device

    dev = resolve_device(a.device)
    cfg = model_config(a)
    model = build_model(cfg, dev)

    stages = a.stages.split(",")
    ckpt_path = os.path.join(a.workdir, "regression.ckpt")
    if "train" in stages:
        ckpt_path = stage_train(a, cfg, model)
    if "eval" not in stages:
        return None
    completed = stage_complete(a, cfg, model, ckpt_path)
    report = stage_eval(a, completed)
    with open(a.out, "w") as f:
        json.dump(report, f, indent=2)
    real = report["legs"]["real"]["dice_mean"]
    reg = report["legs"]["regression"]["dice_mean"]
    print(f"| regression probe | real-input {real:.4f} | regression {reg:.4f} | "
          f"Δ {real - reg:+.4f} |")
    print(f"[regression] wrote {a.out}")
    return report


if __name__ == "__main__":
    main()
