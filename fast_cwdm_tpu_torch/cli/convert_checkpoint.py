"""Checkpoint conversion CLI (port of ``fast_cwdm_tpu/cli/convert_checkpoint.py``):
reference torch ``.pt`` ↔ the JAX package's ``.ckpt`` or ``.orbax``, with
the same flags, and no JAX.

    python -m fast_cwdm_tpu_torch.cli.convert_checkpoint --src W.pt \\
        --dst brats_t1n_BEST_sampled_10.ckpt [--contr t1n] [model flags]
    python -m fast_cwdm_tpu_torch.cli.convert_checkpoint --src X.ckpt --dst W.pt

The model flags default to the production preset. An imported checkpoint
carries no EMA shadows, step 0, and a sidecar of the config with
``contr`` and ``imported_from``, as the JAX package writes it; a ``--dst``
ending in ``.orbax`` is written as an Orbax directory (its sidecar beside
it), and an ``.orbax`` ``--src`` exports like a ``.ckpt``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    import torch

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.models.factory import str2bool
    from fast_cwdm_tpu_torch.training import checkpoints

    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help=".pt, .ckpt or .orbax input")
    p.add_argument("--dst", required=True, help=".ckpt, .orbax or .pt output")
    p.add_argument("--sample_schedule", default="sampled",
                   help="recorded in the .ckpt config (import direction)")
    p.add_argument("--diffusion_steps", type=int, default=10)
    p.add_argument("--contr", default="t1n")
    # model config overrides (defaults: the production preset)
    for k, v in common.PRODUCTION_OVERRIDES.items():
        p.add_argument(f"--{k}", default=v, type=str2bool if isinstance(v, bool) else type(v))
    args = p.parse_args(argv)

    cfg = {k: getattr(args, k) for k in common.PRODUCTION_OVERRIDES}
    cfg.update(sample_schedule=args.sample_schedule, diffusion_steps=args.diffusion_steps)
    model, _ = common.build_model_and_diffusion(cfg)

    jax_formats = (".ckpt", ".orbax")
    if args.src.endswith(".pt") and args.dst.endswith(jax_formats):
        common.load_params(args.src, model)  # checks the layout (strict)
        params = jax_params_from_state_dict(model.state_dict(), model)
        checkpoints.save_checkpoint(
            args.dst, {"params": params, "ema_params": (), "step": 0},
            config={**cfg, "contr": args.contr, "imported_from": args.src},
        )
        print(f"imported {args.src} → {args.dst}")
    elif args.src.endswith(jax_formats) and args.dst.endswith(".pt"):
        common.load_params(args.src, model)
        torch.save(model.state_dict(), args.dst)
        print(f"exported {args.src} → {args.dst}")
    else:
        raise SystemExit("expected .pt→.ckpt|.orbax or .ckpt|.orbax→.pt")


if __name__ == "__main__":
    main()
