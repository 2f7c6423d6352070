"""Synthesis plumbing: config → model/diffusion, weights, the wavelet
condition, and the reverse chain + postprocess as one callable.

Port of ``fast_cwdm_tpu/cli/common.py`` (ddpm sampler). Public functions
take and return the JAX package's channels-last ``(B, X, Y, Z, C)``
layout. Everything runs on ``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device
from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order
from fast_cwdm_tpu_torch.models.factory import create_model_and_diffusion
from fast_cwdm_tpu_torch.ops import wavelet as wv

PRODUCTION_OVERRIDES = dict(
    image_size=112,
    num_channels=64,
    num_res_blocks=2,
    channel_mult="1,2,2,4,4",
    attention_resolutions="",
    in_channels=32,
    out_channels=8,
    dims=3,
    num_groups=32,
    bottleneck_attention=False,
    resample_2d=False,
    use_scale_shift_norm=False,
    additive_skips=False,
    # the training objective is x0-prediction; sampling reads the model
    # output as x_start
    predict_xstart=True,
    mode="i2i",
    # bf16 compute, fp32 params and fp32 GroupNorm statistics
    dtype="bfloat16",
)


def production_config(**overrides) -> dict:
    """The production flag bundle as a config dict."""
    cfg = dict(PRODUCTION_OVERRIDES)
    cfg.update(overrides)
    return cfg


def build_model_and_diffusion(cfg: dict):
    """``(UNetModel on the CPU, diffusion)`` for a config dict."""
    return create_model_and_diffusion(**cfg)


def load_checkpoint_config(path: str) -> dict | None:
    """The config stored beside a checkpoint (``<path>.json``), if any."""
    import json

    side = path + ".json"
    if os.path.exists(side):
        with open(side) as f:
            return json.load(f)
    return None


def load_params(path: str, model: torch.nn.Module, *, use_ema: bool = False) -> torch.nn.Module:
    """Load reference-format torch ``.pt`` weights into ``model``
    (``strict=True``) and return it."""
    if not path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: the port reads reference-format .pt state_dicts only; "
            ".ckpt/.orbax checkpoints of the JAX package need the converter "
            "planned as ROADMAP item M7"
        )
    if use_ema:
        print(f"[load_params] WARNING: {path} is a torch state_dict with no "
              "EMA shadows; using the raw parameters")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


def prepare_condition(batch: dict, contr: str, wavelet: str = "haar",
                      device: str | torch.device | None = None) -> torch.Tensor:
    """3 known modalities (B, X, Y, Z, 1) → the 24-channel wavelet condition
    (B, X/2, Y/2, Z/2, 24), in the reference's concat order, LLL/3."""
    dev = resolve_device(device)
    conds = [
        torch.as_tensor(batch[m], dtype=torch.float32, device=dev)
        for m in condition_order(contr)
    ]
    return torch.cat([wv.dwt_normalized(c, wavelet) for c in conds], dim=-1)


def make_synthesis_fn(model, diffusion, *, crop_z: int = 155, chunk=None,
                      sampler: str = "ddpm", sampler_steps: int | None = None,
                      clip_denoised: bool = True,
                      device: str | torch.device | None = None):
    """Build ``run(cond, mask_vol, generator=None, *, noise=None,
    step_noise=None) -> np.ndarray``: the full reverse chain, IDWT with ×3
    LLL, clamp to [0,1], zero where ``mask_vol`` is 0, crop Z to
    ``crop_z``; returns (B, X, Y, crop_z) float32.

    ``noise``/``step_noise`` inject the initial and per-step noise (for
    parity with the JAX package's key stream); otherwise both are drawn
    from ``generator``. ``chunk`` is accepted for signature parity and has
    no effect (the chain is a Python loop of eager steps).
    """
    if sampler not in ("ddpm", "ddim", "dpm++"):
        raise ValueError(f"sampler must be ddpm, ddim or dpm++, got {sampler!r}")
    if sampler != "ddpm":
        raise NotImplementedError(f"sampler={sampler!r} is not ported yet (ddpm only)")
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def model_fn(x, t):
        # channels-last → NCDHW view (channels_last_3d memory) and back
        return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)

    @torch.inference_mode()
    def run(cond, mask_vol, generator: torch.Generator | None = None, *,
            noise=None, step_noise=None) -> np.ndarray:
        cond = torch.as_tensor(cond, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask_vol, device=dev)
        as_dev = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
            a, dtype=torch.float32, device=dev)
        shape = (cond.shape[0], *cond.shape[1:-1], diffusion.target_channels)
        sample = diffusion.p_sample_loop(
            model_fn, shape, cond=cond, noise=as_dev(noise),
            step_noise=as_dev(step_noise), generator=generator, device=dev,
            clip_denoised=clip_denoised,
        )
        img = torch.clamp(wv.idwt_normalized(sample, 1, diffusion.wavelet), 0.0, 1.0)
        img = torch.where(mask == 0, 0.0, img)
        return img[..., 0].cpu().numpy()[:, :, :, :crop_z]

    return run


def subject_id_from_path(path: str) -> str:
    """The case directory name."""
    d = os.path.dirname(path)
    return os.path.basename(d) if d else os.path.basename(path)[:19]


class AsyncWriter:
    """Small write-behind pool: NIfTI gzip encodes overlap the next case's
    sampling. The backlog is bounded (``max_pending``); ``drain()`` waits
    for the rest and returns the number of failed jobs."""

    def __init__(self, max_workers: int = 2, max_pending: int = 8, label: str = "write"):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._pending: list = []
        self._max_pending = max_pending
        self._label = label
        self._failed: list[str] = []

    def _resolve(self, tag, fut) -> None:
        try:
            fut.result()
        except Exception as e:  # noqa: BLE001 — one failed case must not stop the run
            print(f"[{self._label}] FAILED {tag}: {e}")
            self._failed.append(tag)

    def submit(self, tag: str, fn, *args, **kwargs) -> None:
        while len(self._pending) >= self._max_pending:
            self._resolve(*self._pending.pop(0))
        self._pending.append((tag, self._pool.submit(fn, *args, **kwargs)))

    def drain(self) -> int:
        for tag, fut in self._pending:
            self._resolve(tag, fut)
        self._pending.clear()
        self._pool.shutdown(wait=True)
        failed, self._failed = self._failed, []
        return len(failed)
